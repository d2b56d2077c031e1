"""Controller manager: watch-driven reconcile loops.

Reference: pkg/controllers/{manager.go,types.go}. Every controller exposes
``kind()`` (what it watches) and ``reconcile(name, namespace) ->
requeue_after_seconds | None``. The manager runs one watch pump per
controller plus a worker pool draining a dedup-ing queue, with
requeue-after timers — the controller-runtime workqueue model.
"""

from __future__ import annotations

import heapq
import logging
import queue
import threading
import time
from typing import List, Optional, Protocol, Set, Tuple

from karpenter_tpu_torch.runtime.kubecore import KubeCore

log = logging.getLogger("karpenter.manager")


class Controller(Protocol):
    # None = no primary watch: the controller is time-driven and MUST
    # provide seeds() (see below) or it will never reconcile.
    def kind(self) -> Optional[str]: ...

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]: ...

    # Optional: extra watches — [(kind, map_fn(obj) -> [(name, namespace)])]
    # mirroring controller-runtime's Watches(EnqueueRequestsFromMapFunc)
    # (e.g. node/controller.go:125-149 maps Pod and Provisioner events onto
    # node reconciles).
    # def mappings(self) -> List[Tuple[str, Callable]]: ...

    # Optional: initial keys enqueued once at start — the controller-runtime
    # "source.Func that fires at startup" pattern. A time-driven controller
    # (e.g. the capacity GC sweep) seeds one synthetic key and keeps itself
    # alive by returning a requeue interval from reconcile().
    # def seeds(self) -> List[Tuple[str, str]]: ...

    # Optional: stop_all(timeout) — stop the controller's own threads
    # (provisioning workers, the eviction queue); called by Manager.stop.


class _WorkQueue:
    """Deduplicating work queue with delayed re-adds and in-processing
    tracking (client-go workqueue semantics: a key being processed is never
    handed to a second worker; re-adds during processing mark it dirty and
    it requeues when done())."""

    def __init__(self):
        self._lock = threading.Condition()
        self._pending: List[Tuple[str, str]] = []
        self._in_set: Set[Tuple[str, str]] = set()
        self._processing: Set[Tuple[str, str]] = set()
        self._dirty: Set[Tuple[str, str]] = set()
        self._delayed: List[Tuple[float, Tuple[str, str]]] = []
        self._shutdown = False

    def add(self, item: Tuple[str, str]) -> None:
        with self._lock:
            if item in self._processing:
                self._dirty.add(item)
                return
            if item not in self._in_set:
                self._pending.append(item)
                self._in_set.add(item)
                self._lock.notify()

    def add_after(self, item: Tuple[str, str], delay: float) -> None:
        with self._lock:
            heapq.heappush(self._delayed, (time.monotonic() + delay, item))
            self._lock.notify()

    def get(self, timeout: float = 0.2) -> Optional[Tuple[str, str]]:
        with self._lock:
            self._drain_delayed()
            deadline = time.monotonic() + timeout
            while not self._pending and not self._shutdown:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._lock.wait(timeout=min(remaining, self._next_delay()))
                self._drain_delayed()
            if self._shutdown and not self._pending:
                return None
            item = self._pending.pop(0)
            self._in_set.discard(item)
            self._processing.add(item)
            return item

    def done(self, item: Tuple[str, str]) -> None:
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._dirty.discard(item)
                if item not in self._in_set:
                    self._pending.append(item)
                    self._in_set.add(item)
                    self._lock.notify()

    def _next_delay(self) -> float:
        if not self._delayed:
            return 0.2
        return max(0.0, min(0.2, self._delayed[0][0] - time.monotonic()))

    def _drain_delayed(self) -> None:
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, item = heapq.heappop(self._delayed)
            if item in self._processing:
                self._dirty.add(item)
            elif item not in self._in_set:
                self._pending.append(item)
                self._in_set.add(item)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()


class Manager:
    """manager.go:NewManagerOrDie equivalent. Single-writer across replicas
    is the leader elector's job (runtime/leaderelection.py), run by main.py
    before :meth:`start`."""

    def __init__(self, kube: KubeCore):
        self.kube = kube
        self._controllers: List[Tuple[Controller, int]] = []
        self._threads: List[threading.Thread] = []
        self._queues: List[_WorkQueue] = []
        self._watches: List[object] = []
        self._stop = threading.Event()

    def register(self, controller: Controller, workers: int = 1) -> None:
        self._controllers.append((controller, workers))

    def controllers(self) -> List[Controller]:
        return [c for c, _ in self._controllers]

    def _thread(self, target, name: str) -> None:
        t = threading.Thread(target=target, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    def start(self) -> None:
        for controller, workers in self._controllers:
            wq = _WorkQueue()
            self._queues.append(wq)
            # initial synthetic keys (time-driven controllers; see Controller)
            for item in getattr(controller, "seeds", lambda: [])():
                wq.add(item)
            watch_q = None
            if controller.kind() is not None:
                # the primary pump only enqueues (name, namespace) keys, so it
                # subscribes meta-only: no per-event deep copy (kubecore.MetaObj)
                watch_q = self.kube.watch(controller.kind(), meta_only=True)
                self._watches.append(watch_q)

            def pump(watch_q=watch_q, wq=wq):
                while not self._stop.is_set():
                    try:
                        event = watch_q.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    meta = event.obj.metadata
                    wq.add((meta.name, meta.namespace))

            cname = controller.kind() or type(controller).__name__
            # secondary watches: map foreign-kind events onto reconcile keys
            for kind, map_fn in getattr(controller, "mappings", lambda: [])():
                mapped_q = self.kube.watch(kind)
                self._watches.append(mapped_q)
                self._thread(lambda mapped_q=mapped_q, wq=wq, map_fn=map_fn:
                             self._mapped_pump(mapped_q, wq, map_fn),
                             f"map-{kind}-{cname}")

            def work(controller=controller, wq=wq):
                while not self._stop.is_set():
                    item = wq.get(timeout=0.2)
                    if item is None:
                        continue
                    name, namespace = item
                    try:
                        requeue = controller.reconcile(name, namespace)
                    except Exception:
                        log.exception("reconcile %s %s/%s failed",
                                      controller.kind(), namespace, name)
                        wq.add_after(item, 1.0)
                        continue
                    finally:
                        wq.done(item)
                    if requeue is not None:
                        wq.add_after(item, requeue)

            if watch_q is not None:
                self._thread(pump, f"pump-{cname}")
            for i in range(workers):
                self._thread(work, f"work-{cname}-{i}")

    def _mapped_pump(self, mapped_q, wq: _WorkQueue, map_fn) -> None:
        """Map foreign-kind events onto reconcile keys. A mapping can fail
        transiently (map functions do live reads); dropping the event would
        lose the mapped reconcile until some unrelated later event, so a
        failed event is retried with capped exponential backoff."""
        retries: List[Tuple[float, int, object, int]] = []
        seq = 0
        max_attempts = 10  # ~30 s of capped backoff, then drop
        while not self._stop.is_set():
            now = time.monotonic()
            while retries and retries[0][0] <= now:
                _, _, ev, attempt = heapq.heappop(retries)
                try:
                    for item in map_fn(ev.obj):
                        wq.add(item)
                except Exception:
                    if attempt >= max_attempts:
                        # a poisoned event (a deterministic map failure):
                        # drop it; level-triggered reconciles recover on
                        # the next event
                        log.exception("watch mapping failed %d times; dropping event",
                                      attempt)
                        continue
                    delay = min(5.0, 0.1 * (2 ** attempt))
                    log.warning("watch mapping retry %d failed; next in %.1fs",
                                attempt, delay, exc_info=True)
                    seq += 1
                    heapq.heappush(retries, (now + delay, seq, ev, attempt + 1))
            timeout = 0.2
            if retries:
                timeout = max(0.01, min(0.2, retries[0][0] - time.monotonic()))
            try:
                event = mapped_q.get(timeout=timeout)
            except queue.Empty:
                continue
            try:
                for item in map_fn(event.obj):
                    wq.add(item)
            except Exception:
                log.exception("watch mapping failed; retrying with backoff")
                seq += 1
                heapq.heappush(retries, (time.monotonic() + 0.1, seq, event, 1))

    def stop(self, timeout: float = 10.0) -> None:
        """Stop every pump and worker, and each controller's own threads
        (``stop_all``), waiting up to ``timeout`` seconds for each thread to
        end; the watches are unsubscribed."""
        self._stop.set()
        for wq in self._queues:
            wq.shutdown()
        for controller, _ in self._controllers:
            stop = getattr(controller, "stop_all", None)
            if stop:
                stop(timeout)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout)
        for q in self._watches:
            self.kube.unwatch(q)
        self._watches.clear()

    def healthz(self) -> bool:
        return all(t.is_alive() for t in self._threads) if self._threads else True

    def threads(self) -> List[threading.Thread]:
        """The pumps and workers started by :meth:`start`."""
        return list(self._threads)
