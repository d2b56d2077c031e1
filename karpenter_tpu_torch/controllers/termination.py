"""Termination controller: finalizer-driven graceful node teardown.

Reference: pkg/controllers/termination/ (designs/termination.md), and the
JAX package's ``controllers/termination.py``. A deleted node with the
karpenter termination finalizer → cordon → drain (respect do-not-evict;
skip unschedulable-tolerating, stuck-terminating and static pods; evict
non-critical before system-critical) → CloudProvider.Delete → strip the
finalizer, and the API server removes the Node.

The EvictionQueue is a single background worker with exponential backoff
(100 ms → 10 s) and a dedupe set (eviction.go:25-115). A terminated
node's torus carves leave the occupancy ledger (``ops/topology.LEDGER``),
so no later gang window offers its grid as a seed bin. Given
``journal=``, each teardown is a ``node-delete`` intent (open →
instance-deleted → closed) and the released carves' intents close with it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Set, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import Node, Pod
from karpenter_tpu_torch.cloudprovider.spi import CloudProvider
from karpenter_tpu_torch.ops import topology as topo_ops
from karpenter_tpu_torch.runtime.kubecore import (
    Conflict, InternalError, KubeCore, NotFound, TooManyRequests,
)
from karpenter_tpu_torch.utils import clock
from karpenter_tpu_torch.utils import pod as podutil

log = logging.getLogger("karpenter.termination")

EVICTION_BASE_DELAY = 0.1   # eviction.go:31-35
EVICTION_MAX_DELAY = 10.0

SYSTEM_CRITICAL = ("system-cluster-critical", "system-node-critical")


def is_stuck_terminating(pod: Pod) -> bool:
    """terminate.go IsStuckTerminating: deletion grace period elapsed but the
    pod object persists (partitioned kubelet)."""
    if pod.metadata.deletion_timestamp is None:
        return False
    return clock.now() > pod.metadata.deletion_timestamp


class EvictionQueue:
    """Rate-limited eviction worker (eviction.go:39-115). A PDB rejection
    requeues the pod with backoff."""

    def __init__(self, kube: KubeCore):
        self.kube = kube
        self._set: Set[Tuple[str, str]] = set()
        self._failures: dict = {}
        self._cv = threading.Condition()
        self._items: List[Tuple[float, Tuple[str, str]]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="eviction-queue",
                                        daemon=True)
        self._thread.start()

    def add(self, pods: List[Pod]) -> None:
        with self._cv:
            for p in pods:
                nn = (p.metadata.namespace, p.metadata.name)
                if nn not in self._set:
                    self._set.add(nn)
                    self._items.append((time.monotonic(), nn))
            self._cv.notify()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the worker; with ``timeout``, also wait up to that long for
        its thread to end."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if timeout is not None:
            self._thread.join(timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                now = time.monotonic()
                ready = [i for i, (t, _) in enumerate(self._items) if t <= now]
                if not ready:
                    delay = min((t - now for t, _ in self._items), default=0.2)
                    self._cv.wait(timeout=max(0.01, min(delay, 0.2)))
                    continue
                t, nn = self._items.pop(ready[0])
            if self._evict(nn):
                with self._cv:
                    self._set.discard(nn)
                    self._failures.pop(nn, None)
            else:
                with self._cv:
                    n = self._failures.get(nn, 0) + 1
                    self._failures[nn] = n
                    backoff = min(EVICTION_BASE_DELAY * (2 ** n), EVICTION_MAX_DELAY)
                    self._items.append((time.monotonic() + backoff, nn))

    def _evict(self, nn: Tuple[str, str]) -> bool:
        """eviction.go:91-110: 404 → done; a PDB rejection → retry. A 500
        means the PDB configuration is broken (more than one budget selects
        the pod, or one sets both fields); a 429 means a healthy budget is
        holding the line. Both requeue with backoff."""
        namespace, name = nn
        try:
            self.kube.evict_pod(name, namespace)
            log.debug("evicted pod %s/%s", namespace, name)
            return True
        except NotFound:
            return True
        except InternalError:  # 500: PDB misconfiguration
            log.debug("failed to evict %s/%s due to PDB misconfiguration",
                      namespace, name)
            return False
        except TooManyRequests:  # 429: PDB violation
            log.debug("failed to evict %s/%s due to PDB violation",
                      namespace, name)
            return False
        except Conflict:
            log.debug("eviction of %s/%s rejected (conflict)", namespace, name)
            return False
        except Exception:
            log.exception("evicting %s/%s", namespace, name)
            return False


class Terminator:
    """terminate.go."""

    def __init__(self, kube: KubeCore, cloud_provider: CloudProvider, journal=None):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.journal = journal
        self.eviction_queue = EvictionQueue(kube)

    def cordon(self, node: Node) -> None:
        if node.spec.unschedulable:
            return

        def apply(live: Node):
            live.spec.unschedulable = True
        self.kube.patch("Node", node.metadata.name, node.metadata.namespace, apply)
        log.info("cordoned node %s", node.metadata.name)

    def drain(self, node: Node) -> bool:
        """Returns True when fully drained (terminate.go drain)."""
        pods = self.kube.pods_on_node(node.metadata.name)
        for p in pods:
            if p.metadata.annotations.get(wellknown.DO_NOT_EVICT_ANNOTATION) == "true":
                log.debug("unable to drain %s: pod %s has do-not-evict",
                          node.metadata.name, p.metadata.name)
                return False
        evictable = self._get_evictable_pods(pods)
        if not evictable:
            return True
        self._evict(evictable)
        return False

    def terminate(self, node: Node) -> None:
        """CloudProvider.Delete, then strip the finalizer (terminate.go).
        Journaled as a ``node-delete`` intent: a crash between the instance
        delete and the finalizer strip leaves a Node whose instance is gone,
        and recovery finishes exactly this method."""
        journal = self.journal
        iid = None
        if journal is not None:
            iid = journal.open_intent("node-delete", node=node.metadata.name,
                                      provider_id=node.spec.provider_id)
        err = self.cloud_provider.delete(node)
        if err is not None:
            if iid is not None:
                journal.close(iid, outcome="error")
            raise RuntimeError(f"terminating cloudprovider instance: {err}")
        if iid is not None:
            journal.advance(iid, "instance-deleted")

        def apply(live: Node):
            live.metadata.finalizers = [
                f for f in live.metadata.finalizers
                if f != wellknown.TERMINATION_FINALIZER]
        try:
            self.kube.patch("Node", node.metadata.name, node.metadata.namespace, apply)
        except NotFound:
            if iid is not None:
                journal.close(iid)
            self._release_carves(node.metadata.name)
            return
        if iid is not None:
            journal.close(iid)
        self._release_carves(node.metadata.name)
        log.info("deleted node %s", node.metadata.name)

    def _release_carves(self, name: str) -> None:
        """A terminated node's ledger carves die with it; otherwise the next
        gang window would keep offering the dead node's residual grid as a
        seed bin. Their durable carve intents close with them."""
        for rec in topo_ops.LEDGER.pop_node(name):
            if self.journal is not None and rec.intent_id:
                self.journal.close(rec.intent_id, outcome="node-terminated")

    def _get_evictable_pods(self, pods: List[Pod]) -> List[Pod]:
        evictable = []
        for p in pods:
            if podutil.tolerates_unschedulable_taint(p):
                continue  # will reschedule onto the cordoned node anyway
            if is_stuck_terminating(p):
                continue
            if podutil.is_owned_by_node(p):
                continue  # static mirror pods
            evictable.append(p)
        return evictable

    def _evict(self, pods: List[Pod]) -> None:
        """Non-critical first; critical only once non-critical are gone."""
        pending = [p for p in pods if p.metadata.deletion_timestamp is None]
        non_critical = [p for p in pending
                        if p.spec.priority_class_name not in SYSTEM_CRITICAL]
        critical = [p for p in pending
                    if p.spec.priority_class_name in SYSTEM_CRITICAL]
        if non_critical:
            self.eviction_queue.add(non_critical)
        else:
            self.eviction_queue.add(critical)


class TerminationController:
    """controller.go:62-98."""

    def __init__(self, kube: KubeCore, cloud_provider: CloudProvider, journal=None):
        self.kube = kube
        self.terminator = Terminator(kube, cloud_provider, journal=journal)

    def kind(self) -> str:
        return "Node"

    def reconcile(self, name: str, namespace: str = "") -> Optional[float]:
        try:
            node = self.kube.get("Node", name, namespace)
        except NotFound:
            return None
        if (node.metadata.deletion_timestamp is None
                or wellknown.TERMINATION_FINALIZER not in node.metadata.finalizers):
            return None
        self.terminator.cordon(node)
        if not self.terminator.drain(node):
            return 1.0  # requeue until drained
        self.terminator.terminate(node)
        return None

    def stop_all(self, timeout: Optional[float] = None) -> None:
        """Stop the eviction queue (Manager.stop); with ``timeout``, wait up
        to that long for its thread to end."""
        self.terminator.eviction_queue.stop(timeout)
