"""Seeded, deterministic fault injection across the control plane's
boundaries.

A copy of the JAX package's ``chaos/inject.py``. A :class:`FaultPlan`
compiles a list of :class:`FaultSpec` triples (boundary × op × fault kind,
with a trigger count) into per-stream fire maps: for every call stream, a
``(boundary, op)`` pair such as ``("provider", "create")``, the plan draws
the call indices at which each fault fires from ``random.Random(seed)``.

The determinism contract: **the decision for the N-th call of a stream is
a pure function of (seed, specs)**. Concurrent controllers may interleave
differently from run to run, which permutes which operation lands on index
N, but the sequence of decisions per stream is reproducible from the seed.
The same (seed, specs, window) gives the same decisions as the JAX
package's plan, call for call.

Boundaries and the fault kinds their shims understand:

========== ============== ==========================================
boundary   op             kinds
========== ============== ==========================================
kube       create/patch/  ``conflict`` (409 before the write lands),
           delete/        ``timeout`` (generic ApiError: the request
           bind_pods/     was lost before the server applied it),
           evict_pod      ``slow-apiserver`` (the request succeeds
                          after a synthetic latency stall)
kube       watch          ``drop`` (a Pod MODIFIED event vanishes;
                          ADDED/DELETED and non-Pod kinds are never
                          dropped, see :class:`_DroppingWatch`)
provider   create         ``ice`` (launch refused), ``crash-before-
                          bind`` (capacity launched, the controller
                          dies before the Node write: the GC leak
                          case), ``spot-interruption`` (the oldest
                          running spot instance is reclaimed through
                          the capacity ledger while this launch
                          proceeds)
pressure   depth          ``queue-flood`` (the monitor's intake-depth
                          sample is inflated by max_depth/2)
pressure   rss            ``memory-pressure`` (the RSS sample is
                          inflated by 87% of the watermark, the L2
                          band, without allocating memory)
journal    <transition>   ``crash-point`` (simulated process death at
                          a named write-ahead-journal transition:
                          ``pre:<kind>:<phase>`` before the record is
                          durable, ``<kind>:<phase>`` after; raises
                          :class:`SimulatedCrash`, a BaseException, so
                          no ``except Exception`` path survives it; see
                          runtime/journal.py KILL_POINTS)
========== ============== ==========================================

Left out of the reference: the ``ec2`` boundary's ``ChaosEC2`` (the port
has no AWS provider) and the ``device``/``solve`` ``watchdog-trip`` kind
(the port has no device watchdog: a device error raises).

Production call sites consult :func:`active_fault`; with no plan installed
that is one global read and a ``None`` return.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.obs import flight

log = logging.getLogger("karpenter.chaos")


@dataclass(frozen=True)
class FaultSpec:
    """``count`` triggers of ``kind`` on the ``(boundary, op)`` stream."""

    boundary: str
    op: str
    kind: str
    count: int = 1


@dataclass(frozen=True)
class FiredFault:
    """One injection that actually happened (for post-soak assertions)."""

    boundary: str
    op: str
    index: int
    kind: str


class FaultPlan:
    """Compiled fault schedule; thread-safe; install with :func:`install`.

    ``window`` bounds how deep into each stream faults may land: fire
    indices are sampled from ``range(window)``, so a stream that receives
    at least ``window`` calls absorbs every planned fault."""

    def __init__(self, seed: int, specs: List[FaultSpec], window: int = 32):
        self.seed = seed
        self.specs = list(specs)
        self.window = window
        self._lock = threading.Lock()
        self._calls: Dict[Tuple[str, str], int] = {}
        self._fired: List[FiredFault] = []
        # compile: one shared RNG, specs consumed in list order, collisions
        # within a stream avoided by sampling from the remaining indices
        rng = random.Random(seed)
        self._fire: Dict[Tuple[str, str], Dict[int, str]] = {}
        free: Dict[Tuple[str, str], List[int]] = {}
        for spec in self.specs:
            if spec.count < 1:
                continue
            stream = (spec.boundary, spec.op)
            pool = free.setdefault(stream, list(range(window)))
            if spec.count > len(pool):
                raise ValueError(
                    f"stream {stream}: {spec.count} triggers do not fit in "
                    f"the remaining window ({len(pool)} of {window} free)")
            picked = rng.sample(pool, spec.count)
            for idx in picked:
                pool.remove(idx)
                self._fire.setdefault(stream, {})[idx] = spec.kind

    # -- decision -----------------------------------------------------------
    def decide(self, boundary: str, op: str) -> Optional[str]:
        """Advance the ``(boundary, op)`` counter and return the fault kind
        planned for this index, if any. A fired fault trips the flight
        recorder (``chaos-fault``)."""
        stream = (boundary, op)
        with self._lock:
            idx = self._calls.get(stream, 0)
            self._calls[stream] = idx + 1
            kind = self._fire.get(stream, {}).get(idx)
            if kind is not None:
                self._fired.append(FiredFault(boundary, op, idx, kind))
        if kind is not None:
            log.info("chaos: injecting %s at %s/%s call #%d", kind, boundary, op, idx)
            flight.trip("chaos-fault", kind=kind, boundary=boundary, op=op, index=idx,
                        seed=self.seed)
        return kind

    # -- introspection (for soak assertions) --------------------------------
    def fired(self) -> List[FiredFault]:
        with self._lock:
            return list(self._fired)

    def fired_counts(self) -> Dict[Tuple[str, str, str], int]:
        counts: Dict[Tuple[str, str, str], int] = {}
        for f in self.fired():
            key = (f.boundary, f.op, f.kind)
            counts[key] = counts.get(key, 0) + 1
        return counts

    def calls(self, boundary: str, op: str) -> int:
        with self._lock:
            return self._calls.get((boundary, op), 0)

    def pending(self) -> int:
        """Planned triggers that have not fired yet (streams too short)."""
        planned = sum(len(m) for m in self._fire.values())
        with self._lock:
            return planned - len(self._fired)


# ---------------------------------------------------------------------------
# Global hook: the only thing production code touches
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def installed() -> Optional[FaultPlan]:
    return _PLAN


def active_fault(boundary: str, op: str) -> Optional[str]:
    """Consult the installed plan; no plan → no fault, one global read."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.decide(boundary, op)


class SimulatedCrash(BaseException):
    """Deterministic simulated process death at a journal kill point.

    Derives from BaseException, not Exception, so the control plane's
    broad ``except Exception`` handling (launch error aggregation,
    reconcile loops, unwind paths) cannot survive it: like a SIGKILL,
    nothing between the kill point and the caller gets to clean up."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at journal kill point {point!r}")
        self.point = point


def crash_point(name: str) -> None:
    """Named kill point on the ``journal`` boundary; the write-ahead
    journal fires one per transition edge (runtime/journal.py
    KILL_POINTS). With no plan installed this is one global read."""
    if active_fault("journal", name) == "crash-point":
        raise SimulatedCrash(name)


# ---------------------------------------------------------------------------
# Kube boundary shim
# ---------------------------------------------------------------------------


class _DroppingWatch:
    """Queue proxy that consults the plan per Pod MODIFIED event and may
    swallow it.

    Only Pod MODIFIED is droppable: the selection controller re-verifies
    every in-flight pod on its requeue, so a lost pod update is recovered by
    level-triggered reconciliation. A dropped ADDED would lose a pod for
    good (the store has no re-list) and a dropped Node MODIFIED could
    swallow a deletionTimestamp, so the injector never makes either."""

    def __init__(self, inner: "queue.Queue"):
        self._inner = inner

    def get(self, block: bool = True, timeout: Optional[float] = None):
        while True:
            event = self._inner.get(block=block, timeout=timeout)
            obj = event.obj
            if (event.type == "MODIFIED"
                    and getattr(obj, "kind", "") == "Pod"
                    and active_fault("kube", "watch") == "drop"):
                continue
            return event

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        self._inner.put(item, block=block, timeout=timeout)

    def qsize(self) -> int:
        return self._inner.qsize()

    def empty(self) -> bool:
        return self._inner.empty()


class ChaosKube:
    """KubeCore wrapper injecting API-server-shaped failures on the write
    path. Reads (get/read/scan/list) pass through untouched.

    Injection happens BEFORE delegation: the request dies on the wire and
    the server never applied it. The port's KubeCore has no full update,
    so that op of the reference has nothing to wrap."""

    _FAULTED_OPS = ("create", "patch", "delete", "bind_pods", "evict_pod")

    #: synthetic API-server latency for ``slow-apiserver`` (seconds)
    SLOW_APISERVER_STALL_S = 0.25

    def __init__(self, inner):
        self._inner = inner

    def _maybe_raise(self, op: str) -> None:
        from karpenter_tpu_torch.runtime.kubecore import ApiError, Conflict

        kind = active_fault("kube", op)
        if kind == "conflict":
            raise Conflict(f"injected conflict on {op}")
        if kind == "timeout":
            raise ApiError(f"injected timeout on {op}")
        if kind == "slow-apiserver":
            # the write succeeds, just late: a degraded (not dead) server
            time.sleep(self.SLOW_APISERVER_STALL_S)

    def create(self, obj):
        self._maybe_raise("create")
        return self._inner.create(obj)

    def patch(self, kind, name, namespace, fn):
        self._maybe_raise("patch")
        return self._inner.patch(kind, name, namespace, fn)

    def delete(self, kind, name, namespace="default"):
        self._maybe_raise("delete")
        return self._inner.delete(kind, name, namespace)

    def bind_pods(self, pods, node_name):
        self._maybe_raise("bind_pods")
        return self._inner.bind_pods(pods, node_name)

    def evict_pod(self, name, namespace="default"):
        self._maybe_raise("evict_pod")
        return self._inner.evict_pod(name, namespace)

    def watch(self, kind=None):
        return _DroppingWatch(self._inner.watch(kind))

    def unwatch(self, q):
        self._inner.unwatch(q._inner if isinstance(q, _DroppingWatch) else q)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return getattr(self._inner, item)
