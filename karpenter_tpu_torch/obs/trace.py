"""Process-wide span tracer for the provisioning path.

The JAX package's ``obs/trace.py``, with its profiler hook on torch.
Design constraints:

- ~µs overhead when enabled, a strict no-op when disabled: the disabled
  ``span()`` call returns a preallocated singleton and touches nothing
  else, so steady-state allocation count stays flat (pinned by
  ``tests/test_obs.py``).
- Lock-striped finished-span rings: writers hash their span id onto one
  of ``_N_STRIPES`` bounded deques so shard workers never contend on a
  single lock.
- Span context is an explicit, carryable value: ``current_context()``
  captures the active span and ``use_context()`` reinstates it on
  another thread — this is how a window's identity survives the
  ``BatchHandle``/``WhatIfHandle`` dispatch/fetch split and the shard
  worker handoff.
- ``new_window_id()`` works even when tracing is disabled so
  ``window_id=`` log keys exist unconditionally and logs/traces join on
  the same id.

Export is Chrome-trace-event JSON (``dump_chrome``): complete events
(``ph="X"``, ts/dur in µs) for spans, instant events (``ph="i"``) for
point events such as DeviceRing alloc/refill.  ``tools/traceview.py``
reads this dump.  With ``enable(annotations=True)`` every entered span
also enters a ``torch.profiler.record_function`` range of its name, so a
``torch.profiler`` session shows each span beside the kernels launched
inside it (and ``torch.autograd.profiler.emit_nvtx`` turns the ranges into
NVTX ranges for ``nsys``). A range attributes the kernels a span
*launches*, not the ones it waits for: a launch is asynchronous, so the
device time of a dispatch lands in the range that launched it, and the
retroactive ``device_solve`` span (dispatch → fetch) is the one that holds
the device's wall. Retroactive spans (:func:`add_span`) enter no range.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

_N_STRIPES = 8
_RING_PER_STRIPE = 4096

# Module-level state. `_ENABLED` is read as a plain attribute on every
# span() call — no lock, no function call — which keeps the disabled
# path at tens of nanoseconds.
_ENABLED = False
_ANNOTATIONS = False
_EPOCH = time.perf_counter()  # ts base for the chrome dump (µs since import)


class _Stripe:
    __slots__ = ("lock", "ring", "dropped")

    def __init__(self, cap: int) -> None:
        self.lock = threading.Lock()
        self.ring: deque = deque(maxlen=cap)
        self.dropped = 0


_STRIPES = [_Stripe(_RING_PER_STRIPE) for _ in range(_N_STRIPES)]
_TLS = threading.local()
_IDS = itertools.count(1)  # CPython next() is atomic under the GIL
_PID_PREFIX = f"{os.getpid() & 0xFFFF:04x}"

# Sinks let obs.flight (and tests) observe finished spans without trace
# importing flight (keeps this module a leaf).
_SINKS: List[Any] = []

# Dump extras let higher layers (obs.slo) ride their state into every
# chrome dump's otherData without trace importing them (still a leaf).
_DUMP_EXTRAS: Dict[str, Any] = {}


def add_dump_extra(name: str, fn: Any) -> None:
    """Register a callable whose result is embedded as
    ``otherData[name]`` in every :func:`dump_chrome` payload."""
    _DUMP_EXTRAS[name] = fn


def new_window_id() -> str:
    """Cheap process-unique window id — available with tracing DISABLED
    too, so structured ``window_id=`` log keys never go missing."""
    return f"w-{_PID_PREFIX}-{next(_IDS):07d}"


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class _NoopSpan:
    """Singleton stand-in when tracing is disabled: every method is a
    no-op and allocates nothing."""

    __slots__ = ()
    trace_id: Optional[str] = None
    span_id = 0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def tag(self, **tags: Any) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "tags", "tid", "_prev", "_range")

    def __init__(self, name: str, trace_id: Optional[str],
                 parent_id: int, tags: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_IDS)
        self.parent_id = parent_id
        self.tags = tags
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = 0
        self._prev: Any = None
        self._range: Any = None

    def tag(self, **tags: Any) -> "Span":
        if self.tags is None:
            self.tags = tags
        else:
            self.tags.update(tags)
        return self

    def __enter__(self) -> "Span":
        self._prev = getattr(_TLS, "span", None)
        _TLS.span = self
        self.t0 = time.perf_counter()
        if _ANNOTATIONS:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _TLS.span = self._prev
        self._prev = None
        _record(self)
        return False


def _record(sp: Span) -> None:
    sp.tid = threading.get_ident() & 0xFFFFFF
    stripe = _STRIPES[sp.span_id & (_N_STRIPES - 1)]
    with stripe.lock:
        if len(stripe.ring) == stripe.ring.maxlen:
            stripe.dropped += 1
        stripe.ring.append(sp)
    for sink in _SINKS:
        sink(sp)


def span(name: str, **tags: Any):
    """Child span under the thread's current context (or a parentless
    span when none is active). Returns the no-op singleton when tracing
    is disabled."""
    if not _ENABLED:
        return _NOOP
    cur = getattr(_TLS, "span", None)
    return Span(name, cur.trace_id if cur is not None else None,
                cur.span_id if cur is not None else 0, tags or None)


def window_span(kind: str, window_id: Optional[str] = None, **tags: Any):
    """Root span for one provisioning/consolidation/replay window. The
    window id IS the trace id, so logs carrying ``window_id=`` join the
    trace directly."""
    if not _ENABLED:
        return _NOOP
    return Span(kind, window_id or new_window_id(), 0, tags or None)


def add_span(name: str, t0: float, t1: float,
             trace_id: Optional[str] = None, parent_id: int = 0,
             **tags: Any) -> None:
    """Record a retroactively-timed span (e.g. the intake wait measured
    before its window span exists, or the device-solve in-flight period
    only known at fetch). t0/t1 are time.perf_counter() values."""
    if not _ENABLED:
        return
    if trace_id is None:
        cur = getattr(_TLS, "span", None)
        if cur is not None:
            trace_id = cur.trace_id
            if parent_id == 0:
                parent_id = cur.span_id
    sp = Span(name, trace_id, parent_id, tags or None)
    sp.t0, sp.t1 = t0, t1
    _record(sp)


def event(name: str, **tags: Any) -> None:
    """Instant event (Chrome ``ph="i"``) — DeviceRing alloc/refill etc."""
    if not _ENABLED:
        return
    now = time.perf_counter()
    add_span(name, now, now, **tags)


# ---------------------------------------------------------------------------
# Context carry (dispatch/fetch split, shard handoff)
# ---------------------------------------------------------------------------


def current_context() -> Optional[Span]:
    """The active span, as a value that can be carried across threads."""
    if not _ENABLED:
        return None
    return getattr(_TLS, "span", None)


def current_trace_id() -> Optional[str]:
    cur = getattr(_TLS, "span", None)
    return cur.trace_id if cur is not None else None


class use_context:
    """Reinstate a captured span context on the current thread — the
    fetch half of a handle runs its children under the window that
    dispatched it, wherever fetch happens."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[Span]) -> None:
        self._ctx = ctx
        self._prev: Any = None

    def __enter__(self) -> Optional[Span]:
        self._prev = getattr(_TLS, "span", None)
        if self._ctx is not None:
            _TLS.span = self._ctx
        return self._ctx

    def __exit__(self, *exc: Any) -> bool:
        _TLS.span = self._prev
        return False


# ---------------------------------------------------------------------------
# Enable / disable / introspection
# ---------------------------------------------------------------------------


def enable(annotations: bool = False) -> None:
    """Turn tracing on; ``annotations`` also enters a
    ``torch.profiler.record_function`` range with every entered span."""
    global _ENABLED, _ANNOTATIONS
    _ANNOTATIONS = bool(annotations)
    _ENABLED = True


def disable() -> None:
    global _ENABLED, _ANNOTATIONS
    _ENABLED = False
    _ANNOTATIONS = False


def enabled() -> bool:
    return _ENABLED


def add_sink(fn: Any) -> None:
    if fn not in _SINKS:
        _SINKS.append(fn)


def remove_sink(fn: Any) -> None:
    if fn in _SINKS:
        _SINKS.remove(fn)


def reset() -> None:
    """Drop all recorded spans (tests, or between measured runs)."""
    for stripe in _STRIPES:
        with stripe.lock:
            stripe.ring.clear()
            stripe.dropped = 0


def snapshot(limit: int = 0) -> List[Dict[str, Any]]:
    """All finished spans as dicts, t0-ordered. limit=0 means all."""
    spans: List[Span] = []
    for stripe in _STRIPES:
        with stripe.lock:
            spans.extend(stripe.ring)
    spans.sort(key=lambda s: s.t0)
    if limit:
        spans = spans[-limit:]
    return [_span_dict(s) for s in spans]


def _span_dict(s: Span) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "name": s.name, "trace_id": s.trace_id, "span_id": s.span_id,
        "parent_id": s.parent_id, "t0": s.t0, "t1": s.t1, "tid": s.tid,
    }
    if s.tags:
        d["tags"] = s.tags
    return d


def state() -> Dict[str, Any]:
    """Cheap status block for /debug/vars."""
    recorded = sum(len(st.ring) for st in _STRIPES)
    dropped = sum(st.dropped for st in _STRIPES)
    return {"enabled": _ENABLED, "annotations": _ANNOTATIONS,
            "spans_buffered": recorded, "spans_dropped": dropped,
            "stripes": _N_STRIPES}


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def chrome_events(spans: Optional[List[Dict[str, Any]]] = None
                  ) -> List[Dict[str, Any]]:
    """Chrome-trace-event list: ``X`` complete events for spans,
    ``i`` instant events for zero-duration ones."""
    out: List[Dict[str, Any]] = []
    for d in (spans if spans is not None else snapshot()):
        args = dict(d.get("tags") or {})
        if d.get("trace_id"):
            args["trace_id"] = d["trace_id"]
        args["span_id"] = d["span_id"]
        if d.get("parent_id"):
            args["parent_id"] = d["parent_id"]
        ts = (d["t0"] - _EPOCH) * 1e6
        ev: Dict[str, Any] = {"name": d["name"], "pid": 1,
                              "tid": d.get("tid", 0), "ts": ts, "args": args}
        if d["t1"] <= d["t0"]:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = (d["t1"] - d["t0"]) * 1e6
        out.append(ev)
    return out


def dump_chrome(path: str) -> str:
    """Write the buffered spans as a Chrome/Perfetto-loadable trace.
    Returns the path written."""
    payload = {"traceEvents": chrome_events(),
               "displayTimeUnit": "ms",
               "otherData": {"tracer": "karpenter_tpu_torch.obs.trace",
                             "spans": state()}}
    for name, fn in list(_DUMP_EXTRAS.items()):
        payload["otherData"][name] = fn()
    dirname = os.path.dirname(os.path.abspath(path))
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


# ---------------------------------------------------------------------------
# Overhead measurement (the tracing tax: spans × ns per span over a window)
# ---------------------------------------------------------------------------


def measure_overhead(n: int = 20_000) -> Dict[str, float]:
    """ns/span for the enabled and disabled paths. Restores the prior
    enabled state and drops the measurement spans afterwards."""
    was_enabled, was_annotated = _ENABLED, _ANNOTATIONS
    try:
        disable()
        t0 = time.perf_counter()
        for _ in range(n):
            with span("overhead-probe"):
                pass
        disabled_ns = (time.perf_counter() - t0) / n * 1e9
        enable(annotations=False)
        t0 = time.perf_counter()
        for _ in range(n):
            with span("overhead-probe"):
                pass
        enabled_ns = (time.perf_counter() - t0) / n * 1e9
    finally:
        disable()
        if was_enabled:
            enable(annotations=was_annotated)
    # the probe spans are noise — drop them (cheap: rings are bounded)
    reset()
    return {"disabled_ns_per_span": disabled_ns,
            "enabled_ns_per_span": enabled_ns, "n": float(n)}
