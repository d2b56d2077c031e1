"""Black-box flight recorder.

A bounded in-memory ring of recent spans + trigger events that is ALWAYS
on (it costs a deque append), plus an optional dump-to-disk: when a dump
directory is configured (``configure(dir=...)`` or the
``KARPENTER_FLIGHT_DIR`` env var), each trigger writes one tagged JSON
snapshot of the ring — the last thing the system was doing when it went
wrong.

The JAX package's ``obs/flight.py``. Triggers, hooked at the source:

- ``pressure-l3`` — `PressureMonitor.evaluate()` rising into L3.
- ``slo-burn`` — the burn-rate sentinel in ``obs/slo.py`` finding a
  band's fast AND slow windows past their burn thresholds; tagged with
  the offending band, stage, burn rate, and a sample slow window's
  trace id.

- ``chaos-fault`` — `FaultPlan.decide()` in ``chaos/inject.py`` firing a
  planned fault; tagged with the kind, boundary, op, call index and seed.
- ``recovery-rollback`` — `RecoveryController.run()` in
  ``controllers/recovery.py`` rolling back at least one intent; tagged
  with the rollback, forward and noop counts.

The JAX package's ``watchdog-trip`` has no source here: the port has no
device watchdog (a device error raises).

Dumps are rate-limited (``min_interval_s``), and the first trip of a
process always dumps: the JAX package starts its last-dump clocks at 0.0
against ``time.monotonic()`` (the host's uptime on Linux), so on a host up
for less than the interval its first trip, the boot-time crash a
recorder exists for, writes nothing. With no directory configured
the recorder never touches the filesystem. ``slo-burn`` is limited on its
own clock: a burn storm produces exactly one dump per interval without
starving (or being starved by) a concurrent dump of another trigger.
A failed dump write (``OSError``) is the one error swallowed here: the
trip stays recorded in memory.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.obs import trace

_RING_CAP = 1024
_LOCK = threading.Lock()
_EVENTS: deque = deque(maxlen=_RING_CAP)   # trigger + span records
_DUMPS: deque = deque(maxlen=32)           # paths written this process
_TRIPS: deque = deque(maxlen=256)          # trigger records only

_DIR: Optional[str] = os.environ.get("KARPENTER_FLIGHT_DIR") or None
_MIN_INTERVAL_S = 5.0
# monotonic time of the last dump, None while none was written: "never
# dumped" is its own state, so the first trip of a process dumps however
# short the host's uptime (time.monotonic() counts from boot on Linux)
_LAST_DUMP: Optional[float] = None
_LAST_DUMP_SLO: Optional[float] = None  # independent clock for slo-burn
_TRIP_COUNT = 0


def _note_span(sp: Any) -> None:
    # sink registered with obs.trace: finished spans feed the ring when
    # tracing is enabled (the ring itself is always available)
    with _LOCK:
        _EVENTS.append({"kind": "span", "name": sp.name,
                        "trace_id": sp.trace_id, "span_id": sp.span_id,
                        "t0": sp.t0, "t1": sp.t1,
                        "tags": dict(sp.tags) if sp.tags else None})


trace.add_sink(_note_span)


def configure(dir: Optional[str] = None,
              min_interval_s: Optional[float] = None) -> None:
    global _DIR, _MIN_INTERVAL_S
    if dir is not None:
        _DIR = dir or None
    if min_interval_s is not None:
        _MIN_INTERVAL_S = float(min_interval_s)


def trip(trigger: str, **tags: Any) -> Optional[str]:
    """Record a trigger event; write a tagged JSON dump if a directory is
    configured and the rate limit allows. Returns the dump path (or
    None). The active trace id, if any, rides along automatically so the
    dump names the poisoned window."""
    global _LAST_DUMP, _LAST_DUMP_SLO, _TRIP_COUNT
    tid = trace.current_trace_id()
    if tid is not None and "trace_id" not in tags:
        tags["trace_id"] = tid
    rec = {"kind": "trigger", "trigger": trigger, "tags": tags,
           "wall": time.time(), "t": time.perf_counter()}
    with _LOCK:
        _TRIP_COUNT += 1
        _EVENTS.append(rec)
        _TRIPS.append(rec)
        if _DIR is None:
            return None
        now = time.monotonic()
        if trigger == "slo-burn":
            if _LAST_DUMP_SLO is not None and now - _LAST_DUMP_SLO < _MIN_INTERVAL_S:
                return None
            _LAST_DUMP_SLO = now
        else:
            if _LAST_DUMP is not None and now - _LAST_DUMP < _MIN_INTERVAL_S:
                return None
            _LAST_DUMP = now
        events = list(_EVENTS)
        seq = _TRIP_COUNT
    return _write_dump(trigger, tags, events, seq)


def _write_dump(trigger: str, tags: Dict[str, Any],
                events: List[Dict[str, Any]], seq: int) -> Optional[str]:
    assert _DIR is not None
    payload = {"trigger": trigger, "tags": tags, "wall": time.time(),
               "events": events, "spans": trace.snapshot(limit=2048),
               "tracer": trace.state()}
    name = f"flight-{seq:05d}-{trigger}.json"
    path = os.path.join(_DIR, name)
    try:
        os.makedirs(_DIR, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f)
    except OSError:
        return None
    with _LOCK:
        _DUMPS.append(path)
    return path


def recent(n: int = 50) -> List[Dict[str, Any]]:
    """Most recent trigger records (newest last)."""
    with _LOCK:
        return list(_TRIPS)[-n:]


def recent_dumps() -> List[str]:
    with _LOCK:
        return list(_DUMPS)


def state() -> Dict[str, Any]:
    """Cheap status block for /debug/vars."""
    with _LOCK:
        last = _TRIPS[-1] if _TRIPS else None
        return {"dir": _DIR, "ring_events": len(_EVENTS),
                "trips": _TRIP_COUNT, "dumps_written": len(_DUMPS),
                "last_trigger": (last["trigger"] if last else None),
                "min_interval_s": _MIN_INTERVAL_S}


def reset() -> None:
    """Tests: clear ring, trip history, and rate-limit state (the dump
    directory setting is left alone — pass configure() to change it)."""
    global _LAST_DUMP, _LAST_DUMP_SLO, _TRIP_COUNT
    with _LOCK:
        _EVENTS.clear()
        _TRIPS.clear()
        _DUMPS.clear()
        _LAST_DUMP = None
        _LAST_DUMP_SLO = None
        _TRIP_COUNT = 0
