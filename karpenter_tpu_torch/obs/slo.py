"""Per-pod SLO engine: mergeable latency digests + burn-rate sentinel.

The JAX package's ``obs/slo.py``. Its replay harness proves
band-differentiated p99 bind latency after the fact, from exact per-pod
lists; this module makes the same answer available *continuously* and
with *bounded* memory:

- :class:`Digest` — a DDSketch-style relative-error quantile sketch.
  Log-spaced buckets with ratio ``gamma = (1+alpha)/(1-alpha)`` guarantee
  every quantile estimate is within ``alpha`` relative error of the true
  sample; memory is capped at ``max_bins`` buckets (lowest buckets
  collapse first, preserving tail accuracy). Record is O(1); two digests
  merge by adding bucket counts, so sketches combine across shard
  workers and across the ``BatchHandle`` dispatch/fetch split exactly
  like span context does.
- :class:`SloEngine` — a lock-striped map of (band × stage) cells, one
  digest each. Stages follow the pod lifecycle: ``intake``
  (enqueue → window close), ``schedule`` (close → solve dispatch),
  ``solve`` (dispatch → fetch), ``bind`` (fetch → bound), and ``e2e``
  (enqueue → bound).
- :class:`BurnSentinel` — multi-window burn-rate alerting per band: the
  fraction of ``e2e`` samples (and intake sheds) breaching the band's
  latency objective, over a fast (1m) and a slow (30m) window, divided
  by the error budget. When both windows burn past their thresholds the
  sentinel trips the flight recorder (``slo-burn``), flags the band for
  readyz, and keeps gauges updated.

Window identity rides the same carryable-context pattern as
``obs.trace``: :func:`use_marks` reinstates a window's
:class:`WindowMarks` (close timestamp + per-pod band/intake metadata) on
whichever thread fetches the batch.

This module registers no metrics itself: the ``karpenter_slo_*`` series
live in ``karpenter_tpu_torch.metrics.slo``.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from karpenter_tpu_torch.metrics import slo as mslo
from karpenter_tpu_torch.obs import flight, trace

STAGES = ("intake", "schedule", "solve", "bind", "e2e")

_N_STRIPES = 8


# ---------------------------------------------------------------------------
# Digest
# ---------------------------------------------------------------------------


class Digest:
    """DDSketch-style relative-error quantile sketch.

    A positive value ``v`` lands in bucket ``ceil(log(v)/log(gamma))``;
    the bucket's representative value ``2*gamma^i/(gamma+1)`` (the
    geometric midpoint) is within ``alpha`` relative error of every
    sample in the bucket. Values at or below ``MIN_VALUE`` share a zero
    bucket. Memory is bounded: past ``max_bins`` buckets the two lowest
    collapse into one, trading low-quantile accuracy for tail fidelity
    (the tail is what SLOs read)."""

    __slots__ = ("alpha", "gamma", "_inv_lg", "max_bins", "counts",
                 "n", "total", "vmin", "vmax", "zero")

    MIN_VALUE = 1e-6

    def __init__(self, alpha: float = 0.008, max_bins: int = 1024) -> None:
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._inv_lg = 1.0 / math.log(self.gamma)
        self.max_bins = max_bins
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zero = 0

    # -- record -------------------------------------------------------------
    def record(self, v: float) -> None:
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= self.MIN_VALUE:
            self.zero += 1
            return
        idx = math.ceil(math.log(v) * self._inv_lg)
        counts = self.counts
        counts[idx] = counts.get(idx, 0) + 1
        if len(counts) > self.max_bins:
            self._collapse()

    def record_n(self, v: float, count: int) -> None:
        """Record ``count`` identical samples in O(1) — a chunk of pods
        sharing one schedule/solve/bind duration is one bucket add."""
        if count <= 0:
            return
        self.n += count
        self.total += v * count
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= self.MIN_VALUE:
            self.zero += count
            return
        idx = math.ceil(math.log(v) * self._inv_lg)
        counts = self.counts
        counts[idx] = counts.get(idx, 0) + count
        if len(counts) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the lowest bucket upward until within budget — tail
        buckets (what p99 reads) are never touched."""
        while len(self.counts) > self.max_bins:
            keys = sorted(self.counts)
            lo, nxt = keys[0], keys[1]
            self.counts[nxt] += self.counts.pop(lo)

    # -- merge --------------------------------------------------------------
    def merge(self, other: "Digest") -> "Digest":
        """Fold ``other`` into self (bucket-count addition). Requires the
        same alpha so bucket indices line up."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError("cannot merge digests with different alpha")
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        if len(self.counts) > self.max_bins:
            self._collapse()
        self.n += other.n
        self.total += other.total
        self.zero += other.zero
        if other.vmin < self.vmin:
            self.vmin = other.vmin
        if other.vmax > self.vmax:
            self.vmax = other.vmax
        return self

    def copy(self) -> "Digest":
        d = Digest(self.alpha, self.max_bins)
        d.counts = dict(self.counts)
        d.n, d.total, d.zero = self.n, self.total, self.zero
        d.vmin, d.vmax = self.vmin, self.vmax
        return d

    # -- read ---------------------------------------------------------------
    def quantile(self, q: float) -> float:
        """Estimate the q-quantile using the same rank convention as the
        replay's exact-list report (``vs[min(n-1, int(n*q))]``), clamped
        to the exact observed [min, max]."""
        if self.n == 0:
            return 0.0
        rank = min(self.n - 1, int(self.n * q))
        if rank < self.zero:
            return max(0.0, min(self.vmin, self.MIN_VALUE))
        cum = self.zero
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum > rank:
                est = 2.0 * self.gamma ** idx / (self.gamma + 1.0)
                return min(self.vmax, max(self.vmin, est))
        return self.vmax

    def bins(self) -> int:
        return len(self.counts)

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def report(self) -> Dict[str, Any]:
        """The shape the replay report (and its verdict gate) reads."""
        if self.n == 0:
            return {"p50": 0.0, "p99": 0.0, "max": 0.0, "n": 0}
        return {"p50": round(self.quantile(0.50), 4),
                "p99": round(self.quantile(0.99), 4),
                "max": round(self.vmax, 4), "n": self.n}

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"alpha": self.alpha, "max_bins": self.max_bins,
                "counts": {str(k): v for k, v in self.counts.items()},
                "n": self.n, "total": self.total, "zero": self.zero,
                "min": (None if self.n == 0 else self.vmin),
                "max": (None if self.n == 0 else self.vmax)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Digest":
        dg = cls(d.get("alpha", 0.008), d.get("max_bins", 1024))
        dg.counts = {int(k): int(v) for k, v in d.get("counts", {}).items()}
        dg.n = int(d.get("n", 0))
        dg.total = float(d.get("total", 0.0))
        dg.zero = int(d.get("zero", 0))
        dg.vmin = math.inf if d.get("min") is None else float(d["min"])
        dg.vmax = -math.inf if d.get("max") is None else float(d["max"])
        return dg

    @classmethod
    def merged(cls, digests: Iterable["Digest"]) -> "Digest":
        out: Optional[Digest] = None
        for d in digests:
            if out is None:
                out = d.copy()
            else:
                out.merge(d)
        return out if out is not None else cls()


# ---------------------------------------------------------------------------
# Engine: lock-striped (band × stage) cells
# ---------------------------------------------------------------------------


class SloEngine:
    """Fixed-memory per-cell latency accounting. ``record`` hashes the
    (band, stage) key onto one of ``stripes`` locks so shard workers
    stamping different cells never contend."""

    def __init__(self, alpha: float = 0.008, max_bins: int = 1024,
                 stripes: int = _N_STRIPES) -> None:
        self.alpha = alpha
        self.max_bins = max_bins
        self._stripes = [threading.Lock() for _ in range(stripes)]
        self._make_lock = threading.Lock()
        # key -> (stripe lock, digest): one dict hit on the hot path;
        # the same key always maps to the same stripe lock
        self._cells: Dict[Tuple[str, str], Tuple[Any, Digest]] = {}

    def _cell(self, key: Tuple[str, str]) -> Tuple[Any, Digest]:
        with self._make_lock:
            ent = self._cells.get(key)
            if ent is None:
                lock = self._stripes[hash(key) % len(self._stripes)]
                ent = self._cells[key] = (lock, Digest(self.alpha,
                                                       self.max_bins))
            return ent

    def record(self, band: str, stage: str, seconds: float,
               count: int = 1) -> None:
        key = (band, stage)
        ent = self._cells.get(key)
        if ent is None:
            ent = self._cell(key)
        lock, cell = ent
        with lock:
            if count == 1:
                cell.record(seconds)
            else:
                cell.record_n(seconds, count)

    def digest(self, band: str, stage: str) -> Optional[Digest]:
        """Copy of one cell's digest (safe to merge/read lock-free)."""
        ent = self._cells.get((band, stage))
        if ent is None:
            return None
        lock, cell = ent
        with lock:
            return cell.copy()

    def merge_from(self, other: "SloEngine") -> None:
        """Fold another engine's cells in — shard aggregation."""
        for (band, stage) in list(other._cells):
            d = other.digest(band, stage)
            if d is None or d.n == 0:
                continue
            lock, cell = self._cell((band, stage))
            with lock:
                cell.merge(d)

    def stage_digest(self, stage: str) -> Digest:
        """All bands merged for one stage — what traceview renders."""
        return Digest.merged(
            d for d in (self.digest(b, s) for (b, s) in list(self._cells)
                        if s == stage) if d is not None)

    # -- introspection ------------------------------------------------------
    def records_total(self) -> int:
        return sum(d.n for d in (self.digest(b, s)
                                 for (b, s) in list(self._cells))
                   if d is not None)

    def cell_count(self) -> int:
        return len(self._cells)

    def total_bins(self) -> int:
        return sum(d.bins() for d in (self.digest(b, s)
                                      for (b, s) in list(self._cells))
                   if d is not None)

    def snapshot(self) -> Dict[str, Any]:
        """Quantile summary per cell plus per-stage all-band merges."""
        cells: Dict[str, Dict[str, Any]] = {}
        stages_present = set()
        for (band, stage) in sorted(self._cells):
            d = self.digest(band, stage)
            if d is None:
                continue
            cells.setdefault(band, {})[stage] = d.report()
            stages_present.add(stage)
        stages = {s: self.stage_digest(s).report()
                  for s in STAGES if s in stages_present}
        return {"alpha": self.alpha, "max_bins": self.max_bins,
                "cells": cells, "stages": stages,
                "records": self.records_total(),
                "total_bins": self.total_bins()}

    def reset(self) -> None:
        with self._make_lock:
            for lk in self._stripes:
                lk.acquire()
            try:
                self._cells.clear()
            finally:
                for lk in self._stripes:
                    lk.release()


# ---------------------------------------------------------------------------
# Objectives + burn-rate sentinel
# ---------------------------------------------------------------------------


class Objective:
    """Latency objective for one band: ``target`` fraction of pods bound
    within ``threshold_s`` (measured on the ``e2e`` stage; intake sheds
    count as breaches — a shed pod is burning budget by definition)."""

    __slots__ = ("threshold_s", "target", "stage")

    def __init__(self, threshold_s: float, target: float = 0.99,
                 stage: str = "e2e") -> None:
        self.threshold_s = float(threshold_s)
        self.target = float(target)
        self.stage = stage

    def to_dict(self) -> Dict[str, Any]:
        return {"threshold_s": self.threshold_s, "target": self.target,
                "stage": self.stage}


def default_objectives() -> Dict[str, Objective]:
    """Generous production defaults for the cohort bands (the bands the
    replay gate reads). Low/besteffort carry no objective: the pressure
    ladder sheds them by design and that must not read as an SLO burn."""
    return {"system-critical": Objective(30.0),
            "high": Objective(45.0),
            "default": Objective(60.0)}


class BurnSentinel:
    """Fast/slow-window burn-rate evaluation per band.

    Samples land in coarse time buckets (``BUCKET_S``); the ring is
    bounded by the slow window, so memory is O(bands × buckets). Burn
    rate = (breach fraction over the window) / (1 − target). A band is
    *burning* when the fast window exceeds ``fast_burn`` AND the slow
    window exceeds ``slow_burn`` (the classic multi-window rule: fast
    catches the spike, slow filters the blip)."""

    BUCKET_S = 5.0

    def __init__(self, objectives: Optional[Dict[str, Objective]] = None,
                 fast_window_s: float = 60.0, slow_window_s: float = 1800.0,
                 fast_burn: float = 6.0, slow_burn: float = 1.0,
                 trip_interval_s: float = 30.0,
                 timefunc=time.monotonic) -> None:
        self.objectives = (objectives if objectives is not None
                           else default_objectives())
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.trip_interval_s = trip_interval_s
        self._time = timefunc
        self._lock = threading.Lock()
        max_buckets = int(slow_window_s / self.BUCKET_S) + 2
        # band -> deque of [bucket_key, total, breaches]
        self._rings: Dict[str, deque] = {}
        self._max_buckets = max_buckets
        self._sample_trace: Dict[str, Optional[str]] = {}
        self._burning: Dict[str, Dict[str, Any]] = {}
        self._last_trip: Dict[str, float] = {}
        self._last_trip_tags: Optional[Dict[str, Any]] = None
        self._trips_total = 0
        self._breaches_total = 0

    # -- feed ---------------------------------------------------------------
    def observe(self, band: str, seconds: Optional[float] = None,
                shed: bool = False) -> None:
        obj = self.objectives.get(band)
        if obj is None:
            return
        breach = shed or (seconds is not None and seconds > obj.threshold_s)
        now = self._time()
        bucket = int(now // self.BUCKET_S)
        with self._lock:
            ring = self._rings.get(band)
            if ring is None:
                ring = self._rings[band] = deque(maxlen=self._max_buckets)
            if not ring or ring[-1][0] != bucket:
                ring.append([bucket, 0, 0])
            ring[-1][1] += 1
            if breach:
                ring[-1][2] += 1
                self._breaches_total += 1
                self._sample_trace[band] = trace.current_trace_id()
        if breach:
            self._note_breach(band, obj, seconds, shed)

    def _note_breach(self, band: str, obj: Objective,
                     seconds: Optional[float], shed: bool) -> None:
        mslo.SLO_BREACHES.inc(band=band, stage=obj.stage)
        if seconds is not None:
            mslo.SLO_BREACH_LATENCY.observe(
                seconds, exemplar=self._sample_trace.get(band), band=band)

    # -- evaluate -----------------------------------------------------------
    def _window_burn(self, ring: deque, window_s: float, now: float,
                     budget: float) -> Tuple[float, int, int]:
        cutoff = int((now - window_s) // self.BUCKET_S)
        total = breaches = 0
        for bucket, t, b in ring:
            if bucket >= cutoff:
                total += t
                breaches += b
        if total == 0:
            return 0.0, 0, 0
        return (breaches / total) / budget, total, breaches

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Burn rates per band; updates the burning set, trips the
        flight recorder on sustained burn, publishes gauges."""
        now = self._time() if now is None else now
        out: Dict[str, Any] = {}
        to_trip: List[Tuple[str, Dict[str, Any]]] = []
        with self._lock:
            for band, obj in self.objectives.items():
                ring = self._rings.get(band)
                if not ring:
                    continue
                budget = max(1e-9, 1.0 - obj.target)
                fast, fn, fb = self._window_burn(
                    ring, self.fast_window_s, now, budget)
                slow, sn, sb = self._window_burn(
                    ring, self.slow_window_s, now, budget)
                burning = fast >= self.fast_burn and slow >= self.slow_burn
                out[band] = {"fast_burn": round(fast, 3),
                             "slow_burn": round(slow, 3),
                             "burning": burning,
                             "fast_samples": fn, "fast_breaches": fb,
                             "slow_samples": sn, "slow_breaches": sb}
                if burning:
                    rec = self._burning.setdefault(band, {"since": now})
                    rec["last"] = now
                    last = self._last_trip.get(band, -math.inf)
                    if now - last >= self.trip_interval_s:
                        self._last_trip[band] = now
                        self._trips_total += 1
                        tags = {"band": band, "stage": obj.stage,
                                "burn_rate": round(fast, 2),
                                "slow_burn": round(slow, 2),
                                "objective_s": obj.threshold_s,
                                "target": obj.target,
                                "sample_trace_id":
                                    self._sample_trace.get(band)}
                        self._last_trip_tags = tags
                        to_trip.append((band, tags))
                else:
                    self._burning.pop(band, None)
        for _band, tags in to_trip:
            flight.trip("slo-burn", **tags)
        self._publish(out)
        return out

    def _publish(self, burn: Dict[str, Any]) -> None:
        for band, rec in burn.items():
            mslo.SLO_BURN_RATE.set(rec["fast_burn"], band=band,
                                   window="fast")
            mslo.SLO_BURN_RATE.set(rec["slow_burn"], band=band,
                                   window="slow")
        mslo.SLO_BURNING_BANDS.set(
            sum(1 for r in burn.values() if r["burning"]))
        mslo.SLO_BURN_TRIPS.set(self._trips_total)

    # -- introspection ------------------------------------------------------
    def burning(self) -> List[str]:
        with self._lock:
            return sorted(self._burning)

    def trips_total(self) -> int:
        with self._lock:
            return self._trips_total

    def breaches_total(self) -> int:
        with self._lock:
            return self._breaches_total

    def last_trip_tags(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._last_trip_tags) if self._last_trip_tags else None

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "objectives": {b: o.to_dict()
                               for b, o in sorted(self.objectives.items())},
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "fast_burn_threshold": self.fast_burn,
                "slow_burn_threshold": self.slow_burn,
                "burning": sorted(self._burning),
                "trips": self._trips_total,
                "breaches": self._breaches_total,
                "last_trip": (dict(self._last_trip_tags)
                              if self._last_trip_tags else None),
            }

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self._sample_trace.clear()
            self._burning.clear()
            self._last_trip.clear()
            self._last_trip_tags = None
            self._trips_total = 0
            self._breaches_total = 0


# ---------------------------------------------------------------------------
# Window marks: carryable per-window stamp context
# ---------------------------------------------------------------------------


class WindowMarks:
    """One window's SLO stamp context: the close timestamp
    (``time.perf_counter``) plus per-pod ``id(pod) -> (band, intake_s)``
    metadata captured at window close. Carried across the
    ``BatchHandle`` dispatch/fetch split exactly like span context."""

    __slots__ = ("t_close", "meta")

    def __init__(self, t_close: float,
                 meta: Dict[int, Tuple[str, float]]) -> None:
        self.t_close = t_close
        self.meta = meta


_TLS = threading.local()


def current_marks() -> Optional[WindowMarks]:
    return getattr(_TLS, "marks", None)


class use_marks:
    """Reinstate captured window marks on the current thread (no-op when
    ``marks`` is None)."""

    __slots__ = ("_marks", "_prev")

    def __init__(self, marks: Optional[WindowMarks]) -> None:
        self._marks = marks
        self._prev: Any = None

    def __enter__(self) -> Optional[WindowMarks]:
        self._prev = getattr(_TLS, "marks", None)
        if self._marks is not None:
            _TLS.marks = self._marks
        return self._marks

    def __exit__(self, *exc: Any) -> bool:
        _TLS.marks = self._prev
        return False


# ---------------------------------------------------------------------------
# Module-level singleton API (what production code calls)
# ---------------------------------------------------------------------------


def _env_enabled() -> bool:
    return os.environ.get("KARPENTER_SLO", "1").lower() not in (
        "0", "false", "no", "off")


_ENABLED = _env_enabled()
_ENGINE = SloEngine()
_SENTINEL = BurnSentinel()
# record() INVOCATIONS (weighted record_n is one call) — the honest unit
# for the stamping tax: calls × measured ns/call, not samples
_RECORD_CALLS = 0
_EVAL_INTERVAL_S = 1.0
_LAST_EVAL = 0.0
_QUANTILE_PUBLISH_INTERVAL_S = 5.0
_LAST_QUANTILE_PUBLISH = 0.0


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def engine() -> SloEngine:
    return _ENGINE


def sentinel() -> BurnSentinel:
    return _SENTINEL


def configure(enabled: Optional[bool] = None,
              objectives: Optional[Dict[str, Objective]] = None,
              fast_window_s: Optional[float] = None,
              slow_window_s: Optional[float] = None,
              fast_burn: Optional[float] = None,
              slow_burn: Optional[float] = None,
              trip_interval_s: Optional[float] = None) -> None:
    """Adjust the singleton sentinel. ``objectives`` replaces the full
    map (pass :func:`default_objectives` to restore defaults); other
    arguments override individual knobs, None leaves them alone."""
    global _ENABLED, _SENTINEL
    if enabled is not None:
        _ENABLED = bool(enabled)
    s = _SENTINEL
    _SENTINEL = BurnSentinel(
        objectives=(objectives if objectives is not None else s.objectives),
        fast_window_s=(fast_window_s if fast_window_s is not None
                       else s.fast_window_s),
        slow_window_s=(slow_window_s if slow_window_s is not None
                       else s.slow_window_s),
        fast_burn=(fast_burn if fast_burn is not None else s.fast_burn),
        slow_burn=(slow_burn if slow_burn is not None else s.slow_burn),
        trip_interval_s=(trip_interval_s if trip_interval_s is not None
                         else s.trip_interval_s),
        timefunc=s._time)
    _publish_objectives()


def _publish_objectives() -> None:
    for band, obj in _SENTINEL.objectives.items():
        mslo.SLO_OBJECTIVE.set(obj.threshold_s, band=band)


def record(band: str, stage: str, seconds: float, count: int = 1) -> None:
    """Stamp one lifecycle stage for ``count`` pods. O(1) regardless of
    count; a strict near-no-op when disabled."""
    global _RECORD_CALLS
    if not _ENABLED:
        return
    _RECORD_CALLS += 1
    _ENGINE.record(band, stage, seconds, count)
    if stage == "e2e":
        _SENTINEL.observe(band, seconds)
        _maybe_evaluate()


def note_shed(band: str) -> None:
    """An intake shed burns the band's error budget without ever
    producing a latency sample — count it as a breach."""
    if not _ENABLED:
        return
    _SENTINEL.observe(band, shed=True)
    _maybe_evaluate()


def _maybe_evaluate() -> None:
    global _LAST_EVAL, _LAST_QUANTILE_PUBLISH
    now = time.monotonic()
    if now - _LAST_EVAL < _EVAL_INTERVAL_S:
        return
    _LAST_EVAL = now
    _SENTINEL.evaluate()
    if now - _LAST_QUANTILE_PUBLISH >= _QUANTILE_PUBLISH_INTERVAL_S:
        _LAST_QUANTILE_PUBLISH = now
        _publish_quantiles()


def _publish_quantiles() -> None:
    snap = _ENGINE.snapshot()
    for band, stages in snap["cells"].items():
        for stage, rep in stages.items():
            mslo.SLO_STAGE_P50.set(rep["p50"], band=band, stage=stage)
            mslo.SLO_STAGE_P99.set(rep["p99"], band=band, stage=stage)
            mslo.SLO_SAMPLES.set(rep["n"], band=band, stage=stage)


def burning() -> List[str]:
    return _SENTINEL.burning()


def trips_total() -> int:
    return _SENTINEL.trips_total()


def evaluate() -> Dict[str, Any]:
    """Force a sentinel evaluation (readyz, /debug/vars, tests)."""
    return _SENTINEL.evaluate()


def snapshot() -> Dict[str, Any]:
    """Engine quantile summary — also exported into the chrome trace
    dump's otherData for traceview's per-stage p50/p99 columns."""
    return _ENGINE.snapshot()


def state() -> Dict[str, Any]:
    """Status block for a debug endpoint or a report."""
    return {"enabled": _ENABLED,
            "engine": _ENGINE.snapshot(),
            "burn": _SENTINEL.state()}


def record_calls() -> int:
    """record() invocations since the last reset (the stamping tax's
    unit)."""
    return _RECORD_CALLS


def reset() -> None:
    """Tests, or between measured runs: drop all samples and burn state (the
    objective map and window knobs survive; use configure() to change)."""
    global _LAST_EVAL, _LAST_QUANTILE_PUBLISH, _RECORD_CALLS
    _ENGINE.reset()
    _SENTINEL.reset()
    _LAST_EVAL = 0.0
    _LAST_QUANTILE_PUBLISH = 0.0
    _RECORD_CALLS = 0


# ---------------------------------------------------------------------------
# Overhead measurement (the stamping tax, mirrors trace's)
# ---------------------------------------------------------------------------


def measure_overhead(n: int = 20_000) -> Dict[str, float]:
    """ns/record for the enabled and disabled stamping paths, measured
    against scratch engine/sentinel instances so live digests stay
    clean. The enabled probe uses the ``e2e`` stage — the most expensive
    one (digest + sentinel ring)."""
    global _ENABLED, _ENGINE, _SENTINEL
    was_enabled, eng, sen = _ENABLED, _ENGINE, _SENTINEL
    try:
        _ENGINE = SloEngine()
        _SENTINEL = BurnSentinel()
        _ENABLED = False
        t0 = time.perf_counter()
        for _ in range(n):
            record("default", "e2e", 0.25)
        disabled_ns = (time.perf_counter() - t0) / n * 1e9
        _ENABLED = True
        t0 = time.perf_counter()
        for _ in range(n):
            record("default", "e2e", 0.25)
        enabled_ns = (time.perf_counter() - t0) / n * 1e9
    finally:
        _ENABLED, _ENGINE, _SENTINEL = was_enabled, eng, sen
    return {"disabled_ns_per_record": disabled_ns,
            "enabled_ns_per_record": enabled_ns, "n": float(n)}


# Surface digest quantiles inside every chrome trace dump so traceview
# can render per-stage p50/p99 columns next to the critical-path table.
trace.add_dump_extra("slo", snapshot)
