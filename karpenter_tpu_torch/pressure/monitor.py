"""Pressure monitor: measurable overload signals → one ladder rung.

A trimmed copy of the JAX package's monitor. The control plane degrades in
*levels*, not cliffs:

====  =====================  =============================================
rung  name                   behavior change
====  =====================  =============================================
L0    normal                 nothing — full windows, admit everything
L1    window-shrink          batch windows halve; oversized windows are
                             split into bounded solve chunks, the pipeline
                             runs serial and the window takes the FFD backend
L2    shed low bands         besteffort + low-priority pods refused at
                             intake (counted, re-enter via the selection
                             requeue once pressure falls)
L3    system-critical only   everything but system-critical refused
====  =====================  =============================================

Signals (each maps to a rung; the target level is the max):

- **intake depth** — items awaiting a batch window, summed across all
  registered batchers (L1/L2/L3 at 20 / 50 / 85 % of the depth bound)
- **window assembly wall time** — a slow batcher wait means the loop is
  falling behind its own intake (L1/L2)
- **process RSS** — the growth of /proc/self/status VmRSS since the
  monitor was made, against a watermark (L2 at 85 %, L3 at 100 %). The
  JAX package reads the RSS itself; here the footprint the process had
  when the monitor was made (the interpreter, torch and its CUDA
  libraries) is not pressure: ``import torch`` alone takes a process to
  4.4 GiB with PyTorch 2.11 built for CUDA 12.8 on an H100 host, past the
  4 GiB watermark, which would hold every controller at L3

The JAX package's solver-breaker and kube-throttle signals are left out:
the port has no device breaker (a device error raises) and no rate-limited
API client. The chaos plan reaches both samples the port keeps: a
``pressure``/``depth`` ``queue-flood`` adds half the depth bound and a
``pressure``/``rss`` ``memory-pressure`` adds 87 % of the watermark, one
decision per evaluation.

Hysteresis: the level RISES immediately but FALLS one rung at a time, and
only after the computed target has stayed below the held level for
``dwell_seconds`` continuously.

The rung is the ``karpenter_pressure_level`` gauge and the summed depth
``karpenter_intake_queue_depth``; a rise into L3 trips the flight
recorder (``pressure-l3``) with the rung it rose from and the depth.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, Dict, Optional, Tuple

from karpenter_tpu_torch.chaos.inject import active_fault
from karpenter_tpu_torch.metrics.pressure import INTAKE_QUEUE_DEPTH, PRESSURE_LEVEL
from karpenter_tpu_torch.obs import flight

log = logging.getLogger("karpenter.pressure")


class PressureLevel(IntEnum):
    L0 = 0  # normal
    L1 = 1  # window-shrink / batch-split
    L2 = 2  # shed besteffort + low bands
    L3 = 3  # system-critical only


# the ladder's intake-depth rungs L1 / L2 / L3 as fractions of the depth bound
DEPTH_FRACTIONS = (0.20, 0.50, 0.85)
# aging: queued/shed pods are promoted one band per step (bands.py)
AGING_STEP_SECONDS = 60.0
# signal staleness: a window sample older than this no longer counts
WINDOW_STALENESS_SECONDS = 120.0


@dataclass
class PressureConfig:
    # intake depth bound (the Batcher's hard cap); the depth rungs are
    # DEPTH_FRACTIONS of it
    max_depth: int = 100_000
    # window assembly wall time (seconds)
    window_l1_seconds: float = 5.0
    window_l2_seconds: float = 30.0
    # watermark of the RSS's growth since the monitor was made; 0 disables
    # the signal
    rss_watermark_bytes: int = 4 * 1024 ** 3
    # hysteresis: a rung is surrendered only after the target stays below
    # it this long (per rung — L3→L0 takes 3 dwells)
    dwell_seconds: float = 5.0
    # L1+ window splitting: max pods per schedule+solve chunk
    split_items: int = 4096

    def depth_rungs(self) -> Tuple[int, int, int]:
        """The intake depths at which L1, L2 and L3 begin."""
        return tuple(max(rung, int(self.max_depth * frac))
                     for rung, frac in enumerate(DEPTH_FRACTIONS, 1))


def read_rss_bytes() -> int:
    """Process resident set size from /proc; the getrusage fallback
    (ru_maxrss, a high-watermark) keeps the signal meaningful without
    procfs."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class PressureMonitor:
    """Thread-safe signal aggregator. Producers push partial signals
    (note_*); consumers read :meth:`level`, which re-evaluates at most
    every ``eval_interval`` seconds so per-pod admission checks stay a
    cached integer read."""

    eval_interval = 0.05
    rss_sample_interval = 0.5

    def __init__(self, config: Optional[PressureConfig] = None,
                 timefunc: Optional[Callable[[], float]] = None,
                 rss_fn: Optional[Callable[[], int]] = None):
        self.config = config or PressureConfig()
        self._now = timefunc or time.monotonic
        self._rss_fn = rss_fn or read_rss_bytes
        self._lock = threading.Lock()
        self._depths: Dict[int, int] = {}
        self._window_s = 0.0
        self._window_at: Optional[float] = None
        self._rss = 0
        self._rss_at: Optional[float] = None
        self._rss_base = self._rss_fn() if self.config.rss_watermark_bytes else 0
        self._depth_rungs = self.config.depth_rungs()
        self._level = PressureLevel.L0
        self._below_since: Optional[float] = None
        self._last_eval: Optional[float] = None
        PRESSURE_LEVEL.set(0)

    # -- signal intake -------------------------------------------------------
    def note_depth(self, source: int, depth: int) -> None:
        """Register one batcher's live queue depth (source = id(batcher));
        the depth signal is the sum across sources."""
        with self._lock:
            if depth <= 0:
                self._depths.pop(source, None)
            else:
                self._depths[source] = depth
            total = sum(self._depths.values())
            INTAKE_QUEUE_DEPTH.set(float(total))
            # burst guard: "rises immediately" must hold even when the
            # whole flood lands inside one eval_interval window — a sample
            # crossing a rung threshold forces a re-evaluation
            crossed = any(total >= rung and self._level < level
                          for level, rung in enumerate(self._depth_rungs, 1))
        if crossed:
            self.evaluate()

    def forget_source(self, source: int) -> None:
        """A stopped batcher must not pin the depth signal forever."""
        self.note_depth(source, 0)

    def note_window(self, seconds: float) -> None:
        with self._lock:
            self._window_s = seconds
            self._window_at = self._now()

    # -- evaluation ----------------------------------------------------------
    def _sample_rss(self, now: float) -> int:
        if self._rss_at is None or now - self._rss_at >= self.rss_sample_interval:
            self._rss = self._rss_fn() - self._rss_base
            self._rss_at = now
        rss = self._rss
        if active_fault("pressure", "rss") == "memory-pressure":
            # synthetic memory pressure: 87% of the watermark on top of
            # reality, the L2 band, without allocating anything
            rss += int(0.87 * self.config.rss_watermark_bytes)
        return rss

    def _target(self, now: float) -> PressureLevel:
        c = self.config
        depth = sum(self._depths.values())
        if active_fault("pressure", "depth") == "queue-flood":
            depth += c.max_depth // 2  # synthetic flood: at least L2 depth
        window = self._window_s
        if self._window_at is None or now - self._window_at > WINDOW_STALENESS_SECONDS:
            window = 0.0
        rss = self._sample_rss(now)
        watermark = c.rss_watermark_bytes
        depth_l1, depth_l2, depth_l3 = self._depth_rungs
        if depth >= depth_l3 or (watermark and rss >= watermark):
            return PressureLevel.L3
        if (depth >= depth_l2 or window >= c.window_l2_seconds
                or (watermark and rss >= 0.85 * watermark)):
            return PressureLevel.L2
        if depth >= depth_l1 or window >= c.window_l1_seconds:
            return PressureLevel.L1
        return PressureLevel.L0

    def evaluate(self) -> PressureLevel:
        """Force a recomputation (rise immediately, fall one rung per
        dwell)."""
        now = self._now()
        with self._lock:
            target = self._target(now)
            self._last_eval = now
            if target > self._level:
                log.warning("pressure rising: L%d -> L%d", self._level, target)
                prev = self._level
                self._level = target
                self._below_since = None
                if target >= PressureLevel.L3 > prev:
                    # brownout entry: snapshot what the system was doing
                    flight.trip("pressure-l3", from_level=int(prev),
                                intake_depth=sum(self._depths.values()))
            elif target < self._level:
                if self._below_since is None:
                    self._below_since = now
                elif now - self._below_since >= self.config.dwell_seconds:
                    self._level = PressureLevel(self._level - 1)
                    log.info("pressure easing: now L%d", self._level)
                    # the next rung down needs its own full dwell
                    self._below_since = now if target < self._level else None
            else:
                self._below_since = None
            PRESSURE_LEVEL.set(float(self._level))
            return self._level

    def level(self) -> PressureLevel:
        """Current rung, re-evaluated at most every eval_interval."""
        now = self._now()
        with self._lock:
            if self._last_eval is not None and now - self._last_eval < self.eval_interval:
                return self._level
        return self.evaluate()


# ---------------------------------------------------------------------------
# Process-wide monitor (the solver_health() analog for the intake plane)
# ---------------------------------------------------------------------------

_MONITOR: Optional[PressureMonitor] = None
_MONITOR_LOCK = threading.Lock()


def get_monitor() -> PressureMonitor:
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None:
            _MONITOR = PressureMonitor()
        return _MONITOR


def set_monitor(monitor: Optional[PressureMonitor]) -> None:
    """Install (or, with None, reset) the process-wide monitor."""
    global _MONITOR
    with _MONITOR_LOCK:
        _MONITOR = monitor
