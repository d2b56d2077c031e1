"""Bounded-depth pipelined executor for the provisioning hot loop.

The serial hot loop stacks its costs end to end: schedule and encode chunk
N, wait for its device solve, launch and bind, then start chunk N+1. With
``solver/batch_solve.py`` split into dispatch and fetch halves, this module
overlaps them instead:

    chunk N-1 ──► launch/bind ─────────┐
    chunk N   ──► device solve (in flight on the current CUDA stream)
    chunk N+1 ──► schedule/encode + dispatch ◄─ host

Depth 2 (double buffering, the default) keeps at most one batch in flight
while the host works. A copy of the JAX package's executor
(``solver/pipeline.py:276-504``). Guarantees:

- **Order**: chunks are consumed strictly in submission order (FIFO), so
  bind order and result order match the serial path exactly.
- **Pressure**: the effective depth is re-read from the PressureMonitor
  before every dispatch; at L1+ it collapses to 1 (serial).
- **Drain**: on any stage failure every in-flight handle is still fetched
  and consumed (each under its own try/except) before the first error
  re-raises: no SolveResult is dropped, and the FIFO pop guarantees no
  chunk is launched twice.
- **Adaptive depth** (:class:`_AdaptiveDepth`): the realized overlap of
  each window steps the depth 1↔2↔3.

Overlap is measured from the pipeline's own per-chunk stats. Left out: the
JAX package's device buffer ring (the port's dispatch already sends each
chunk's inputs in one host→device copy), the hedged fetcher's scope, the
metrics and the trace spans.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

log = logging.getLogger("karpenter.solver.pipeline")


class _AdaptiveDepth:
    """Step the pipeline depth from measured overlap instead of a flag.

    Per uncollapsed window the pipeline reports (wall, overlap) — overlap
    being the seconds dispatched batches spent in flight while the host did
    other pipeline work. The state is just the current target depth:

    - at depth > 1: ``overlap/wall < PAY_FRAC`` for ``COLLAPSE_AFTER``
      consecutive windows steps DOWN; ``overlap/wall >= RAISE_FRAC`` steps
      UP to ``MAX_DEPTH``.
    - at depth 1 (by adaptation, not pressure): every ``PROBE_EVERY``-th
      window probes depth 2.

    Pressure-collapsed windows are NOT observed: L1+ forces serial for
    latency reasons and says nothing about whether overlap pays."""

    MAX_DEPTH = 3
    PAY_FRAC = 0.10
    RAISE_FRAC = 0.35
    COLLAPSE_AFTER = 2
    PROBE_EVERY = 8

    def __init__(self, base_depth: int):
        self.depth = min(max(1, int(base_depth)), self.MAX_DEPTH)
        self._no_pay = 0
        self._serial_windows = 0

    def observe(self, wall_s: float, overlap_s: float, depth_used: int) -> int:
        if wall_s <= 1e-4:
            return self.depth  # too small to signal anything
        if depth_used <= 1:
            self._serial_windows += 1
            if self.depth <= 1 and self._serial_windows >= self.PROBE_EVERY:
                self._serial_windows = 0
                self.depth = 2
                log.info("adaptive depth: probing depth %d", self.depth)
            return self.depth
        self._serial_windows = 0
        frac = overlap_s / wall_s
        if frac < self.PAY_FRAC:
            self._no_pay += 1
            if self._no_pay >= self.COLLAPSE_AFTER:
                self._no_pay = 0
                self.depth = max(1, self.depth - 1)
                log.info("adaptive depth: overlap %.1f%% of wall cannot pay; "
                         "stepping down to %d", 100 * frac, self.depth)
        else:
            self._no_pay = 0
            if frac >= self.RAISE_FRAC and self.depth < self.MAX_DEPTH:
                self.depth += 1
                log.info("adaptive depth: overlap %.1f%% of wall; probing "
                         "depth %d", 100 * frac, self.depth)
        return self.depth


@dataclass
class PipelineConfig:
    """``depth`` bounds dispatched-but-unfetched chunks (1 = serial, 2 =
    double-buffered). ``chunk_items`` is the L0 chunk size the provisioning
    loop feeds the pipeline — applied at EVERY depth so depth 1 and depth 2
    see identical chunk boundaries (the L1+ pressure split takes
    precedence; 0 keeps the window whole). ``adaptive`` makes ``depth`` the
    STARTING point of the measured-overlap state machine (bounded by
    ``_AdaptiveDepth.MAX_DEPTH``); False pins it."""

    depth: int = 2
    chunk_items: int = 4096
    adaptive: bool = True


class SolvePipeline:
    """Drive ``prepare → dispatch → fetch → consume`` over ordered chunks
    with at most ``depth`` handles in flight. Hold ONE instance per worker:
    the adaptive-depth state machine learns across provisioning windows."""

    def __init__(self, config: Optional[PipelineConfig] = None, monitor=None):
        self.config = config or PipelineConfig()
        self._monitor = monitor
        self._adaptive = (_AdaptiveDepth(self.config.depth)
                          if self.config.adaptive else None)
        self._window_overlap = 0.0
        self._window_max_depth = 1
        # the last window: wall_s, overlap_s, depth
        self.last_window: Dict[str, float] = {}

    def set_monitor(self, monitor) -> None:
        """Per-window monitor rebind (the worker resolves it per batch)."""
        self._monitor = monitor

    def target_depth(self) -> int:
        """The depth this pipeline is AIMING for (adaptive state if on,
        else the configured depth) — before the pressure collapse."""
        if self._adaptive is not None:
            return self._adaptive.depth
        return max(1, int(self.config.depth))

    def effective_depth(self) -> int:
        """Target depth, collapsed to 1 (serial) at pressure L1+."""
        depth = self.target_depth()
        if depth > 1 and self._monitor is not None and int(self._monitor.level()) >= 1:
            return 1
        return depth

    def run(self, chunks, prepare: Callable, dispatch: Callable,
            consume: Callable, on_chunk: Optional[Callable] = None) -> List:
        """Run every chunk through the pipeline; returns ``consume``'s
        outputs in chunk order.

        ``prepare(chunk)`` does the host-side marshal (scheduling, problem
        build); ``dispatch(prep)`` returns a handle with ``.fetch()``;
        ``consume(prep, results)`` does launch/bind. ``on_chunk(prep,
        stats)``, if given, receives each chunk's stage timings:
        ``marshal_s`` (prepare + dispatch), ``inflight_s`` (dispatch → the
        start of its fetch: the device time hidden behind host work),
        ``device_s`` (the blocked fetch), ``launch_bind_s``, and the
        perf_counter stamps ``t_dispatch``, ``t_fetch`` and ``t_done``."""
        depth = self.effective_depth()
        self._window_overlap = 0.0
        self._window_max_depth = depth
        t0 = time.perf_counter()
        try:
            return self._run(chunks, prepare, dispatch, consume, on_chunk)
        finally:
            wall = time.perf_counter() - t0
            self.last_window = {"wall_s": wall, "overlap_s": self._window_overlap,
                                "depth": self._window_max_depth}
            collapsed = self._monitor is not None and int(self._monitor.level()) >= 1
            if self._adaptive is not None and not collapsed:
                self._adaptive.observe(wall, self._window_overlap, self._window_max_depth)

    def _run(self, chunks, prepare, dispatch, consume, on_chunk) -> List:
        inflight: deque = deque()  # FIFO of (prep, handle, t_disp, stats)
        outs: List = []
        try:
            for chunk in chunks:
                # re-read the ladder before every dispatch: a mid-window
                # rise to L1+ must stop us running ahead immediately
                depth = self.effective_depth()
                self._window_max_depth = max(self._window_max_depth, depth)
                while len(inflight) >= depth:
                    self._complete(inflight.popleft(), consume, outs, on_chunk)
                t0 = time.perf_counter()
                prep = prepare(chunk)
                handle = dispatch(prep)
                t1 = time.perf_counter()
                stats = {"marshal_s": t1 - t0, "t_dispatch": t1}
                inflight.append((prep, handle, t1, stats))
            while inflight:
                self._complete(inflight.popleft(), consume, outs, on_chunk)
        except BaseException:
            self._drain(inflight, consume, outs, on_chunk)
            raise
        return outs

    def _complete(self, entry, consume, outs, on_chunk) -> None:
        prep, handle, t_disp, stats = entry
        t0 = time.perf_counter()
        # the in-flight span: device time hidden behind host work (~0 when
        # serial, where every fetch immediately follows its dispatch)
        stats["inflight_s"] = t0 - t_disp
        self._window_overlap += stats["inflight_s"]
        results = handle.fetch()
        t1 = time.perf_counter()
        out = consume(prep, results)
        t2 = time.perf_counter()
        stats["device_s"] = t1 - t0
        stats["launch_bind_s"] = t2 - t1
        stats["t_fetch"] = t1
        stats["t_done"] = t2
        if on_chunk is not None:
            on_chunk(prep, stats)
        outs.append(out)

    def _drain(self, inflight: deque, consume, outs, on_chunk) -> None:
        """Fault/shutdown path: fetch AND consume every outstanding handle
        so no solved chunk is dropped; per-handle failures are logged, not
        raised (the original error is already propagating)."""
        while inflight:
            entry = inflight.popleft()
            try:
                self._complete(entry, consume, outs, on_chunk)
            except Exception:
                log.exception("pipeline drain: outstanding chunk failed")
