"""Bounded-depth pipelined executor and the device buffer ring for the
provisioning hot loop.

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

Overlap is measured from the pipeline's own per-chunk stats.

:class:`DeviceRing` is a process-wide pool of device-resident batch tensors
keyed by bucket signature (the JAX package's ``solver/pipeline.py:93-269``).
A steady-state chunk refills an existing slot's tensors in place instead of
allocating: B13, the JAX package's donated ``_refill_jit``
(``dynamic_update_slice`` into the same device buffer), is here
``dst.copy_(staging, non_blocking=True)`` from a pinned host staging buffer
the slot owns. It is a copy, not a kernel: a compute kernel would only do
the copy engine's job more slowly. A fill whose content token matches the
slot's copies nothing (``reuses``); ``allocations`` counts fresh device
tensors. Left out: the hedged fetcher's scope, the metrics and the trace
spans (the counters are attributes).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("karpenter.solver.pipeline")


# --------------------------------------------------------------------------
# Device buffer ring
# --------------------------------------------------------------------------

class _RingSlot:
    """One set of named device-resident batch tensors (one in-flight chunk's
    working set). ``arrays`` is mutated by :meth:`DeviceRing.fill` (refill /
    allocate) and :meth:`DeviceRing.hand_back` (the kernel's resume tensors
    handed to the slot). On a CUDA device every refill copies from the
    slot's pinned ``staging`` tensor of that name, and ``events`` marks when
    that copy has left the staging tensor."""

    __slots__ = ("sig", "arrays", "tokens", "in_use", "last_used", "staging", "events")

    def __init__(self, sig):
        self.sig = sig
        self.arrays: Dict[str, torch.Tensor] = {}
        # content identity of each named tensor, when the producer knows one
        # (the encoder's catalog tokens, byte digests): a fill whose token
        # matches skips the copy entirely
        self.tokens: Dict[str, tuple] = {}
        self.in_use = False
        self.last_used = 0.0
        self.staging: Dict[str, torch.Tensor] = {}
        self.events: Dict[str, torch.cuda.Event] = {}


class DeviceRing:
    """Bounded pool of reusable device tensor sets for the device solve.

    Slots are keyed by signature, the tuple of (name, shape, dtype) of every
    host array in the working set, so a slot is only reused when every
    buffer matches the incoming bucket. ``max_slots`` bounds device memory:
    pipeline depth d needs d+1 live slots (d in flight + 1 filling); the
    least-recently-used FREE slot is evicted beyond the cap. A slot in use
    (its handle not yet fetched) is never refilled by another chunk nor
    evicted: :meth:`acquire` hands every caller a slot of its own."""

    def __init__(self, max_slots: int = 4):
        self.max_slots = max(1, int(max_slots))
        self._slots: List[_RingSlot] = []
        self._lock = threading.Lock()
        self.allocations = 0   # fresh device tensors (slot create, bucket change)
        self.refills = 0       # in-place copies into a live tensor (B13)
        self.reuses = 0        # fills skipped on a content-token match

    @staticmethod
    def signature(host_arrays: Dict[str, object]) -> Tuple:
        return tuple(sorted(
            (name, tuple(np.shape(a)), str(np.asarray(a).dtype))
            for name, a in host_arrays.items() if a is not None))

    def acquire(self, sig) -> _RingSlot:
        """A free slot with this signature, else a new empty one (whose
        first fill allocates). Never blocks: concurrent in-flight chunks
        each get their own slot, which IS the double buffer."""
        with self._lock:
            for slot in self._slots:
                if not slot.in_use and slot.sig == sig:
                    slot.in_use = True
                    slot.last_used = time.monotonic()
                    return slot
            slot = _RingSlot(sig)
            slot.in_use = True
            slot.last_used = time.monotonic()
            self._slots.append(slot)
            self._evict_locked()
            return slot

    def release(self, slot: _RingSlot) -> None:
        with self._lock:
            slot.in_use = False
            slot.last_used = time.monotonic()

    def _evict_locked(self) -> None:
        free = [s for s in self._slots if not s.in_use]
        while len(self._slots) > self.max_slots and free:
            victim = min(free, key=lambda s: s.last_used)
            free.remove(victim)
            self._slots.remove(victim)
            victim.arrays.clear()  # drop the device references
            victim.tokens.clear()
            victim.staging.clear()
            victim.events.clear()

    def fill(self, slot: _RingSlot, name: str, host_array: np.ndarray,
             device: torch.device, token: Optional[tuple] = None) -> torch.Tensor:
        """Place ``host_array`` on ``device`` as ``name`` in this slot: an
        in-place refill of a live tensor of the same shape and dtype (no
        fresh allocation), else a counted fresh allocation.

        ``token`` is the payload's content identity (the encoder's catalog
        token, or a byte digest). When the slot's live tensor carries the
        SAME token the fill copies nothing and returns it, counted in
        ``reuses``. Mutable buffers (the kernel's counts and dropped rows,
        and what :meth:`hand_back` returns) must not be tokened."""
        host = np.ascontiguousarray(host_array)
        src = torch.from_numpy(host)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        old = slot.arrays.get(name)
        reusable = (old is not None and tuple(old.shape) == host.shape
                    and old.dtype == src.dtype and old.device == device)
        if reusable and token is not None and slot.tokens.get(name) == token:
            self.reuses += 1
            return old
        if reusable:
            dst = old
            self.refills += 1
        else:
            dst = torch.empty(host.shape, dtype=src.dtype, device=device)
            self.allocations += 1
        self._copy(slot, name, dst, src)
        slot.arrays[name] = dst
        if token is not None:
            slot.tokens[name] = token
        else:
            slot.tokens.pop(name, None)
        return dst

    @staticmethod
    def _copy(slot: _RingSlot, name: str, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Host bytes into ``dst``. On a CUDA device: through the slot's
        pinned staging tensor, asynchronously on the current stream. The
        staging tensor is written only after the copy out of it that the
        last fill enqueued has finished (its event)."""
        if dst.device.type != "cuda":
            dst.copy_(src)
            return
        staging = slot.staging.get(name)
        if staging is None or staging.shape != src.shape or staging.dtype != src.dtype:
            staging = slot.staging[name] = torch.empty(
                src.shape, dtype=src.dtype, pin_memory=True)
        else:
            event = slot.events.get(name)
            if event is not None:
                event.synchronize()
        staging.copy_(src)
        dst.copy_(staging, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        slot.events[name] = event

    def hand_back(self, slot: _RingSlot, **arrays) -> None:
        """Hand kernel outputs (the next chunk's resume tensors) to the
        slot: a later window refills them in place. Their content is the
        kernel's, not a fill's, so their tokens are dropped."""
        slot.arrays.update(arrays)
        for name in arrays:
            slot.tokens.pop(name, None)

    def note_allocation(self, count: int = 1) -> None:
        """Fresh device allocations off the ring that belong in the same
        ledger (the solo solve's compaction re-buckets)."""
        self.allocations += count

    def counters(self) -> Dict[str, int]:
        return {"allocations": self.allocations, "refills": self.refills,
                "reuses": self.reuses, "slots": len(self._slots)}


_RING: Optional[DeviceRing] = None
_RING_LOCK = threading.Lock()
DEVICE_BYTES_IN_USE = 0  # the last observe_device_bytes() reading


def get_ring() -> DeviceRing:
    """The process-wide ring (device memory is a process-wide resource:
    every worker shares it, like the device)."""
    global _RING
    with _RING_LOCK:
        if _RING is None:
            _RING = DeviceRing()
        return _RING


def reset_ring() -> None:
    """Drop the process ring (a fresh ring counts from zero)."""
    global _RING
    with _RING_LOCK:
        _RING = None


def observe_device_bytes() -> int:
    """Bytes the caching allocator holds in tensors on the current CUDA
    device (``torch.cuda.memory_allocated``), 0 without one; kept in
    :data:`DEVICE_BYTES_IN_USE`."""
    global DEVICE_BYTES_IN_USE
    DEVICE_BYTES_IN_USE = (torch.cuda.memory_allocated()
                           if torch.cuda.is_available() else 0)
    return DEVICE_BYTES_IN_USE


# --------------------------------------------------------------------------
# Adaptive depth
# --------------------------------------------------------------------------


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
            observe_device_bytes()

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
