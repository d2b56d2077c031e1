"""Batched what-if consolidation solves: N candidate drains, one kernel.

A copy of the JAX package's ``solver/whatif.py`` on the port's kernel. A
non-blocking dispatch half copies the window's padded tensors to the device
in one host→device copy and launches ``ops/whatif_cuda.whatif_scan`` (one
thread block per candidate), one copy and one launch a shard of the
solver mesh when the candidates split over it (parallel/mesh.py); a fetch
half reads the answer back and translates the receiver-pruned bin
positions to bin indices. A window of candidates therefore costs ONE
launch a shard instead of N incremental host re-packs.

The device answer is a *filter*, never an authority: plan selection
(``plan_window``) walks the feasible candidates in savings order and
re-verifies each accepted drain exactly on host nano ints
(ops/whatif.verify_and_commit) against the free capacity remaining after
earlier drains in the same window — zero unverified drains, by
construction, even if the kernel were wrong.

The one window the kernel does not answer is one the encoding cannot give
it (not int32-encodable, past ``MAX_WINDOW_CELLS``, or no bin can
receive): the exact host mirror ``host_whatif`` answers it, with executor
``"host-whatif"``. A device error raises. Dispatch is the retroactive
``dispatch`` span and the fetch a ``fetch`` span under the dispatching
window's context, as in the JAX package. Left out of the reference: the
``use_device`` and ``device_min_cells`` gates, the watchdog and breaker, the
DeviceRing and the host-mirror fallbacks on a device error.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.obs import trace as obtrace
from karpenter_tpu_torch.ops.whatif import (
    WhatIfEncoding, host_whatif, verify_and_commit)
from karpenter_tpu_torch.ops.whatif_cuda import whatif_scan
from karpenter_tpu_torch.parallel.mesh import MeshLike, resolve_mesh, row_sharding
from karpenter_tpu_torch.solver.solve import record_executor


@dataclass
class WhatIfHandle:
    """The in-flight half of a window solve. ``fetch()`` blocks until the
    device has answered and is idempotent."""

    enc: WhatIfEncoding
    device: torch.device
    # per shard of the mesh, in candidate order: the kernel's (feasible,
    # slots) and the CUDA events around its launch (None on the CPU)
    _shards: List[tuple] = field(default_factory=list)
    _result: Optional[Tuple[np.ndarray, np.ndarray, str]] = None
    dispatch_seconds: float = 0.0
    # the kernel's CUDA-event time, once fetched (None on the CPU or when
    # the host mirror answered)
    kernel_ms: Optional[float] = None
    # the dispatching window's span context, re-entered at fetch
    _trace_ctx: Optional[object] = None

    def fetch(self) -> Tuple[np.ndarray, np.ndarray, str]:
        """(feasible (N,), slots (N, K) bin index or -1, executor)."""
        if self._result is not None:
            return self._result
        with obtrace.use_context(self._trace_ctx), \
                obtrace.span("fetch", candidates=self.enc.n):
            self._result = self._fetch()
        return self._result

    def _fetch(self) -> Tuple[np.ndarray, np.ndarray, str]:
        enc = self.enc
        if not self._shards:
            feas, slots = host_whatif(enc)
            executor = "host-whatif"
        else:
            # one device→host copy of each output a shard, gathered in
            # candidate order
            feas = np.concatenate([f.cpu().numpy() for (f, _), _ in self._shards])[:enc.n]
            slots = np.concatenate([s.cpu().numpy() for (_, s), _ in self._shards]
                                   )[:enc.n, :max(enc.k, 1)]
            if self._shards[0][1] is not None:
                self.kernel_ms = max(start.elapsed_time(end)
                                     for _, (start, end) in self._shards)
            # device bins are receiver-pruned positions; translate back to
            # bin indices (the host contract)
            kept = np.asarray(enc.kept, dtype=np.int32)
            slots = np.where(slots >= 0, kept[np.clip(slots, 0, len(kept) - 1)],
                             np.int32(-1)).astype(np.int32)
            executor = "device-whatif"
            self._shards = []
        record_executor(executor, count=max(enc.n, 1))
        return feas, slots, executor


def _to_device(enc: WhatIfEncoding, device: torch.device,
               rows: slice = slice(None)) -> List[torch.Tensor]:
    """The window's five tensors on ``device`` in one host→device copy, the
    candidate arrays cut to ``rows`` (``free0`` whole): the int32 arrays,
    then the bool ones, laid end to end in one byte buffer (every int32
    part is a whole number of words, so its view is aligned)."""
    ints = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (enc.d_pods[rows], enc.d_free0, enc.d_cand_bin[rows])]
    bools = [np.ascontiguousarray(a, dtype=np.bool_)
             for a in (enc.d_valid[rows], enc.d_compat[rows])]
    flat = torch.from_numpy(np.concatenate(
        [a.view(np.uint8).ravel() for a in ints] + [a.view(np.uint8).ravel() for a in bools]))
    flat = flat.to(device)
    out, o = [], 0
    for a in ints:
        out.append(flat[o:o + a.nbytes].view(torch.int32).view(a.shape))
        o += a.nbytes
    for a in bools:
        out.append(flat[o:o + a.nbytes].view(torch.bool).view(a.shape))
        o += a.nbytes
    pods, free0, cand_bin, valid, compat = out
    return [pods, valid, compat, free0, cand_bin]


def dispatch_window(enc: WhatIfEncoding, device: MeshLike = None) -> WhatIfHandle:
    """Launch the scan over the mesh ``device`` resolves to
    (parallel/mesh.resolve_mesh; default: the solver mesh of every CUDA
    device; raises without one; ``"cpu"`` runs the plain version) without
    waiting for it: the candidates split into one range a shard when
    their padded count divides by the mesh size, else all on the mesh's
    first device, ``free0`` copied to each shard's device. Each shard's
    launch and its events run on its device's current stream. A window
    the encoding could not give the device is answered by
    ``host_whatif`` at fetch."""
    mesh = resolve_mesh(device)
    handle = WhatIfHandle(enc=enc, device=mesh[0], _trace_ctx=obtrace.current_context())
    if not enc.device_ready:
        return handle
    t0 = time.perf_counter()
    for sh in row_sharding(enc.d_pods.shape[0], mesh):
        dev = sh.device
        tensors = _to_device(enc, dev, sh.rows)
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = whatif_scan(*tensors)
            end.record(stream)
            handle._shards.append((out, (start, end)))
        else:
            handle._shards.append((whatif_scan(*tensors), None))
    handle.dispatch_seconds = time.perf_counter() - t0
    obtrace.add_span("dispatch", t0, time.perf_counter(), candidates=enc.n)
    return handle


def solve_window(enc: WhatIfEncoding, device: MeshLike = None
                 ) -> Tuple[np.ndarray, np.ndarray, str]:
    """dispatch + fetch in one call."""
    return dispatch_window(enc, device).fetch()


@dataclass
class WindowAction:
    """One verified drain: candidate index, its bin, the receiving bins
    (one per pod, host-verified), and the $/h it reclaims."""

    cand: int
    bin: int
    placements: List[int]
    saving: float


@dataclass
class WindowPlan:
    actions: List[WindowAction] = field(default_factory=list)
    reclaimed_per_hour: float = 0.0
    evaluated: int = 0
    feasible: int = 0

    @property
    def drained_bins(self) -> List[int]:
        return [a.bin for a in self.actions]


def plan_window(
    enc: WhatIfEncoding,
    feasible: np.ndarray,
    savings: Sequence[float],
    max_drains: int = 8,
    incremental_targets: Optional[List[int]] = None,
) -> WindowPlan:
    """Greedy cheapest-feasible plan over the window, re-verifying each
    accepted drain on exact host ints against the capacity remaining after
    earlier drains in the same window — and never draining a bin that
    RECEIVED pods this window (its free vector now backs a placement, the
    same receiver invariant as models/consolidate.removable_nodes).

    Greedy order matters: draining the priciest node first can consume
    receiver slack that would have let several cheaper drains through. So
    the planner runs THREE greedy legs over the same verified machinery —
    $/h-saved descending, fewest-pods-to-move first, and an exact
    emulation of the incremental removable_nodes pass — and keeps
    whichever plan reclaims more. ``incremental_targets`` is that pass's
    receiver set: the bins of every drainable-or-empty node, in its
    fewest-movable-pods-first order (the caller knows which bins those
    are; default approximates with the candidate bins). The third leg
    makes "at least as cheap as the old one-node-per-pass loop" true by
    construction."""
    plan = WindowPlan(evaluated=enc.n, feasible=int(np.sum(feasible[:enc.n])))
    if enc.n == 0:
        return plan
    candidates = [i for i in range(enc.n) if feasible[i]]

    def greedy(order: List[int],
               scan: Optional[List[int]] = None) -> WindowPlan:
        p = WindowPlan(evaluated=plan.evaluated, feasible=plan.feasible)
        free_state = [list(bn.free) for bn in enc.bins]
        drained: set = set()
        receivers: set = set()
        for i in order:
            if len(p.actions) >= max_drains:
                break
            bidx = enc.cand_bin[i]
            if bidx in drained or bidx in receivers:
                continue
            placements = verify_and_commit(enc, i, free_state, drained,
                                           scan=scan)
            if placements is None:
                continue  # earlier drains consumed the slack the kernel saw
            drained.add(bidx)
            receivers.update(placements)
            p.actions.append(WindowAction(
                cand=i, bin=bidx, placements=placements, saving=savings[i]))
            p.reclaimed_per_hour += savings[i]
        return p

    by_savings = greedy(sorted(
        candidates, key=lambda i: (-savings[i], len(enc.cand_pods[i]), i)))
    by_moves = greedy(sorted(
        candidates, key=lambda i: (len(enc.cand_pods[i]), -savings[i], i)))
    # removable_nodes emulation: candidates by fewest movable pods (stable),
    # receivers restricted to the incremental pass's target bins in its order
    inc_order = sorted(candidates, key=lambda i: len(enc.cand_pods[i]))
    scan = incremental_targets if incremental_targets is not None \
        else [enc.cand_bin[i] for i in inc_order]
    pos = {b: p for p, b in enumerate(scan)}
    inc_order = sorted((i for i in inc_order if enc.cand_bin[i] in pos),
                       key=lambda i: pos[enc.cand_bin[i]])
    incremental = greedy(inc_order, scan=scan)
    return max(by_moves, by_savings, incremental,
               key=lambda p: p.reclaimed_per_hour)
