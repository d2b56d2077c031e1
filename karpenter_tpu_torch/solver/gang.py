"""Batched gang co-pack solves (B10) on the what-if kernel, and the planner.

The JAX package's ``solver/gang.py`` jits ``_gang_jit``: a vmap over the
gangs of a window of a first-fit scan over each gang's members into a
private copy of the shared prospective-node pool. That is ``_whatif_jit``
with no own bin and one compat row per gang, so a gang window here is one
launch of the hand-written what-if kernel
(``ops/whatif_cuda.whatif_scan``, ``csrc/whatif.cu``) with ``cand_bin =
-1`` for every gang and the gang's (GB, BB) compat row expanded to (GB,
KB, BB) on the device. It computes what ``_gang_jit`` computes, slots
included: the scan goes on past a member that fits nowhere.

:func:`dispatch_gang_window` copies the window's gang and carve arrays to
the device in one host→device copy, runs the carve program (B11,
solver/topology.py) and ANDs its verdict into compat on the device, in
the same stream with no host sync, and launches the kernel.
:meth:`GangHandle.fetch` checks the carve verdict's probe cells against
the scalar oracle (a failure launches the kernel again on the scalar
verdict, counted in ``solver/topology.HEALS``) and reads the answer back.
A window the encoding could not give the device (no int32 scales, past
``MAX_WINDOW_CELLS``) is answered by ``host_gang`` with executor
``"host-gang"``; every other window runs the kernel, and a device error
raises.

The device verdict is a FILTER: :func:`plan_gang_window` walks the window
in priority order and re-verifies every accepted gang on exact host nano
ints against the running pool (ops/gang.verify_and_commit_gang) before
anything binds, and prices preemption of lower-band residents against the
gang's fresh-node cost.

Left out of the reference: ``GangConfig`` (its ``device_min_cells`` gate,
the watchdog, the breaker), the DeviceRing and mesh, the host-mirror
fallback on a device error, and the metrics (the planner's declines are
counted in :data:`DECLINES`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.backend import DeviceLike, resolve_device, to_device_int32
from karpenter_tpu_torch.ops.gang import (
    EncodedGang, GangEncoding, host_gang, verify_and_commit_gang)
from karpenter_tpu_torch.ops.topology import grid_cells, host_carve, scalar_carve
from karpenter_tpu_torch.ops.whatif_cuda import whatif_scan
from karpenter_tpu_torch.pressure.bands import RANK
from karpenter_tpu_torch.solver import topology as topo_solver
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES
from karpenter_tpu_torch.solver.solve import record_executor

_LOCK = threading.Lock()
# preemption attempts the planner declined since the count was last
# cleared, by reason: "no-victim", "fresh-cheaper", "unplaceable"
DECLINES: Dict[str, int] = {}


def _decline(reason: str) -> None:
    with _LOCK:
        DECLINES[reason] = DECLINES.get(reason, 0) + 1


def gang_inputs(pods: torch.Tensor, valid: torch.Tensor, compat: torch.Tensor,
                free0: torch.Tensor) -> tuple:
    """The what-if kernel's arguments for a padded gang window: ``compat``
    (GB, BB) rows expanded to a contiguous (GB, KB, BB), every gang's own
    bin -1."""
    GB, KB = valid.shape
    rows = compat.bool()[:, None, :].expand(GB, KB, compat.shape[1]).contiguous()
    cand_bin = torch.full((GB,), -1, dtype=torch.int32, device=pods.device)
    return pods, valid.bool(), rows, free0, cand_bin


def gang_scan(pods: torch.Tensor, valid: torch.Tensor, compat: torch.Tensor,
              free0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feasible (GB,), slots (GB, KB)) of a padded gang window on the
    device of its tensors: the what-if kernel on :func:`gang_inputs`. A
    CPU tensor runs the kernel's plain version."""
    return whatif_scan(*gang_inputs(pods, valid, compat, free0))


@dataclass
class GangHandle:
    """In-flight half of a gang window solve; ``fetch()`` blocks until the
    device has answered and is idempotent."""

    enc: GangEncoding
    device: torch.device
    # the kernel's padded gang tensors as launched: (pods, valid, compat
    # with the carve verdict ANDed in, free0) on the device; None for a
    # host answer. Kept past fetch for checks that hold the answer against
    # the plain version.
    inputs: Optional[tuple] = None
    _out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    _compat0: Optional[torch.Tensor] = None  # (GB, BB) compat before the carve AND
    _carve: Optional[torch.Tensor] = None    # (GB, BB) carve verdict on the device
    _events: Optional[tuple] = None
    _result: Optional[Tuple[np.ndarray, np.ndarray, str]] = None
    # CUDA-event ms of the carve program and of the kernel launch, once
    # fetched (None on the CPU or for a host answer)
    carve_ms: Optional[float] = None
    kernel_ms: Optional[float] = None
    healed: bool = False

    def fetch(self) -> Tuple[np.ndarray, np.ndarray, str]:
        """(feasible (G,), slots (G, K) bin index or -1, executor)."""
        if self._result is not None:
            return self._result
        enc = self.enc
        if self._out is None:
            carve_ok = host_carve(enc.carve) if enc.carve is not None else None
            feas, slots = host_gang(enc, carve_ok)
            executor = "host-gang"
        else:
            if self._carve is not None:
                pairs = topo_solver.probe_pairs(enc.g, enc.b, topo_solver.PROBES)
                idx = torch.tensor(pairs, dtype=torch.long, device=self.device)
                values = self._carve[idx[:, 0], idx[:, 1]].cpu().numpy()
                if not topo_solver.probes_hold(enc, pairs, values):
                    self._relaunch(scalar_carve(enc))
            f, s = self._out
            feas = f.cpu().numpy()[:enc.g]
            slots = s.cpu().numpy()[:enc.g, :max(enc.k, 1)]
            if self._events is not None:
                start, mid, end = self._events
                self.carve_ms = start.elapsed_time(mid) if self._carve is not None else None
                self.kernel_ms = mid.elapsed_time(end)
            executor = "device-gang"
            self._out = self._compat0 = self._carve = self._events = None
        record_executor(executor, count=max(enc.g, 1))
        self._result = (feas, slots, executor)
        return self._result

    def _relaunch(self, trusted: np.ndarray) -> None:
        """A failed probe condemned the carve verdict: launch the kernel
        again on compat AND the scalar verdict (padded rows and bins
        unchanged)."""
        self.healed = True
        pods, valid, _, free0 = self.inputs
        padded = np.ones(tuple(self._compat0.shape), bool)
        padded[:trusted.shape[0], :trusted.shape[1]] = trusted
        carve, = to_device_int32([padded], self.device)
        self.inputs = (pods, valid, self._compat0 & (carve != 0), free0)
        self._out = gang_scan(*self.inputs)
        self._events = None


def dispatch_gang_window(enc: GangEncoding, device: DeviceLike = None) -> GangHandle:
    """Copy the window to ``device`` (default: the CUDA device; raises
    without one; ``"cpu"`` runs the plain versions) and launch without
    waiting. A window the encoding could not give the device is answered by
    ``host_gang`` at fetch."""
    dev = resolve_device(device)
    handle = GangHandle(enc=enc, device=dev)
    if not enc.device_ready:
        return handle
    cv = enc.carve
    arrays = [enc.d_pods, enc.d_valid, enc.d_compat, enc.d_free0]
    if cv is not None:
        arrays += topo_solver.carve_arrays(cv)
    tensors = to_device_int32(arrays, dev)
    pods, valid, compat0, free0 = tensors[:4]
    valid, compat0 = valid != 0, compat0 != 0
    handle._compat0 = compat0
    events = None
    if dev.type == "cuda":
        events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(3))
        events[0].record()
    compat = compat0
    if cv is not None:
        # the carve verdict feeds the first fit in the same stream: the
        # scan only ever sees carve-feasible bins
        handle._carve = topo_solver.carve_program(*tensors[4:])
        compat = compat0 & handle._carve
    if events is not None:
        events[1].record()
    handle.inputs = (pods, valid, compat, free0)
    handle._out = gang_scan(*handle.inputs)
    if events is not None:
        events[2].record()
        handle._events = events
    return handle


def solve_gang_window(enc: GangEncoding, device: DeviceLike = None
                      ) -> Tuple[np.ndarray, np.ndarray, str]:
    """dispatch + fetch in one call."""
    return dispatch_gang_window(enc, device).fetch()


@dataclass
class GangPlacement:
    """One verified gang: member pods grouped by receiving bin."""

    gang: EncodedGang
    node_sets: List[Tuple[int, List[Any]]]  # (bin index, member pods)
    # bin index → committed carve cells (slice gangs with carving on)
    carves: dict = field(default_factory=dict)


@dataclass
class PreemptCandidate:
    """One displaceable resident: a gang holding a carve on a seed bin.
    ``refund`` is the nano resource vector the bin gets back when the
    resident's members unbind; ``displacement_cost`` is the what-if repack
    price of placing them again ($/h, solver/policy.whatif_repack_cost)."""

    gang_key: Any
    bin_index: int
    node: str
    band: str
    pods: List[Tuple[str, str]]
    cells: np.ndarray
    refund: List[int]
    displacement_cost: float = 0.0
    taken: bool = False


@dataclass
class PreemptContext:
    """Priced displacement candidates for one window, built by the
    provisioning controller from the occupancy ledger. System-critical
    residents are never offered: the controller leaves them out AND the
    planner's strict band-rank comparison would refuse them anyway."""

    candidates: List[PreemptCandidate] = field(default_factory=list)


@dataclass
class GangPlan:
    placements: List[GangPlacement] = field(default_factory=list)
    unplaced: List[Tuple[EncodedGang, str]] = field(default_factory=list)
    verified: int = 0  # gangs re-verified on host nano ints
    # (beneficiary, victim) pairs the walk decided to displace, in
    # execution order: victims unbind and requeue BEFORE the beneficiary binds
    preemptions: List[Tuple[EncodedGang, PreemptCandidate]] = field(default_factory=list)


def plan_gang_window(enc: GangEncoding, feasible: Optional[np.ndarray] = None,
                     preempt: Optional[PreemptContext] = None) -> GangPlan:
    """Greedy plan in window priority order. ``feasible`` is the device
    (or host) filter; None runs the plain per-gang sequential host loop.
    Either way every accepted gang is re-verified and committed on exact
    host ints against the running pool, so the two modes give the same
    plan node for node: the filter only lets the planner SKIP verifying
    gangs that cannot place (free capacity only shrinks, so infeasible on
    the full pool implies infeasible on the running pool). With carve
    arrays attached the walk also threads per-bin occupancy planes through
    the commits (occupancy only grows, so the same argument holds).

    ``preempt`` enables priced displacement. A slice gang walks the pool
    seeds first: live fragmented capacity, then displacement of strictly
    lower-band residents on those real nodes (while the summed what-if
    displacement price stays under the gang's own fresh-node cost), and
    only then fresh growth. A filter-infeasible gang still gets the
    preemption attempt: eviction un-shrinks the pool, so the filter's
    skip argument does not bind there."""
    plan = GangPlan()
    if enc.g == 0:
        return plan
    free_state = [list(bn.free) for bn in enc.bins]
    occ_state = None
    if enc.carve is not None:
        occ_state = []
        for bn in enc.bins:
            if bn.grid is None:
                occ_state.append(None)
            elif bn.occ is not None:
                occ_state.append(bn.occ.copy())
            else:
                occ_state.append(np.zeros(grid_cells(bn.grid), bool))
    # seed bins (real ledger nodes) are always the bin-list prefix
    n_seed = 0
    for bn in enc.bins:
        if bn.node_name is None:
            break
        n_seed += 1
    for e in enc.gangs:
        carves: dict = {}
        slots = None
        filtered = feasible is not None and not feasible[e.index]
        seeds_first = (preempt is not None and e.slice_dims is not None
                       and n_seed > 0 and not filtered)
        if seeds_first:
            slots = verify_and_commit_gang(enc, e.index, free_state, occ_state, carves,
                                           bin_limit=n_seed)
            plan.verified += 1
            if slots is None:
                slots = _attempt_preemption(enc, e, free_state, occ_state, carves,
                                            preempt, plan, bin_limit=n_seed)
        if slots is None and not filtered:
            slots = verify_and_commit_gang(enc, e.index, free_state, occ_state, carves)
            if not seeds_first:
                plan.verified += 1
        if slots is None and preempt is not None and (not seeds_first or enc.b > n_seed):
            # last-resort full-pool preemption: a filter-infeasible gang
            # comes straight here, and a gang the full verify rejected may
            # still place by spanning a freed seed bin plus fresh growth;
            # skipped only when seeds-first already walked this exact pool
            slots = _attempt_preemption(enc, e, free_state, occ_state, carves, preempt, plan)
        if slots is None:
            plan.unplaced.append((e, "infeasible" if filtered else "capacity"))
            continue
        by_bin: dict = {}
        for pod, bi in zip(e.pods, slots):
            by_bin.setdefault(bi, []).append(pod)
        plan.placements.append(GangPlacement(gang=e, node_sets=sorted(by_bin.items()),
                                             carves=carves))
    return plan


def _attempt_preemption(enc: GangEncoding, e: EncodedGang, free_state: list,
                        occ_state: Optional[list], carves: dict, preempt: PreemptContext,
                        plan: GangPlan, bin_limit: Optional[int] = None
                        ) -> Optional[List[int]]:
    """Evict strictly lower-band residents one at a time (lowest band,
    cheapest displacement first) and retry the exact host verification
    after each, while the summed displacement price stays under the
    gang's fresh-node cost. Every eviction rolls back when the gang still
    cannot place: the pool state only ever advances by a committed
    verification."""
    rank_e = RANK.get(e.band, RANK["default"])
    avail = [c for c in preempt.candidates
             if not c.taken and RANK.get(c.band, RANK["default"]) > rank_e]
    if not avail:
        _decline("no-victim")
        return None
    fresh = e.fresh_cost if e.fresh_cost is not None else float("inf")
    avail.sort(key=lambda c: (-RANK.get(c.band, RANK["default"]), c.displacement_cost,
                              c.node, str(c.gang_key)))
    undo: list = []
    total = 0.0
    chosen: List[PreemptCandidate] = []
    slots = None
    priced_out = False
    for cand in avail:
        if total + cand.displacement_cost >= fresh:
            priced_out = True
            continue
        bi = cand.bin_index
        undo.append((cand, list(free_state[bi]),
                     None if occ_state is None or occ_state[bi] is None
                     else occ_state[bi].copy()))
        for r in range(NUM_RESOURCES):
            free_state[bi][r] += cand.refund[r]
        if occ_state is not None and occ_state[bi] is not None:
            occ_state[bi][cand.cells] = False
        cand.taken = True
        total += cand.displacement_cost
        chosen.append(cand)
        slots = verify_and_commit_gang(enc, e.index, free_state, occ_state, carves,
                                       bin_limit=bin_limit)
        plan.verified += 1
        if slots is not None:
            break
    if slots is None:
        # newest first: when two victims share a bin the later snapshot
        # already holds the earlier refund, so forward order would keep it
        for cand, freev, occv in reversed(undo):
            free_state[cand.bin_index] = freev
            if occ_state is not None and occv is not None:
                occ_state[cand.bin_index] = occv
            cand.taken = False
        _decline("fresh-cheaper" if priced_out and not chosen else "unplaceable")
        return None
    plan.preemptions.extend((e, c) for c in chosen)
    return slots
