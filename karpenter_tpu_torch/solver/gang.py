"""Batched gang co-pack solves (B10) on the gang kernel, and the planner.

The JAX package's ``solver/gang.py`` jits ``_gang_jit``: a vmap over the
gangs of a window of a first-fit scan over each gang's members into a
private copy of the shared prospective-node pool. A gang window here is
one launch of the hand-written gang kernel (``ops/gang_cuda.gang_scan``,
``csrc/gang.cu``) on the window's (GB, BB) compat rows, one a gang, and
the shared free0 rows. It computes what ``_gang_jit`` computes, slots
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

The planner's declined preemptions feed the JAX package's
``karpenter_preemption_declined_total`` (and :data:`DECLINES`, the same
counts as an attribute); dispatch is the retroactive ``gang-dispatch``
span and the fetch a ``gang-fetch`` span under the dispatching window's
context. The gangs split over the solver mesh as the JAX package's do
(parallel/mesh.py). Left out of the reference: ``GangConfig`` (its
``device_min_cells`` gate, the watchdog, the breaker), the DeviceRing,
and the host-mirror fallback on a device error.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.backend import to_device_int32
from karpenter_tpu_torch.metrics.topology import PREEMPTION_DECLINED_TOTAL
from karpenter_tpu_torch.obs import trace as obtrace
from karpenter_tpu_torch.ops.gang import (
    EncodedGang, GangEncoding, host_gang, verify_and_commit_gang)
from karpenter_tpu_torch.ops.gang_cuda import gang_scan
from karpenter_tpu_torch.ops.topology import grid_cells, host_carve, scalar_carve
from karpenter_tpu_torch.parallel.mesh import MeshLike, resolve_mesh, row_sharding
from karpenter_tpu_torch.pressure.bands import RANK
from karpenter_tpu_torch.solver import topology as topo_solver
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES
from karpenter_tpu_torch.solver.solve import record_executor

_LOCK = threading.Lock()
# preemption attempts the planner declined since the count was last
# cleared, by reason: "no-victim", "fresh-cheaper", "unplaceable"
DECLINES: Dict[str, int] = {}


def _decline(reason: str) -> None:
    PREEMPTION_DECLINED_TOTAL.inc(reason=reason)
    with _LOCK:
        DECLINES[reason] = DECLINES.get(reason, 0) + 1


@dataclass
class GangShard:
    """One shard of a gang window: its rows of the padded gangs, its
    device, the kernel's tensors as launched there (pods, valid, compat
    with the carve verdict ANDed in, free0), compat before the carve AND,
    the kernel's (feasible, slots) until fetched, and its CUDA events
    (before the carve, before the kernel, after it; None on the CPU)."""

    rows: slice
    device: torch.device
    inputs: tuple
    compat0: torch.Tensor
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    events: Optional[tuple] = None


@dataclass
class GangHandle:
    """In-flight half of a gang window solve; ``fetch()`` blocks until the
    device has answered and is idempotent."""

    enc: GangEncoding
    device: torch.device
    # the window's shards in gang order; empty for a host answer. Kept
    # past fetch (their inputs) for checks that hold the answer against
    # the plain version.
    shards: List[GangShard] = field(default_factory=list)
    _carve: Optional[torch.Tensor] = None    # (GB, BB) carve verdict on the first device
    _result: Optional[Tuple[np.ndarray, np.ndarray, str]] = None
    # CUDA-event ms of the carve program and of the kernel launch (the
    # longest over the shards), once fetched (None on the CPU or for a
    # host answer)
    carve_ms: Optional[float] = None
    kernel_ms: Optional[float] = None
    healed: bool = False
    # the dispatching window's span context, re-entered at fetch
    _trace_ctx: Optional[object] = None

    @property
    def inputs(self) -> Optional[tuple]:
        """The kernel's padded gang tensors as launched (pods, valid,
        compat with the carve verdict ANDed in, free0): a one-shard
        window's own, a sharded window's gathered on its first device in
        gang order; None for a host answer."""
        if not self.shards:
            return None
        if len(self.shards) == 1:
            return self.shards[0].inputs
        dev = self.device
        rows = [torch.cat([sh.inputs[i].to(dev) for sh in self.shards]) for i in range(3)]
        return (*rows, self.shards[0].inputs[3].to(dev))

    def fetch(self) -> Tuple[np.ndarray, np.ndarray, str]:
        """(feasible (G,), slots (G, K) bin index or -1, executor)."""
        if self._result is not None:
            return self._result
        with obtrace.use_context(self._trace_ctx), \
                obtrace.span("gang-fetch", gangs=self.enc.g):
            self._result = self._fetch()
        return self._result

    def _fetch(self) -> Tuple[np.ndarray, np.ndarray, str]:
        enc = self.enc
        if not self.shards:
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
            # one device→host copy of each output a shard, gathered in
            # gang order
            feas = np.concatenate([sh.out[0].cpu().numpy() for sh in self.shards])[:enc.g]
            slots = np.concatenate([sh.out[1].cpu().numpy() for sh in self.shards]
                                   )[:enc.g, :max(enc.k, 1)]
            if self.shards[0].events is not None:
                start, mid, _ = self.shards[0].events
                self.carve_ms = start.elapsed_time(mid) if self._carve is not None else None
                self.kernel_ms = max(m.elapsed_time(e) for _, m, e in
                                     (sh.events for sh in self.shards))
            executor = "device-gang"
            self._carve = None
            for sh in self.shards:
                sh.out = sh.events = None
        record_executor(executor, count=max(enc.g, 1))
        return feas, slots, executor

    def _relaunch(self, trusted: np.ndarray) -> None:
        """A failed probe condemned the carve verdict: launch the kernel
        again on every shard, on compat AND the scalar verdict (padded
        rows and bins unchanged)."""
        self.healed = True
        GB = sum(sh.compat0.shape[0] for sh in self.shards)
        padded = np.ones((GB, self.shards[0].compat0.shape[1]), bool)
        padded[:trusted.shape[0], :trusted.shape[1]] = trusted
        for sh in self.shards:
            pods, valid, _, free0 = sh.inputs
            carve, = to_device_int32([padded[sh.rows]], sh.device)
            sh.inputs = (pods, valid, sh.compat0 & (carve != 0), free0)
            sh.out = gang_scan(*sh.inputs)
            sh.events = None


def dispatch_gang_window(enc: GangEncoding, device: MeshLike = None) -> GangHandle:
    """Launch the window over the mesh ``device`` resolves to
    (parallel/mesh.resolve_mesh; default: the solver mesh of every CUDA
    device; raises without one; ``"cpu"`` runs the plain versions) without
    waiting: the gangs split into one range a shard when their padded
    count divides by the mesh size, else all on the mesh's first device,
    ``free0`` copied to each shard's device. The carve program runs once,
    on the first shard's device (the JAX package replicates it), and each
    shard ANDs its rows of the verdict into its compat. Each shard's
    launch and its events run on its device's current stream. A window the
    encoding could not give the device is answered by ``host_gang`` at
    fetch."""
    mesh = resolve_mesh(device)
    handle = GangHandle(enc=enc, device=mesh[0], _trace_ctx=obtrace.current_context())
    if not enc.device_ready:
        return handle
    t0 = time.perf_counter()
    cv = enc.carve
    for sh in row_sharding(enc.d_pods.shape[0], mesh):
        dev = sh.device
        arrays = [enc.d_pods[sh.rows], enc.d_valid[sh.rows], enc.d_compat[sh.rows],
                  enc.d_free0]
        if cv is not None and sh.index == 0:
            # the first shard's rows and the carve arrays in one copy
            arrays += topo_solver.carve_arrays(cv)
        tensors = to_device_int32(arrays, dev)
        pods, valid, compat0, free0 = tensors[:4]
        valid, compat0 = valid != 0, compat0 != 0
        events = None
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(3))
            events[0].record(stream)
        compat = compat0
        if cv is not None:
            if sh.index == 0:
                # the carve verdict feeds the first fit in the same stream:
                # the scan only ever sees carve-feasible bins
                handle._carve = topo_solver.carve_program(*tensors[4:])
            compat = compat0 & handle._carve[sh.rows].to(dev)
        if events is not None:
            events[1].record(stream)
        inputs = (pods, valid, compat, free0)
        out = gang_scan(*inputs)
        if events is not None:
            events[2].record(stream)
        handle.shards.append(GangShard(sh.rows, dev, inputs, compat0, out, events))
    obtrace.add_span("gang-dispatch", t0, time.perf_counter(), gangs=enc.g)
    return handle


def solve_gang_window(enc: GangEncoding, device: MeshLike = None
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
