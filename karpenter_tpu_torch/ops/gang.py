"""Gang co-pack window encoding: G gangs × B candidate bins as one tensor.

A copy of the JAX package's ``ops/gang.py``. The batched what-if pattern
(ops/whatif.py) applied to provisioning-side gangs: a window holds G
all-or-nothing pod groups; each gang is one independent sub-solve, the
first fit of its members into a shared pool of *prospective* nodes (bins),
and all G sub-solves run as one launch of the what-if kernel
(solver/gang.py, B10). Where a what-if candidate excludes its own bin, a
gang has none (its nodes do not exist yet), so its own bin is -1; each
gang first-fits into a private copy of the pool, so an unplaceable gang
perturbs nothing.

Bins are prospective nodes. For each gang the encoder adds enough empty
nodes of its *cheapest* feasible instance type (by catalog price) to host
the whole gang alone; the pool is shared, so a gang may also land in the
leftover space of another gang's compatible bins. ``compat[g, b]`` is the
gang's group feasibility column (ops/feasibility.gang_feasibility_mask)
indexed by bin type.

The device result is a FILTER. Every gang the device calls feasible is
re-verified member by member on exact host nano ints against the window's
running pool state (:func:`verify_and_commit_gang`) before any bind.

All integers are nano units GCD-scaled to int32 (whatif._gcd_scale_signed);
scaling divides by a common factor, so device comparisons are exact. A
window that cannot be scaled into int32, or whose padded cells pass
``MAX_WINDOW_CELLS``, carries no device tensors and is answered by
:func:`host_gang`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.ops.topology import encode_carve, first_carve, grid_cells
from karpenter_tpu_torch.ops.whatif import (
    MAX_WINDOW_CELLS, _gcd_scale_signed, _pow2, _reserve_vec,
)
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES

Vec = Tuple[int, ...]

_LOCK = threading.Lock()
# bins a carve walk rejected since the count was last set to 0: resources
# fit, but the free chips form no contiguous slice (the phantom capacity a
# shape-only gate would admit); once per bin per walk
CARVE_REJECTS = 0


@dataclass
class GangBin:
    """One candidate node of the window pool. Prospective bins (the
    default) are empty instances of ``type_index`` whose free vector is
    the type's allocatable after overhead and daemons; SEED bins
    (``node_name`` set) are real partly occupied nodes re-offered by the
    occupancy ledger: placing there binds to the existing node.
    ``grid``/``occ`` carry the type's torus dimensions and the bin's
    occupancy plane when carving is on (ops/topology.py)."""

    name: str
    type_index: int
    free: List[int]
    grid: Optional[Tuple[int, ...]] = None
    occ: Optional[np.ndarray] = None        # (cells,) bool
    node_name: Optional[str] = None         # existing node; None = fresh


@dataclass
class EncodedGang:
    """One gang's host-side view inside a window."""

    index: int
    key: Any                      # gang identity (namespace, name)
    pods: List[Pod]
    vecs: List[Vec]               # reserve vectors, sorted desc (cpu, mem)
    type_mask: np.ndarray         # (T,) group feasibility over instance types
    context: Any = None           # caller payload (Schedule), carried through
    slice_dims: Optional[Tuple[int, ...]] = None  # declared slice grid
    band: str = "default"         # pressure band (preemption ordering)
    # $/h of the fresh node(s) the cheapest feasible type would cost this
    # gang alone, the preemption price comparator; None = no fresh
    # capacity possible (displacement is then the only path)
    fresh_cost: Optional[float] = None


@dataclass
class GangEncoding:
    """Host and padded device-side arrays of one gang co-pack window."""

    gangs: List[EncodedGang]
    bins: List[GangBin]
    compat: np.ndarray            # (G, B) bool: gang may use bin
    g: int
    k: int                        # max members over gangs
    b: int
    # padded, scaled arrays (None when the window did not encode: beyond
    # int32 or MAX_WINDOW_CELLS, or empty)
    d_pods: Optional[np.ndarray] = None     # (GB, KB, R) int32, scaled
    d_valid: Optional[np.ndarray] = None    # (GB, KB) bool
    d_compat: Optional[np.ndarray] = None   # (GB, BB) bool
    d_free0: Optional[np.ndarray] = None    # (BB, R) int32, scaled
    scales: Optional[Tuple[int, ...]] = None
    skipped: List[Tuple[Any, str]] = field(default_factory=list)
    # carve arrays when any gang declares a slice (ops/topology.py); None =
    # a carve-neutral window, exactly the shape-only encoding
    carve: Optional[Any] = None

    @property
    def device_ready(self) -> bool:
        return self.d_pods is not None

    @property
    def cells(self) -> int:
        if self.d_pods is None:
            return 0
        gb, kb, _ = self.d_pods.shape
        return gb * kb * self.d_compat.shape[1]


def _nodes_needed(vecs: Sequence[Vec], free: Sequence[int]) -> Optional[int]:
    """First-fit node count for one gang alone on unlimited empty bins with
    this free vector; None when some member overflows even an empty bin."""
    opened: List[List[int]] = []
    for vec in vecs:
        if any(vec[r] > free[r] for r in range(NUM_RESOURCES)):
            return None
        for node in opened:
            if all(node[r] >= vec[r] for r in range(NUM_RESOURCES)):
                for r in range(NUM_RESOURCES):
                    node[r] -= vec[r]
                break
        else:
            node = list(free)
            for r in range(NUM_RESOURCES):
                node[r] -= vec[r]
            opened.append(node)
    return len(opened)


def encode_gang_window(
    gangs: Sequence[Tuple[Any, Sequence[Pod], np.ndarray, Any]],
    type_frees: Sequence[Optional[Sequence[int]]],
    type_prices: Sequence[float],
    type_names: Sequence[str],
    max_cells: int = MAX_WINDOW_CELLS,
    max_bins: int = 4096,
    slices: Optional[Sequence[Optional[Tuple[int, ...]]]] = None,
    bands: Optional[Sequence[str]] = None,
    type_grids: Optional[Sequence[Optional[Tuple[int, ...]]]] = None,
    seed_bins: Optional[Sequence[GangBin]] = None,
    grow: bool = True,
) -> GangEncoding:
    """Encode one window.

    ``gangs``: (key, pods, type_mask, context) per gang, in window priority
    order. ``type_frees[t]`` is type t's empty-node free vector (nano,
    after overhead and daemons) or None when the type cannot even boot. A
    gang with no viable type is recorded in ``skipped`` with a reason and
    left out of the arrays.

    Carving (all optional; omitted, the window is exactly the shape-only
    encoding): ``slices[i]``/``bands[i]`` annotate gang i with its declared
    slice grid and pressure band; ``type_grids[t]`` is type t's torus
    dimensions; ``seed_bins`` are real partly occupied nodes from the
    occupancy ledger, entering the pool FIRST so first fit reuses live
    fragmented capacity before opening fresh nodes. ``grow=False`` adds no
    fresh bins at all (saturated-pool cases)."""
    encoded: List[EncodedGang] = []
    bins: List[GangBin] = list(seed_bins or [])
    skipped: List[Tuple[Any, str]] = []
    bins_per_type: dict = {}  # type_index → bins already added

    for gi, (key, pods, type_mask, context) in enumerate(gangs):
        # sort members desc (cpu, mem) keeping the pod association: slots[i]
        # names the bin for pods[i] all the way through bind
        pairs = sorted(((_reserve_vec(p), p) for p in pods),
                       key=lambda t: (-t[0][0], -t[0][1]))
        vecs = [v for v, _ in pairs]
        pods = [p for _, p in pairs]
        viable = [t for t in np.flatnonzero(np.asarray(type_mask))
                  if type_frees[t] is not None]
        if not viable:
            skipped.append((key, "no feasible instance type"))
            continue
        # cheapest first: the gang's bins come from its cheapest type that
        # can host it alone; ties broken by name keep runs deterministic
        viable.sort(key=lambda t: (type_prices[t], type_names[t]))
        need, chosen = None, None
        for t in viable:
            need = _nodes_needed(vecs, type_frees[t])
            if need is not None:
                chosen = t
                break
        if chosen is None and grow:
            skipped.append((key, "members exceed every feasible type"))
            continue
        if chosen is not None and grow:
            # grow the shared pool so this gang could place alone on its
            # chosen type even after earlier gangs consumed their replicas
            have = bins_per_type.get(chosen, 0)
            for i in range(need):
                bins.append(GangBin(
                    name=f"{type_names[chosen]}~{have + i}", type_index=chosen,
                    free=list(type_frees[chosen]),
                    grid=type_grids[chosen] if type_grids is not None else None))
            bins_per_type[chosen] = have + need
        encoded.append(EncodedGang(
            index=len(encoded), key=key, pods=list(pods), vecs=vecs,
            type_mask=np.asarray(type_mask, bool), context=context,
            slice_dims=(tuple(slices[gi]) if slices is not None
                        and slices[gi] is not None else None),
            band=bands[gi] if bands is not None else "default",
            fresh_cost=type_prices[chosen] * need if chosen is not None else None))
        if len(bins) > max_bins:
            break

    g, b = len(encoded), len(bins)
    k = max((len(e.vecs) for e in encoded), default=0)
    enc = GangEncoding(gangs=encoded, bins=bins, compat=np.zeros((g, b), bool),
                       g=g, k=k, b=b, skipped=skipped)
    if g == 0 or b == 0 or k == 0:
        return enc
    bin_types = np.array([bn.type_index for bn in bins], np.int64)
    for e in encoded:
        enc.compat[e.index] = e.type_mask[bin_types]

    # GCD-scale every column that meets the comparator (the what-if contract)
    cols = [[bn.free[r] for bn in bins] for r in range(NUM_RESOURCES)]
    for r in range(NUM_RESOURCES):
        cols[r].extend(v[r] for e in encoded for v in e.vecs)
    scales = _gcd_scale_signed(cols)
    if scales is None:
        return _attach_carve(enc)  # int32 overflow: host path only
    gb, kb, bb = _pow2(g), _pow2(k), _pow2(b)
    if gb * kb * bb > max_cells:
        return _attach_carve(enc)
    d_pods = np.zeros((gb, kb, NUM_RESOURCES), np.int32)
    d_valid = np.zeros((gb, kb), bool)
    d_compat = np.zeros((gb, bb), bool)
    d_free0 = np.zeros((bb, NUM_RESOURCES), np.int32)
    for bi, bn in enumerate(bins):
        for r in range(NUM_RESOURCES):
            d_free0[bi, r] = bn.free[r] // scales[r]
    for e in encoded:
        for ki, vec in enumerate(e.vecs):
            for r in range(NUM_RESOURCES):
                d_pods[e.index, ki, r] = vec[r] // scales[r]
            d_valid[e.index, ki] = True
        d_compat[e.index, :b] = enc.compat[e.index]
    enc.d_pods, enc.d_valid, enc.d_compat, enc.d_free0 = d_pods, d_valid, d_compat, d_free0
    enc.scales = scales
    return _attach_carve(enc)


def _attach_carve(enc: GangEncoding) -> GangEncoding:
    """The carve arrays when any gang declares a slice, padded to the gang
    window's own device axes so the (GB, BB) carve verdict ANDs straight
    into ``d_compat`` on the device."""
    gb = enc.d_compat.shape[0] if enc.d_compat is not None else None
    bb = enc.d_compat.shape[1] if enc.d_compat is not None else None
    enc.carve = encode_carve(enc, gb=gb, bb=bb)
    return enc


def host_gang(enc: GangEncoding, carve_ok: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host answer of a window: per gang, first-fit its members into
    a PRIVATE copy of the full pool. Returns (feasible (G,), slots (G, K))
    with -1 for unplaced and padded members, on nano ints without scaling.
    ``carve_ok`` ((G, B) bool) ANDs into compat first, as the device path
    composes the carve verdict. Unlike the kernel, it stops at a gang's
    first member that fits nowhere and gives that gang's slots all -1."""
    feasible = np.zeros(enc.g, bool)
    slots = np.full((enc.g, enc.k), -1, np.int64)
    compat = enc.compat if carve_ok is None else (enc.compat & carve_ok)
    for e in enc.gangs:
        free = [list(bn.free) for bn in enc.bins]
        ok = True
        for ki, vec in enumerate(e.vecs):
            placed = False
            for bi in range(enc.b):
                if not compat[e.index, bi]:
                    continue
                if all(free[bi][r] >= vec[r] for r in range(NUM_RESOURCES)):
                    for r in range(NUM_RESOURCES):
                        free[bi][r] -= vec[r]
                    slots[e.index, ki] = bi
                    placed = True
                    break
            if not placed:
                ok = False
                break
        feasible[e.index] = ok
        if not ok:
            slots[e.index, :] = -1
    return feasible, slots


def verify_and_commit_gang(
    enc: GangEncoding,
    gang_index: int,
    free_state: List[List[int]],
    occ_state: Optional[List[Optional[np.ndarray]]] = None,
    carves_out: Optional[dict] = None,
    bin_limit: Optional[int] = None,
) -> Optional[List[int]]:
    """Exact host re-verification of one gang against the window's RUNNING
    pool state: first-fit every member on nano ints into a trial copy;
    commit the trial (mutating ``free_state``) only when every member
    lands. Returns the member→bin assignment, or None (state untouched).
    This is the only path to a gang bind.

    Carving (``occ_state`` set, per-bin running occupancy planes, None for
    gridless bins): a slice gang must also carve ONE contiguous torus
    sub-grid of its declared shape on every bin it touches, verified CELL
    BY CELL by :func:`ops.topology.first_carve` against the running
    plane. A bin whose resources fit but whose free chips form no
    contiguous sub-grid is REJECTED (counted once per bin per walk in
    :data:`CARVE_REJECTS`). Committed cells land in
    ``carves_out[bin] = cells`` and the planes advance with the pool.

    ``bin_limit`` restricts the walk to ``bins[:bin_limit]``, the seed
    (real node) prefix, so the planner can price live capacity and
    preemption before opening fresh nodes."""
    global CARVE_REJECTS
    e = enc.gangs[gang_index]
    carve_mode = occ_state is not None and e.slice_dims is not None
    trial: dict = {}  # copy on write: only touched bins are copied
    trial_occ: dict = {}
    trial_carve: dict = {}
    # a bin's occupancy only changes within this walk by the gang's own
    # carve, so a failed first_carve stays failed: later members skip it
    carve_rejected: set = set()
    slots: List[int] = []
    b_max = enc.b if bin_limit is None else min(bin_limit, enc.b)
    # the gang's compatible bins in order, once: the walk below visits only
    # these, in the same order, so it takes the same first fit
    usable = np.flatnonzero(enc.compat[gang_index, :b_max]).tolist()
    for vec in e.vecs:
        placed = False
        v0 = vec[0]
        for bi in usable:
            free = trial.get(bi)
            if free is None:
                free = free_state[bi]
            # cpu first: a full bin fails here without the generator
            if free[0] < v0 or not all(free[r] >= vec[r] for r in range(NUM_RESOURCES)):
                continue
            if carve_mode and bi not in trial_carve:
                if bi in carve_rejected:
                    continue
                # first member landing on this bin: the whole gang shares
                # one carve of the declared shape here
                grid = enc.bins[bi].grid
                if grid is None:
                    continue  # cannot model contiguity: unsafe for slices
                occ = trial_occ.get(bi)
                if occ is None:
                    occ = occ_state[bi]
                    if occ is None:
                        occ = np.zeros(grid_cells(grid), bool)
                cells = first_carve(occ, grid, e.slice_dims)
                if cells is None:
                    carve_rejected.add(bi)
                    with _LOCK:
                        CARVE_REJECTS += 1
                    continue  # resources fit, chips do not: phantom
                work_occ = trial_occ.get(bi)
                if work_occ is None:
                    base = occ_state[bi]
                    work_occ = trial_occ[bi] = (
                        base.copy() if base is not None else np.zeros(grid_cells(grid), bool))
                work_occ[list(cells)] = True
                trial_carve[bi] = cells
            work = trial.get(bi)
            if work is None:
                work = trial[bi] = list(free_state[bi])
            for r in range(NUM_RESOURCES):
                work[r] -= vec[r]
            slots.append(bi)
            placed = True
            break
        if not placed:
            return None
    for bi, work in trial.items():
        free_state[bi] = work
    if carve_mode:
        for bi, occ in trial_occ.items():
            occ_state[bi] = occ
        if carves_out is not None:
            carves_out.update(trial_carve)
    return slots
