"""Torus-grid slice carving: occupancy planes, placement masks and the ledger.

A copy of the JAX package's ``ops/topology.py``. Shape containment
(api/gang.py ``slice_fits``) says a v5e-4x8 *could* host a v5e-4x4 gang,
but not whether the chips still free on a partly occupied pod form a
contiguous sub-grid. This module models each multi-host pod as a 2-D or
3-D **torus** chip grid (every axis wraps, so a carve may wrap around any
axis) and encodes, per gang window:

- per-bin occupancy planes: one bool per flattened grid cell;
- per (slice shape, host grid) the placement-mask bank: every distinct
  (origin × orientation) carve as a (P, C) bool matrix, duplicate cell
  sets removed (symmetric orientations, full-axis wraps);
- the window tensors the carve program (solver/topology.py, B11) scans:
  gang g is carve-feasible on bin b iff some placement row has no overlap
  with b's occupancy plane.

The program's verdict is a FILTER: every accepted carve is re-verified
cell by cell by the scalar oracle :func:`first_carve` against the window's
RUNNING occupancy before anything commits (ops/gang.verify_and_commit_gang).
Occupancy only grows during a window walk, so carve-infeasible at the
initial planes implies carve-infeasible later and skipping is sound.

:class:`OccupancyLedger` is the process-wide registry of committed carves
on real nodes (:data:`LEDGER`): it feeds partly occupied pods back into
the next window as seed bins and names the residents preemption may
displace; every change republishes the JAX package's
``karpenter_topology_ledger_nodes`` gauge. Each record carries the id of
the long-lived ``carve`` intent that makes it durable
(``CarveRecord.intent_id``); startup recovery rebuilds the ledger from the
open carve intents, re-tupling their JSON signatures with
:func:`sig_from_json`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from functools import lru_cache
from itertools import permutations, product
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.metrics.topology import TOPOLOGY_LEDGER_NODES
from karpenter_tpu_torch.ops.whatif import _pow2

Dims = Tuple[int, ...]


def grid_cells(dims: Sequence[int]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


@lru_cache(maxsize=1024)
def orientations(slice_dims: Dims, ndim: int) -> Tuple[Dims, ...]:
    """Distinct axis assignments of the slice grid on an ``ndim``-axis
    host: unit dims dropped, the rest padded with 1s to the host rank,
    every distinct permutation, sorted for determinism. Empty when the
    slice has more non-unit axes than the host has axes."""
    dims = tuple(d for d in slice_dims if d > 1)
    if len(dims) > ndim:
        return ()
    dims = dims + (1,) * (ndim - len(dims))
    return tuple(sorted(set(permutations(dims))))


def _strides(host_dims: Dims) -> List[int]:
    """Row-major flat strides of the host grid."""
    strides, s = [], 1
    for d in reversed(host_dims):
        strides.append(s)
        s *= d
    return strides[::-1]


@lru_cache(maxsize=512)
def placement_masks(host_dims: Dims, slice_dims: Dims) -> Optional[np.ndarray]:
    """(P, C) bool: every distinct torus carve of ``slice_dims`` on
    ``host_dims``, each orientation × each origin, wrapping along every
    axis, cells flattened row-major. Duplicate cell sets collapse to one
    row. None when no orientation fits at all."""
    cells = grid_cells(host_dims)
    strides = _strides(host_dims)
    masks: List[np.ndarray] = []
    seen: set = set()
    for orient in orientations(tuple(slice_dims), len(host_dims)):
        if any(o > h for o, h in zip(orient, host_dims)):
            continue
        for origin in product(*(range(d) for d in host_dims)):
            flat = np.zeros(1, np.int64)
            for ax, (o, d, st) in enumerate(zip(orient, host_dims, strides)):
                offs = ((origin[ax] + np.arange(o)) % d) * st
                flat = (flat[:, None] + offs[None, :]).ravel()
            mask = np.zeros(cells, bool)
            mask[flat] = True
            key = mask.tobytes()
            if key not in seen:
                seen.add(key)
                masks.append(mask)
    if not masks:
        return None
    out = np.stack(masks)
    out.setflags(write=False)
    return out


def first_carve(occ, host_dims: Sequence[int],
                slice_dims: Sequence[int]) -> Optional[Tuple[int, ...]]:
    """Scalar oracle: the first feasible carve of ``slice_dims`` on a host
    torus whose occupied cells are ``occ`` (bool array over flat cells, or
    any container of flat indices), walking orientations then origins in a
    fixed order and testing CELL BY CELL. Returns the covered flat cells,
    sorted, or None. Independent of the mask bank on purpose: it is the
    probe, self-heal and commit-time oracle."""
    host_dims = tuple(host_dims)
    ndim = len(host_dims)
    if isinstance(occ, np.ndarray):
        occupied = set(int(i) for i in np.flatnonzero(occ))
    else:
        occupied = set(int(i) for i in occ)
    strides = _strides(host_dims)
    for orient in orientations(tuple(slice_dims), ndim):
        if any(o > h for o, h in zip(orient, host_dims)):
            continue
        for origin in product(*(range(d) for d in host_dims)):
            covered: List[int] = []
            ok = True
            for rel in product(*(range(o) for o in orient)):
                ci = 0
                for ax in range(ndim):
                    ci += ((origin[ax] + rel[ax]) % host_dims[ax]) * strides[ax]
                if ci in occupied:
                    ok = False
                    break
                covered.append(ci)
            if ok:
                return tuple(sorted(covered))
    return None


def constraints_sig(labels: Optional[dict], taints: Optional[Sequence]) -> tuple:
    """Structural signature of the (labels, taints) a gang node was created
    with. A ledger node is only offered back to schedules whose constraints
    give the same signature."""
    lab = tuple(sorted((labels or {}).items()))
    tnt = tuple(sorted(
        (getattr(t, "key", ""), getattr(t, "value", "") or "",
         getattr(t, "effect", "") or "") for t in (taints or [])))
    return (lab, tnt)


def sig_from_json(obj):
    """Re-tuple a constraints signature that round-tripped through the
    intent journal (JSON turns the nested tuples into lists). Recovery must
    restore the exact tuple shape, or the rebuilt ledger's nodes would
    never match a window's ``constraints_sig`` and stop being seed bins."""
    if isinstance(obj, (list, tuple)):
        return tuple(sig_from_json(x) for x in obj)
    return obj


# -- the process occupancy ledger -----------------------------------------

@dataclass
class CarveRecord:
    """One committed carve: a gang's contiguous cell set on one node."""

    gang_key: Any
    cells: np.ndarray            # flat cell indices held on the node
    band: str
    pods: List[Tuple[str, str]]  # (namespace, name) of the members here
    # the write-ahead carve intent backing this record ("" with no journal):
    # every release seam (preemption, unwind, termination, prune) closes
    # the durable half through it
    intent_id: str = ""


@dataclass
class NodeGrid:
    """One real node's torus state in the ledger."""

    node: str
    dims: Dims
    type_name: str
    labels_sig: tuple
    occ: np.ndarray              # (C,) bool occupancy plane
    carves: Dict[Any, CarveRecord] = field(default_factory=dict)


class OccupancyLedger:
    """Process-wide registry of committed carves per real node.

    Written by the provisioning controller after every bound slice gang;
    read at window-encode time to seed partly occupied pods back into the
    bin pool and to enumerate preemption victims. ``prune(live)`` drops
    nodes the cluster no longer has (the controller calls it every gang
    window); the termination controller drops a terminated node at once
    (``pop_node``). The in-memory state is the cache; the durable half is
    the journal's open ``carve`` intents, and every seam that removes a
    record returns it so the caller can close its intent."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: Dict[str, NodeGrid] = {}

    def commit(self, node: str, dims: Sequence[int], type_name: str,
               labels_sig: tuple, gang_key: Any, cells: Sequence[int],
               band: str, pods: Sequence[Tuple[str, str]], intent_id: str = "") -> None:
        with self._lock:
            ng = self._nodes.get(node)
            if ng is None or tuple(ng.dims) != tuple(dims):
                ng = NodeGrid(node=node, dims=tuple(dims), type_name=type_name,
                              labels_sig=labels_sig, occ=np.zeros(grid_cells(dims), bool))
                self._nodes[node] = ng
            idx = np.asarray(list(cells), np.int64)
            ng.occ[idx] = True
            ng.carves[gang_key] = CarveRecord(gang_key=gang_key, cells=idx, band=band,
                                              pods=list(pods), intent_id=intent_id)
        self._gauge()

    def pop_gang(self, gang_key: Any) -> List[Tuple[str, CarveRecord]]:
        """Free every cell the gang holds anywhere; empty nodes drop out.
        Returns the removed ``(node, record)`` pairs, whose intent ids the
        caller closes in the journal."""
        removed: List[Tuple[str, CarveRecord]] = []
        with self._lock:
            for name in list(self._nodes):
                ng = self._nodes[name]
                rec = ng.carves.pop(gang_key, None)
                if rec is None:
                    continue
                ng.occ[rec.cells] = False
                removed.append((name, rec))
                if not ng.carves:
                    del self._nodes[name]
        if removed:
            self._gauge()
        return removed

    def pop_node(self, node: str) -> List[CarveRecord]:
        """Drop one node's grid entirely (termination) and return its carve
        records: a terminated node must stop being a seed bin."""
        with self._lock:
            ng = self._nodes.pop(node, None)
        self._gauge()
        return list(ng.carves.values()) if ng is not None else []

    def prune(self, live: Sequence[str]) -> List[CarveRecord]:
        """Drop nodes the cluster no longer has; returns the dropped carve
        records."""
        keep = set(live)
        dropped: List[CarveRecord] = []
        with self._lock:
            for name in [n for n in self._nodes if n not in keep]:
                dropped.extend(self._nodes[name].carves.values())
                del self._nodes[name]
        self._gauge()
        return dropped

    def snapshot(self) -> List[NodeGrid]:
        """Copies for a window encode: occupancy planes and carve records
        are copied so the walk never races a commit."""
        with self._lock:
            return [NodeGrid(
                node=ng.node, dims=ng.dims, type_name=ng.type_name,
                labels_sig=ng.labels_sig, occ=ng.occ.copy(),
                carves={k: CarveRecord(r.gang_key, r.cells.copy(), r.band, list(r.pods),
                                       r.intent_id)
                        for k, r in ng.carves.items()})
                for ng in self._nodes.values()]

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def reset(self) -> None:
        with self._lock:
            self._nodes.clear()
        self._gauge()

    def _gauge(self) -> None:
        TOPOLOGY_LEDGER_NODES.set(float(self.node_count()))


LEDGER = OccupancyLedger()


# -- window carve encoding -------------------------------------------------

@dataclass
class CarveEncoding:
    """Carve tensors of one gang window (host and padded views).

    Host grids and slice shapes are interned into classes, so the mask
    bank is (S, NC, P, C) instead of a per-(gang, bin) blowup:
    ``scls_of[g]`` names gang g's slice class (-1 = no slice, trivially
    feasible), ``cls_of[b]`` bin b's grid class (-1 = no grid, infeasible
    for any slice gang)."""

    classes: List[Dims]          # distinct host grids
    slice_classes: List[Dims]    # distinct slice shapes
    cls_of: np.ndarray           # (B,) int32
    scls_of: np.ndarray          # (G,) int32
    occ0: np.ndarray             # (B, C) bool, initial occupancy planes
    pmask: np.ndarray            # (S, NC, P, C) bool placement banks
    pvalid: np.ndarray           # (S, NC, P) bool real placement rows
    g: int
    b: int
    c: int
    p: int
    # padded views, aligned with the gang window's device axes (None when
    # the gang window itself has none)
    d_occ: Optional[np.ndarray] = None      # (BB, CB) bool
    d_cls: Optional[np.ndarray] = None      # (BB,) int32
    d_scls: Optional[np.ndarray] = None     # (GB,) int32
    d_pmask: Optional[np.ndarray] = None    # (SB, NCB, PB, CB) bool
    d_pvalid: Optional[np.ndarray] = None   # (SB, NCB, PB) bool

    @property
    def device_ready(self) -> bool:
        return self.d_occ is not None


def encode_carve(enc, gb: Optional[int] = None, bb: Optional[int] = None
                 ) -> Optional[CarveEncoding]:
    """The carve tensors of a gang window whose gangs and bins carry
    ``slice_dims`` / ``grid`` annotations (ops/gang.py). None when no gang
    declares a slice: the window is carve-neutral. ``gb``/``bb`` are the
    gang window's padded gang and bin axes, so the verdict aligns with
    ``d_compat``."""
    if not any(e.slice_dims is not None for e in enc.gangs):
        return None
    classes: List[Dims] = []
    cls_index: Dict[Dims, int] = {}
    cls_of = np.full(enc.b, -1, np.int32)
    for bi, bn in enumerate(enc.bins):
        if bn.grid is None:
            continue
        dims = tuple(bn.grid)
        if dims not in cls_index:
            cls_index[dims] = len(classes)
            classes.append(dims)
        cls_of[bi] = cls_index[dims]
    slice_classes: List[Dims] = []
    scls_index: Dict[Dims, int] = {}
    scls_of = np.full(enc.g, -1, np.int32)
    for e in enc.gangs:
        if e.slice_dims is None:
            continue
        dims = tuple(e.slice_dims)
        if dims not in scls_index:
            scls_index[dims] = len(slice_classes)
            slice_classes.append(dims)
        scls_of[e.index] = scls_index[dims]
    nc = max(len(classes), 1)
    c = max((grid_cells(d) for d in classes), default=1)
    banks: Dict[Tuple[int, int], np.ndarray] = {}
    p = 1
    for si, sd in enumerate(slice_classes):
        for ci, cd in enumerate(classes):
            bank = placement_masks(cd, sd)
            if bank is not None:
                banks[(si, ci)] = bank
                p = max(p, bank.shape[0])
    s = max(len(slice_classes), 1)
    pmask = np.zeros((s, nc, p, c), bool)
    pvalid = np.zeros((s, nc, p), bool)
    for (si, ci), bank in banks.items():
        pn, cn = bank.shape
        pmask[si, ci, :pn, :cn] = bank
        pvalid[si, ci, :pn] = True
    occ0 = np.zeros((max(enc.b, 1), c), bool)
    for bi, bn in enumerate(enc.bins):
        if bn.occ is not None:
            occ0[bi, :bn.occ.shape[0]] = bn.occ
    cv = CarveEncoding(classes=classes, slice_classes=slice_classes,
                       cls_of=cls_of, scls_of=scls_of, occ0=occ0,
                       pmask=pmask, pvalid=pvalid, g=enc.g, b=enc.b, c=c, p=p)
    if gb is not None and bb is not None:
        cb, pb = _pow2(c), _pow2(p)
        sb, ncb = _pow2(s), _pow2(nc)
        d_occ = np.zeros((bb, cb), bool)
        d_occ[:enc.b, :c] = occ0[:enc.b]
        d_cls = np.full(bb, -1, np.int32)
        d_cls[:enc.b] = cls_of
        d_scls = np.full(gb, -1, np.int32)
        d_scls[:enc.g] = scls_of
        d_pmask = np.zeros((sb, ncb, pb, cb), bool)
        d_pmask[:s, :nc, :p, :c] = pmask
        d_pvalid = np.zeros((sb, ncb, pb), bool)
        d_pvalid[:s, :nc, :p] = pvalid
        cv.d_occ, cv.d_cls, cv.d_scls = d_occ, d_cls, d_scls
        cv.d_pmask, cv.d_pvalid = d_pmask, d_pvalid
    return cv


def host_carve(cv: CarveEncoding) -> np.ndarray:
    """Numpy mirror of the carve program: (G, B) bool, True = some
    placement row of gang g's bank on bin b's grid class has no overlap
    with b's initial occupancy plane (or g has no slice)."""
    out = np.ones((cv.g, cv.b), bool)
    for gi in range(cv.g):
        si = int(cv.scls_of[gi])
        if si < 0:
            continue
        for bi in range(cv.b):
            ci = int(cv.cls_of[bi])
            if ci < 0:
                out[gi, bi] = False
                continue
            overlap = np.any(cv.pmask[si, ci] & cv.occ0[bi][None, :], axis=1)
            out[gi, bi] = bool(np.any(cv.pvalid[si, ci] & ~overlap))
    return out


def scalar_carve(enc) -> np.ndarray:
    """(G, B) carve feasibility from the scalar oracle alone: the answer
    when the program's verdict fails its probes. O(G·B) ``first_carve``
    calls."""
    out = np.ones((enc.g, enc.b), bool)
    for e in enc.gangs:
        if e.slice_dims is None:
            continue
        for bi, bn in enumerate(enc.bins):
            if bn.grid is None:
                out[e.index, bi] = False
                continue
            occ = bn.occ if bn.occ is not None else np.zeros(grid_cells(bn.grid), bool)
            out[e.index, bi] = first_carve(occ, bn.grid, e.slice_dims) is not None
    return out


def scalar_carve_cell(enc, gang_index: int, bin_index: int) -> bool:
    """One (gang, bin) cell of :func:`scalar_carve`: the probe oracle."""
    e = enc.gangs[gang_index]
    if e.slice_dims is None:
        return True
    bn = enc.bins[bin_index]
    if bn.grid is None:
        return False
    occ = bn.occ if bn.occ is not None else np.zeros(grid_cells(bn.grid), bool)
    return first_carve(occ, bn.grid, e.slice_dims) is not None
