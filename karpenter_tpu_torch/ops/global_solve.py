"""Whole-window global-solve encoding and the exact integer gates.

The provisioning window packs each schedule greedily (FFD per schedule);
with a priced catalog the cheapest fleet is not always the per-schedule
greedy one. This module encodes every schedule of a window (its distinct
pod shapes against its viable, priced instance types) into one batched
float32 problem for the relaxation program in solver/global_solve.py, and
supplies the exact integer arithmetic that decides what leaves the solve:

- :func:`price_micro` truncates $/h to int micro-$, saturating at INT32_MAX,
  so "strictly cheaper" is decided in exact integers, never in float;
- :func:`plan_cost_micro` charges a host plan its cheapest option per node
  in Python ints;
- :func:`verify_plan` replays every node of a candidate plan through fresh
  host Packable reservations (exact nano ints) and checks that every pod
  appears exactly once.

Shapes and capacities are normalized per resource and per schedule for the
gradient program only; nothing float decides acceptance. The warm start of
the assignment, a (B, SB, TB) array, is not built here: the program builds
it on its device from the counts and ``d_types`` (solver/global_solve.py
``warm_start``), so it never crosses the host→device link.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES, HostSolveResult, Packable

# int32 saturation ceiling of the micro-$ price domain
SAT_MICRO = 2 ** 31 - 1


def price_micro(p: float) -> int:
    """$/h → int micro-$/h: finite prices truncate, saturating at
    INT32_MAX; inf (no viable offering) saturates outright."""
    if p != float("inf"):
        return min(int(p * 1e6), SAT_MICRO)
    return SAT_MICRO


def plan_cost_micro(result: HostSolveResult, prices_micro: Sequence[int]) -> int:
    """Exact integer cost of a host plan in micro-$/h, charging each node
    its cheapest option. Python ints: no overflow, no rounding."""
    total = 0
    for p in result.packings:
        total += min(prices_micro[j] for j in p.instance_type_indices) * p.node_quantity
    return total


def verify_plan(pod_vecs: Dict[int, Sequence[int]],
                packables_by_index: Dict[int, Packable],
                result: HostSolveResult) -> bool:
    """Independent host re-verification of a candidate plan on exact nano
    ints: every node's pods must reserve onto a fresh copy of the node's
    chosen type (its first option, the type the rounding packed), and every
    input pod must appear exactly once across packings and unschedulable.
    Any failure rejects the whole plan."""
    seen: set = set()
    for packing in result.packings:
        if not packing.instance_type_indices:
            return False
        if len(packing.pod_ids) != packing.node_quantity:
            return False
        chosen = packables_by_index.get(packing.instance_type_indices[0])
        if chosen is None:
            return False
        for node in packing.pod_ids:
            fresh = chosen.copy()
            for pid in node:
                if pid in seen:
                    return False
                seen.add(pid)
                vec = pod_vecs.get(pid)
                if vec is None or not fresh.reserve_pod(vec):
                    return False
    for pid in result.unschedulable:
        if pid in seen:
            return False
        seen.add(pid)
    return seen == set(pod_vecs)


@dataclass
class GlobalScheduleEnc:
    """One schedule's slice of the window: the exact host problem (pods in
    descending order, viable packables, int micro-$ prices) and, when it
    joins the relaxation, its row in the batched tensors."""

    pos: int                       # position in the window's problem list
    reason: Optional[str] = None   # early decline (empty|window-cap|unpriced|unencodable)
    constraints: Optional[object] = None
    pod_vecs: list = field(default_factory=list)   # descending pack order
    pod_ids: list = field(default_factory=list)    # original pod positions
    pods: list = field(default_factory=list)       # Pod objects, input order
    packables: list = field(default_factory=list)
    sorted_types: list = field(default_factory=list)
    prices: list = field(default_factory=list)        # $/h per sorted type
    prices_micro: list = field(default_factory=list)  # int micro-$ per sorted type
    num_shapes: int = 0
    num_types: int = 0
    row: int = -1                  # row in the batched tensors (-1: none)


@dataclass
class GlobalWindowEncoding:
    """The window: per-schedule host problems and the batched, padded
    float32 arrays the program takes. ``b/sb/tb`` are the padded sizes."""

    scheds: List[GlobalScheduleEnc]
    b: int = 0
    sb: int = 0
    tb: int = 0
    d_shapes: Optional[np.ndarray] = None   # (B, SB, R) f32 normalized
    d_counts: Optional[np.ndarray] = None   # (B, SB)    f32
    d_caps: Optional[np.ndarray] = None     # (B, TB, R) f32 normalized
    d_prices: Optional[np.ndarray] = None   # (B, TB)    f32 in [0, 1]
    d_tmask: Optional[np.ndarray] = None    # (B, TB)    f32 validity
    d_n0: Optional[np.ndarray] = None       # (B, TB)    f32 warm start
    d_types: Optional[np.ndarray] = None    # (B,)       f32 types per row

    @property
    def live(self) -> List[GlobalScheduleEnc]:
        return [s for s in self.scheds if s.row >= 0]

    @property
    def cells(self) -> int:
        return self.b * self.sb * self.tb

    @property
    def device_ready(self) -> bool:
        return self.d_shapes is not None and self.b > 0


def _pow2(n: int, lo: int = 4) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def _schedule_tensors(enc_problem, obj_prices: Sequence[float]):
    """Per-schedule float32 normalization: shapes and capacities divided
    per resource, prices scaled into [0, 1], and the node-count warm start.
    Returns (shapes, counts, caps, prices, n0)."""
    S, T = enc_problem.num_shapes, enc_problem.num_types
    shapes = np.asarray(enc_problem.shapes[:S], dtype=np.float32)
    caps = np.asarray(enc_problem.totals[:T], dtype=np.float32)
    counts = np.asarray(enc_problem.counts[:S], dtype=np.float32)
    norm = np.maximum(np.maximum(shapes.max(axis=0, initial=1.0),
                                 caps.max(axis=0, initial=1.0)), 1.0)
    shapes, caps = shapes / norm, caps / norm
    prices = np.asarray(obj_prices, dtype=np.float32)
    pmax = float(prices.max()) or 1.0
    prices = prices / pmax
    need = np.einsum("s,sr->r", counts, shapes)
    denom = np.maximum(caps, 1e-6)
    n0 = (np.max(need[None, :] / denom, axis=1) / max(T, 1)).astype(np.float32)
    return shapes, counts, caps, prices, n0


def objective_prices(micro_by_packable: Sequence[int]) -> List[float]:
    """The objective's price per packable: its int micro-$, the numbers the
    exact comparison uses; an unpriced or saturated type keeps the
    saturated stand-in, so the objective pushes its node count to zero."""
    return [float(m) if 0 < m < SAT_MICRO else float(SAT_MICRO) for m in micro_by_packable]


def one_problem_window(enc_problem, obj_prices: Sequence[float]) -> GlobalWindowEncoding:
    """One encoded problem as an unpadded one-row window (B = 1, SB = S,
    TB = T, every type valid): the repack relaxation's program input."""
    shapes, counts, caps, prices, n0 = _schedule_tensors(enc_problem, obj_prices)
    S, T = enc_problem.num_shapes, enc_problem.num_types
    return GlobalWindowEncoding(
        scheds=[], b=1, sb=S, tb=T, d_shapes=shapes[None], d_counts=counts[None],
        d_caps=caps[None], d_prices=prices[None], d_tmask=np.ones((1, T), np.float32),
        d_n0=n0[None], d_types=np.array([T], np.float32))


def encode_window(problems: Sequence, cost_config,
                  max_schedules: int = 256) -> GlobalWindowEncoding:
    """A window's Problem list → the batched relaxation problem. Per
    schedule: viable packables and sorted catalog, descending pod order,
    exact int micro-$ prices. A schedule that cannot join the relaxation (no
    pods, no priced type, ints the encoder cannot hold) carries an early
    decline reason and no row: the caller's FFD result stands for it."""
    from karpenter_tpu_torch.models.cost import effective_price
    from karpenter_tpu_torch.ops.encode import encode
    from karpenter_tpu_torch.solver.adapter import (
        build_packables_cached, marshal_pods_interned,
    )

    scheds: List[GlobalScheduleEnc] = []
    rows: List[tuple] = []
    for pos, problem in enumerate(problems):
        s = GlobalScheduleEnc(pos=pos, pods=list(problem.pods),
                              constraints=problem.constraints)
        scheds.append(s)
        if not problem.pods or pos >= max_schedules:
            s.reason = "empty" if not problem.pods else "window-cap"
            continue
        pod_vecs, required, _ = marshal_pods_interned(problem.pods)
        packables, sorted_types = build_packables_cached(
            problem.instance_types, problem.constraints, problem.pods,
            problem.daemons, required=required)
        if not packables:
            s.reason = "empty"
            continue
        order = sorted(range(len(problem.pods)),
                       key=lambda i: (-pod_vecs[i][0], -pod_vecs[i][1]))
        prices = [effective_price(it, problem.constraints.requirements,
                                  cost_config)[0] for it in sorted_types]
        prices = [0.0 if p == float("inf") else p for p in prices]
        s.pod_vecs = [pod_vecs[i] for i in order]
        s.pod_ids = order
        s.packables = packables
        s.sorted_types = sorted_types
        s.prices = prices
        s.prices_micro = [price_micro(p) for p in prices]
        by_pos = [s.prices_micro[p.index] for p in packables]
        if not any(0 < m < SAT_MICRO for m in by_pos):
            s.reason = "unpriced"
            continue
        enc = encode(s.pod_vecs, s.pod_ids, packables, pad=False)
        if enc is None:
            s.reason = "unencodable"
            continue
        s.num_shapes, s.num_types = enc.num_shapes, enc.num_types
        s.row = len(rows)
        rows.append(_schedule_tensors(enc, objective_prices(by_pos)))

    win = GlobalWindowEncoding(scheds=scheds)
    if not rows:
        return win
    R = NUM_RESOURCES
    win.b = _pow2(len(rows), lo=1)
    win.sb = _pow2(max(sh.shape[0] for sh, *_ in rows))
    win.tb = _pow2(max(cp.shape[0] for _, _, cp, *_ in rows))
    B, SB, TB = win.b, win.sb, win.tb
    win.d_shapes = np.zeros((B, SB, R), np.float32)
    win.d_counts = np.zeros((B, SB), np.float32)
    win.d_caps = np.zeros((B, TB, R), np.float32)
    win.d_prices = np.ones((B, TB), np.float32)
    win.d_tmask = np.zeros((B, TB), np.float32)
    win.d_n0 = np.zeros((B, TB), np.float32)
    win.d_types = np.zeros((B,), np.float32)
    for i, (shapes, counts, caps, prices, n0) in enumerate(rows):
        S, T = shapes.shape[0], caps.shape[0]
        win.d_shapes[i, :S] = shapes
        win.d_counts[i, :S] = counts
        win.d_caps[i, :T] = caps
        win.d_prices[i, :T] = prices
        win.d_tmask[i, :T] = 1.0
        win.d_n0[i, :T] = n0
        win.d_types[i] = T
    return win


#: the hand-tuned strict and widened keep-rule corners the adaptive
#: controller interpolates between (absolute floor, fraction of max)
STRICT_SUPPORT = (0.4, 0.02)
WIDE_SUPPORT = (0.05, 0.005)


def support_positions(n_row: np.ndarray, num_types: int,
                      abs_thr: float = STRICT_SUPPORT[0],
                      frac_thr: float = STRICT_SUPPORT[1]) -> List[int]:
    """The keep rule over one fetched node-count row: a type is in the
    support when the optimum provisions a meaningful fraction of a node
    there (n is in nodes). Defaults are the strict corner; the adaptive
    :class:`SupportController` feeds interpolated thresholds. A row with
    any non-finite value has no support."""
    n = np.asarray(n_row[:num_types], dtype=np.float64)
    if n.size == 0 or not np.all(np.isfinite(n)):
        return []
    return [t for t in range(num_types)
            if n[t] >= max(abs_thr, frac_thr * float(n.max()))]


class SupportController:
    """Acceptance-rate-driven support threshold: an EWMA of the strict
    pass's acceptance rate (seeded at 1.0) slides the keep rule linearly
    between the strict corner (rate 1) and the widened one (rate 0). The
    widened retry stays below it as the unconditional floor, and every
    accept still clears the exact infeasible/costlier/unverified gates."""

    def __init__(self, alpha: float = 0.2) -> None:
        self.alpha = float(alpha)
        self.rate = 1.0

    def thresholds(self) -> tuple:
        """(abs, frac) in force."""
        f = 1.0 - min(max(self.rate, 0.0), 1.0)
        a = STRICT_SUPPORT[0] + f * (WIDE_SUPPORT[0] - STRICT_SUPPORT[0])
        r = STRICT_SUPPORT[1] + f * (WIDE_SUPPORT[1] - STRICT_SUPPORT[1])
        return a, r

    def note(self, accepted: bool) -> None:
        self.rate += self.alpha * ((1.0 if accepted else 0.0) - self.rate)

    def reset(self) -> None:
        self.rate = 1.0


#: process-wide controller: it learns across windows, so a comparison of
#: two runs resets it before each
SUPPORT = SupportController()


def widened_support_positions(n_row: np.ndarray, num_types: int) -> List[int]:
    """The no-support retry's keep rule: small schedules often optimize to
    fractional node counts everywhere, so the strict rule keeps nothing;
    this keeps any type with a non-trivial share of the mass. The exact
    gates downstream still hold."""
    n = np.asarray(n_row[:num_types], dtype=np.float64)
    if n.size == 0 or not np.all(np.isfinite(n)) or float(n.max()) <= 0.0:
        return []
    return [t for t in range(num_types)
            if n[t] >= max(0.05, 0.005 * float(n.max()))]
