"""What-if window encoding: N candidate drains as one batched program.

A copy of the JAX package's ``ops/whatif.py``. Consolidation asks N
independent questions per window — "do node i's movable pods fit on the
surviving cluster?" — that differ only in which node is subtracted. The
encoding exploits that: ONE shared free-capacity matrix over all bins
(every settled node), ONE compatibility tensor (selector/affinity/taints,
precomputed on host exactly like models/consolidate._compatible), and a
per-candidate bin index whose exclusion IS the "cluster minus node i"
delta. The kernel (ops/whatif_cuda.whatif_scan) then first-fits each
candidate's pods (pre-sorted descending, the place_onto order) into the
shared bins, a thread block per candidate — no per-candidate host re-pack,
no N× copies of the cluster state.

Quantities follow ops/encode.py exactly: nano-unit Python ints on the
host, divided by the per-resource GCD so realistic problems fit int32
exactly. Pod vectors use reserve semantics (R_PODS includes +1 pod slot),
which also makes zero-padded bins and candidates self-excluding — a padded
bin has free=0 and can never absorb a pod slot, so no masking tensor is
needed for padding. If any dimension cannot be scaled into int32, the
window exceeds the cell cap, or no bin can receive, the device tensors are
omitted and the window is answered by the exact host mirror
(``host_whatif``) — exactness is never traded for speed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import math

import numpy as np

from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.api.requirements import pod_requirements
from karpenter_tpu_torch.solver.adapter import pod_vector
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES, R_PODS

NANO = 10**9
INT32_LIMIT = 2**31 - 1

# NB*KB*BB bool/int32 cells above this: skip the device tensors (a
# pathological window would OOM the host before helping the device)
MAX_WINDOW_CELLS = 1 << 26


def _pow2(n: int, floor: int = 4) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclass
class WhatIfEncoding:
    """One consolidation window, exact host-side plus optional device-side.

    Host side (always present — the verification authority):
    - ``bins``: the survivors' free capacity (models/consolidate._Bin
      compatible: .name/.free/.labels/.taints), exact nano ints.
    - ``cand_bin``: bin index of each candidate.
    - ``cand_pods``: per candidate, (reserve-vector, pod) pairs sorted
      descending by (cpu, mem) — the place_onto order.
    - ``compat``: (N, K, B) bool — pod k of candidate i may land on bin b.

    Device side (None when unencodable): int32 GCD-scaled mirrors padded
    to power-of-two buckets, ready for ops/whatif_cuda.whatif_scan.

    ``kept`` is the receiver-pruned bin set: a bin whose free vector fits
    NO pod in the window (component-wise, resource-only — compat can only
    restrict further) can never be chosen by first-fit, so dropping it
    from the solve axis is exact. This is shared encode work the
    per-candidate host path cannot amortize: a steady-state cluster is
    mostly full bins, and pruning collapses the solve's bin axis to the
    few real receivers. ``d_cand_bin`` holds each candidate's own-bin
    position WITHIN kept, or -1 when its bin was pruned (nothing to
    exclude — it couldn't receive anyway).
    """

    bins: Sequence
    cand_bin: List[int]
    cand_pods: List[List[Tuple[Tuple[int, ...], Pod]]]
    compat: np.ndarray
    n: int
    k: int
    b: int
    kept: Optional[np.ndarray] = None        # original indices of kept bins
    # device tensors (padded, scaled) — None ⇒ host fallback
    d_pods: Optional[np.ndarray] = None      # (NB, KB, R) int32
    d_valid: Optional[np.ndarray] = None     # (NB, KB) bool
    d_compat: Optional[np.ndarray] = None    # (NB, KB, BB) bool
    d_free0: Optional[np.ndarray] = None     # (BB, R) int32
    d_cand_bin: Optional[np.ndarray] = None  # (NB,) int32 (kept position | -1)
    scales: Tuple[int, ...] = field(default_factory=tuple)

    @property
    def device_ready(self) -> bool:
        return self.d_pods is not None

    @property
    def cells(self) -> int:
        if self.d_compat is None:
            return self.n * self.k * self.b
        return int(np.prod(self.d_compat.shape))


def _gcd_scale_signed(columns: List[List[int]]) -> Optional[Tuple[int, ...]]:
    """ops/encode._gcd_scale with signed support: free vectors may be
    negative (an overcommitted node), and gcd divides them exactly too."""
    scales = []
    for vals in columns:
        g = 0
        for v in vals:
            g = math.gcd(g, v)
        g = g or 1
        if max((abs(v) // g for v in vals), default=0) > INT32_LIMIT:
            return None
        scales.append(g)
    return tuple(scales)


def _reserve_vec(pod: Pod) -> Tuple[int, ...]:
    v = list(pod_vector(pod))
    v[R_PODS] += NANO  # reserve semantics: the pod slot rides the vector
    return tuple(v)


def _compat_matrix(bins: Sequence, cand_pods) -> np.ndarray:
    """(N, K, B) bool with the exact models/consolidate._compatible
    semantics. Fast path: unconstrained pods on untainted bins are the
    overwhelming default, so the matrix starts True and only constrained
    pods / tainted bins pay a host loop."""
    n = len(cand_pods)
    k = max((len(ps) for ps in cand_pods), default=0)
    b = len(bins)
    compat = np.ones((n, max(k, 1), max(b, 1)), dtype=bool)
    tainted = frozenset(j for j, bn in enumerate(bins) if len(bn.taints))
    for i, pods in enumerate(cand_pods):
        for kk, (_, pod) in enumerate(pods):
            reqs = pod_requirements(pod)
            keys = list(reqs.keys())
            if keys:
                for j, bn in enumerate(bins):
                    ok = True
                    for key in keys:
                        allowed = reqs.requirement(key)
                        if allowed is None:
                            continue
                        if bn.labels.get(key) not in allowed:
                            ok = False
                            break
                    if ok and j in tainted:
                        # tolerates() returns scheduling errors: empty ⇒ ok
                        ok = not bn.taints.tolerates(pod)
                    compat[i, kk, j] = ok
            elif tainted:
                for j in tainted:
                    compat[i, kk, j] = not bins[j].taints.tolerates(pod)
    return compat


def encode_window(
    bins: Sequence,
    cand_bin: Sequence[int],
    cand_movable: Sequence[Sequence[Pod]],
    max_cells: int = MAX_WINDOW_CELLS,
) -> WhatIfEncoding:
    """Build the window encoding. The exact host side always succeeds; the
    device tensors are attached only when every dimension GCD-scales into
    int32 and the padded window fits the cell cap."""
    cand_pods = [
        sorted(((_reserve_vec(p), p) for p in pods),
               key=lambda t: (-t[0][0], -t[0][1]))
        for pods in cand_movable
    ]
    n, b = len(cand_pods), len(bins)
    k = max((len(ps) for ps in cand_pods), default=0)
    compat = _compat_matrix(bins, cand_pods)
    enc = WhatIfEncoding(bins=bins, cand_bin=list(cand_bin),
                         cand_pods=cand_pods, compat=compat, n=n, k=k, b=b)
    if n == 0 or b == 0 or k == 0:
        return enc

    columns: List[List[int]] = [[] for _ in range(NUM_RESOURCES)]
    for bn in bins:
        for r in range(NUM_RESOURCES):
            columns[r].append(bn.free[r])
    for pods in cand_pods:
        for vec, _ in pods:
            for r in range(NUM_RESOURCES):
                columns[r].append(vec[r])
    scales = _gcd_scale_signed(columns)
    if scales is None:
        return enc  # host-only window

    # Receiver pruning (exact): scaled division is exact, so the int64
    # compare below is the nano compare. A bin that fits NO window pod
    # resource-wise can never be chosen by first-fit — drop it from the
    # solve axis. Compat ignored here: it only restricts further, so kept
    # is a superset of reachable bins.
    free_scaled = np.empty((b, NUM_RESOURCES), dtype=np.int64)
    for j, bn in enumerate(bins):
        for r in range(NUM_RESOURCES):
            free_scaled[j, r] = bn.free[r] // scales[r]
    vec_scaled = np.unique(np.array(
        [[vec[r] // scales[r] for r in range(NUM_RESOURCES)]
         for pods in cand_pods for vec, _ in pods], dtype=np.int64), axis=0)
    fits_any = (free_scaled[:, None, :] >= vec_scaled[None, :, :]) \
        .all(axis=2).any(axis=1)
    kept = np.nonzero(fits_any)[0]
    enc.kept = kept
    bk = len(kept)
    if bk == 0:
        return enc  # nothing can receive: host mirror answers instantly

    nb, kb, bb = _pow2(n), _pow2(k), _pow2(bk)
    if nb * kb * bb > max_cells:
        return enc

    pos = np.full((b,), -1, dtype=np.int32)
    pos[kept] = np.arange(bk, dtype=np.int32)
    d_pods = np.zeros((nb, kb, NUM_RESOURCES), dtype=np.int32)
    d_valid = np.zeros((nb, kb), dtype=bool)
    d_compat = np.zeros((nb, kb, bb), dtype=bool)
    d_free0 = np.zeros((bb, NUM_RESOURCES), dtype=np.int32)
    d_cand_bin = np.zeros((nb,), dtype=np.int32)
    d_free0[:bk] = free_scaled[kept].astype(np.int32)
    for i, pods in enumerate(cand_pods):
        d_cand_bin[i] = pos[cand_bin[i]]
        for kk, (vec, _) in enumerate(pods):
            for r in range(NUM_RESOURCES):
                d_pods[i, kk, r] = vec[r] // scales[r]
            d_valid[i, kk] = True
    d_compat[:n, :compat.shape[1], :bk] = compat[:, :, kept]

    enc.d_pods, enc.d_valid, enc.d_compat = d_pods, d_valid, d_compat
    enc.d_free0, enc.d_cand_bin, enc.scales = d_free0, d_cand_bin, scales
    return enc


def host_whatif(enc: WhatIfEncoding) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host mirror of the device kernel: per candidate, first-fit its
    reserve vectors into every bin but its own, in nano ints. Returns
    (feasible (N,), slots (N, K) bin index or -1). ``feasible`` equals the
    scaled device result, because GCD scaling is an exact division, and so
    do the slots of a feasible candidate. On an infeasible one this mirror
    stops at the first pod that fits nowhere, while the kernel (as the JAX
    package's ``_whatif_jit``) goes on placing the later pods: their slots
    differ."""
    n, k = enc.n, enc.k
    feasible = np.zeros((n,), dtype=bool)
    slots = np.full((n, max(k, 1)), -1, dtype=np.int32)
    # scan receiver-pruned bins when the encoder computed them (exact —
    # pruned bins fit no window pod), the full bin set otherwise
    scan = list(enc.kept) if enc.kept is not None else range(enc.b)
    for i in range(n):
        own = enc.cand_bin[i]
        free = [list(bn.free) for bn in enc.bins]
        ok = True
        for kk, (vec, _) in enumerate(enc.cand_pods[i]):
            placed = -1
            for j in scan:
                if j == own or not enc.compat[i, kk, j]:
                    continue
                f = free[j]
                if all(f[r] >= vec[r] for r in range(NUM_RESOURCES)):
                    placed = j
                    break
            if placed < 0:
                ok = False
                break
            f = free[placed]
            for r in range(NUM_RESOURCES):
                f[r] -= vec[r]
            slots[i, kk] = placed
        feasible[i] = ok
    return feasible, slots


def verify_and_commit(
    enc: WhatIfEncoding,
    cand: int,
    free_state: List[List[int]],
    excluded: set,
    scan: Optional[Sequence[int]] = None,
) -> Optional[List[int]]:
    """The authority check before a drain executes: exact first-fit of
    candidate ``cand``'s pods into ``free_state`` (nano ints), skipping its
    own bin and every ``excluded`` bin (already-drained this window).
    ``scan`` restricts and orders the receiver bins (default: every bin in
    index order). Commits the placement on success and returns the
    receiving bin indices; None ⇒ the candidate no longer fits after
    earlier drains. Device results are a filter — this is the only path
    that authorizes evictions, so an (impossible) kernel false-positive can
    never drain a node whose pods don't fit."""
    own = enc.cand_bin[cand]
    trial = [list(f) for f in free_state]
    placed_bins: List[int] = []
    for kk, (vec, _) in enumerate(enc.cand_pods[cand]):
        placed = -1
        for j in (scan if scan is not None else range(enc.b)):
            if j == own or j in excluded or not enc.compat[cand, kk, j]:
                continue
            f = trial[j]
            if all(f[r] >= vec[r] for r in range(NUM_RESOURCES)):
                placed = j
                break
        if placed < 0:
            return None
        f = trial[placed]
        for r in range(NUM_RESOURCES):
            f[r] -= vec[r]
        placed_bins.append(placed)
    for j in range(enc.b):
        free_state[j][:] = trial[j]
    return placed_bins


def soft_affinity_loss(node, movable: Sequence[Pod], fleet: Sequence,
                       pods_by_node: Dict[str, List[Pod]],
                       cost_per_weight: float) -> float:
    """$/h a drain of ``node`` would forfeit in currently-satisfied
    preferred pod-affinity: for each movable pod, each preferred affinity
    term whose selector matches a same-namespace peer in the node's
    topology domain (same node for hostname, same node label value
    otherwise) counts its weight once. The scheduler paid ``weight x
    soft_affinity_cost_per_weight`` to co-locate that set (solver/policy
    soft_zone_adjust / ops/policy soft rows); the drain's savings must
    beat that price or consolidation is just undoing placement work.

    Preferred ANTI-affinity pays nothing: a drain reschedules the pod and
    the scheduler can re-satisfy anti terms elsewhere, whereas a scattered
    co-located set stays scattered until its peers churn. Scalar oracle —
    evaluated with api.core.LabelSelector.matches. Gated by the
    KARPENTER_SOFT_AFFINITY kill switch (scheduling.affinity.soft_enabled);
    off or zero-cost ⇒ 0.0."""
    if cost_per_weight <= 0.0 or not movable:
        return 0.0
    from karpenter_tpu_torch.scheduling.affinity import (
        _preferred_terms, soft_enabled)
    if not soft_enabled():
        return 0.0

    def domain(n, key: str):
        if key == "kubernetes.io/hostname":
            return n.metadata.name
        return n.metadata.labels.get(key)

    weight = 0
    for pod in movable:
        terms = _preferred_terms(pod, False)
        if not terms:
            continue
        for w, term in terms:
            if not term.topology_key or term.label_selector is None:
                continue
            dom = domain(node, term.topology_key)
            if dom is None:
                continue
            satisfied = False
            for other in fleet:
                if domain(other, term.topology_key) != dom:
                    continue
                for peer in pods_by_node.get(other.metadata.name, ()):
                    if peer is pod:
                        continue
                    if peer.metadata.namespace != pod.metadata.namespace:
                        continue
                    if term.label_selector.matches(peer.metadata.labels):
                        satisfied = True
                        break
                if satisfied:
                    break
            if satisfied:
                weight += abs(int(w))
    return weight * cost_per_weight
