"""Host-side First-Fit-Decreasing packer: the exact-parity oracle.

This is a faithful reimplementation of the reference packer's semantics
(pkg/controllers/provisioning/binpacking/{packer.go,packable.go}) over plain
integer resource vectors. It serves three roles:

1. The *oracle* for differential tests of the device kernel (node count must
   match exactly — the ±1 target in BASELINE.md).
2. The *fallback* solve path when a batch can't be encoded into int32
   tensors (exotic quantities, more shapes than the largest bucket).
3. Documentation-by-code of every quirk the device kernel must preserve.

Quirks preserved (with reference cites):
- Greedy pack is skip-and-continue: a pod that doesn't fit is set aside and
  smaller pods still try (packable.go:111-130).
- Early exit when the *smallest remaining* pod would overflow any nonzero
  total dimension, with `>=` (exact fit counts as full), and with the
  implicit per-pod "pods" resource EXCLUDED from the check because
  RequestsForPods doesn't include it (packable.go:118,140-155).
- If nothing packed yet and a pod fails, the whole pack returns empty
  (packable.go:123-126).
- packWithLargestPod probes the LARGEST instance type for an upper bound,
  then takes the FIRST (smallest) type achieving it (packer.go:167-198).
- maxPodsPacked==0 drops the single largest pod as unschedulable
  (packer.go:124-128).
- Resources requested outside the 7 well-known dimensions can never be
  reserved (Go zero-value total) — modeled as an 8th EXOTIC dimension with
  total always 0 (packable.go:157-167).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

# Fixed resource vector layout. EXOTIC is a synthetic dimension: 1 if the pod
# requests any resource outside the well-known seven; instance totals are
# always 0 there, so such pods can never reserve (matching Go's zero-value
# map lookup in packable.go reserve()).
R_CPU, R_MEMORY, R_PODS, R_NVIDIA, R_AMD, R_NEURON, R_POD_ENI, R_EXOTIC = range(8)
NUM_RESOURCES = 8

# All vectors are in nano units (Quantity.nano); one pod on the PODS dim:
POD_UNIT_NANO = 10**9

Vec = Tuple[int, ...]


def zero_vec() -> Vec:
    return (0,) * NUM_RESOURCES


@dataclass
class Packable:
    """An instance type being packed: totals + running reservation
    (packable.go:31-35)."""

    index: int  # position in the caller's (pre-sorted) instance type list
    total: List[int]
    reserved: List[int]

    def copy(self) -> "Packable":
        return Packable(self.index, list(self.total), list(self.reserved))

    def reserve(self, requests: Sequence[int]) -> bool:
        """reserve (packable.go:157-167): fail if any dim would exceed total."""
        for r in range(NUM_RESOURCES):
            if self.reserved[r] + requests[r] > self.total[r]:
                return False
        for r in range(NUM_RESOURCES):
            self.reserved[r] += requests[r]
        return True

    def reserve_pod(self, pod_vec: Sequence[int]) -> bool:
        """reservePod (packable.go:169-173): requests + implicit pods:1."""
        req = list(pod_vec)
        req[R_PODS] += POD_UNIT_NANO
        return self.reserve(req)

    def is_full_for(self, pod_vec: Sequence[int]) -> bool:
        """fits() quirk (packable.go:145-155): True when adding this pod's
        *requests* (no implicit pods:1) reaches-or-exceeds any nonzero total."""
        for r in range(NUM_RESOURCES):
            if self.total[r] != 0 and self.reserved[r] + pod_vec[r] >= self.total[r]:
                return True
        return False


@dataclass
class PackResult:
    packed: List[int]  # indices into the pod list given to pack_one
    unpacked: List[int]


def pack_one(packable: Packable, pod_vecs: Sequence[Vec], pod_ids: Sequence[int]) -> PackResult:
    """Greedy pack of sorted pods onto one packable (packable.go:111-130)."""
    result = PackResult([], [])
    n = len(pod_ids)
    for i in range(n):
        if packable.reserve_pod(pod_vecs[i]):
            result.packed.append(pod_ids[i])
            continue
        if packable.is_full_for(pod_vecs[n - 1]):
            result.unpacked.extend(pod_ids[i:])
            return result
        if not result.packed:
            result.unpacked.extend(pod_ids)
            return result
        result.unpacked.append(pod_ids[i])
    return result


@dataclass
class HostPacking:
    """One node packing: pods per node instance + viable type options
    (packer.go:73-77)."""

    pod_ids: List[List[int]]  # one list per node instance
    instance_type_indices: List[int]  # ascending packable order, ≤ max_instance_types
    node_quantity: int = 1


@dataclass
class HostSolveResult:
    packings: List[HostPacking]
    unschedulable: List[int]  # pod ids that fit no instance type

    @property
    def node_count(self) -> int:
        return sum(p.node_quantity for p in self.packings)


MAX_INSTANCE_TYPES = 20  # packer.go:38-39


def instance_options(packables: Sequence[Packable], chosen: int,
                     max_instance_types: int = MAX_INSTANCE_TYPES) -> List[int]:
    """Viable instance-type options for a node packed on ``chosen``
    (packer.go:184-191): the next ≤20 ascending types with memory and pods
    not smaller than the chosen type's. Shared by the host and device decode
    paths — the exact-parity contract depends on a single implementation."""
    base = packables[chosen]
    options = []
    for j in range(chosen, min(chosen + max_instance_types, len(packables))):
        if (base.total[R_MEMORY] <= packables[j].total[R_MEMORY]
                and base.total[R_PODS] <= packables[j].total[R_PODS]):
            options.append(packables[j].index)
    return options


def pack(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    max_instance_types: int = MAX_INSTANCE_TYPES,
    prices: Optional[Sequence[float]] = None,   # per-packable effective $/h
    cost_tiebreak: bool = False,
) -> HostSolveResult:
    """Full FFD loop (packer.go:109-141). ``packables`` must already be
    viable (validators + overhead + daemons applied) and sorted ascending
    (packable.go:74-89); pods must be sorted descending by (cpu, mem).

    ``cost_tiebreak`` (beyond-reference): among types achieving max pods,
    choose the cheapest (capacity order breaks price ties) instead of Go's
    first-smallest. Default preserves Go semantics exactly.
    """
    order = sorted(range(len(pod_ids)), key=lambda i: tuple(-v for v in pod_vecs[i]))
    vecs = [pod_vecs[i] for i in order]
    ids = [pod_ids[i] for i in order]

    packings: List[HostPacking] = []
    by_options: dict = {}
    unschedulable: List[int] = []

    while ids:
        if not packables:
            unschedulable.extend(ids)
            break
        packing, vecs, ids = _pack_with_largest_pod(
            vecs, ids, packables, max_instance_types,
            prices=prices if cost_tiebreak else None)
        if not packing.pod_ids[0]:
            # nothing fit anywhere: drop the largest pod (packer.go:124-128)
            unschedulable.append(ids[0])
            vecs, ids = vecs[1:], ids[1:]
            continue
        key = tuple(packing.instance_type_indices)  # hash ignores Pods/NodeQuantity
        if key in by_options:
            main = by_options[key]
            main.node_quantity += 1
            main.pod_ids.extend(packing.pod_ids)
        else:
            by_options[key] = packing
            packings.append(packing)
    return HostSolveResult(packings=packings, unschedulable=unschedulable)


def _pack_with_largest_pod(
    vecs: List[Vec], ids: List[int], packables: Sequence[Packable],
    max_instance_types: int, prices: Optional[Sequence[float]] = None,
) -> Tuple[HostPacking, List[Vec], List[int]]:
    """packer.go:167-198. With ``prices``, the cheapest max-achieving type
    wins instead of the first (cost tie-break mode)."""
    max_pods_packed = len(pack_one(packables[-1].copy(), vecs, ids).packed)
    if max_pods_packed == 0:
        return HostPacking(pod_ids=[[]], instance_type_indices=[]), vecs, ids

    best: Optional[Tuple[int, PackResult]] = None
    for i, packable in enumerate(packables):
        result = pack_one(packable.copy(), vecs, ids)
        if len(result.packed) != max_pods_packed:
            continue
        if prices is None:
            best = (i, result)
            break  # Go semantics: first (smallest) achieving type
        if best is None or prices[i] < prices[best[0]]:
            best = (i, result)
    if best is not None:
        i, result = best
        options = instance_options(packables, i, max_instance_types)
        packed_set = set(result.packed)
        rem = [(v, pid) for v, pid in zip(vecs, ids) if pid not in packed_set]
        return (
            HostPacking(pod_ids=[result.packed], instance_type_indices=options),
            [v for v, _ in rem],
            [pid for _, pid in rem],
        )
    # unreachable if packables[-1] achieved max_pods_packed, kept for safety
    return HostPacking(pod_ids=[[]], instance_type_indices=[]), vecs, ids
