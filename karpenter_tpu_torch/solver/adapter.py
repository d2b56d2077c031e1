"""Adapter: k8s objects + instance catalog → integer-vector packing problem.

Mirrors PackablesFor (packable.go:44-91): viability validators, kubelet/system
overhead reservation, daemonset overhead packing, and the GPU-class-aware
ascending sort. Output feeds both the host oracle and the device encoder.

A pod's resource vector is computed once per Pod object and cached on it:
resource requests are immutable after admission, so the vector computed at
the first solve serves every later one. Viability takes the scalar
per-type validators (:func:`_validate`).
"""

from __future__ import annotations

import functools
import itertools
import threading
from typing import List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.solver.host_ffd import (
    NUM_RESOURCES, Packable, R_AMD, R_CPU, R_EXOTIC, R_MEMORY, R_NEURON,
    R_NVIDIA, R_POD_ENI, R_PODS, Vec, pack_one,
)
from karpenter_tpu_torch.utils import resources as res

_WELL_KNOWN_RESOURCE_INDEX = {
    res.CPU: R_CPU,
    res.MEMORY: R_MEMORY,
    res.PODS: R_PODS,
    res.NVIDIA_GPU: R_NVIDIA,
    res.AMD_GPU: R_AMD,
    res.AWS_NEURON: R_NEURON,
    res.AWS_POD_ENI: R_POD_ENI,
}

_SPECIAL_RESOURCES = (res.AWS_POD_ENI, res.NVIDIA_GPU, res.AMD_GPU, res.AWS_NEURON)
# Bitmask layout for the per-pod special-resources cache: bit i set when
# _SPECIAL_RESOURCES[i] appears in any container's requests OR limits
# (requiresResource, packable.go:221-233 — presence, not quantity).
_ALL_SPECIAL_BITS = (1 << len(_SPECIAL_RESOURCES)) - 1
_CACHE_KEY = "_torch_marshal"


def _compute_pod_marshal(pod: Pod) -> Tuple[Vec, int]:
    v = [0] * NUM_RESOURCES
    special = 0
    for c in pod.spec.containers:
        req = c.resources.requests
        for name, q in req.items():
            idx = _WELL_KNOWN_RESOURCE_INDEX.get(name)
            if idx is None:
                if q.nano > 0:
                    v[R_EXOTIC] = 1
            else:
                v[idx] += q.nano
        for bit, name in enumerate(_SPECIAL_RESOURCES):
            if name in req or name in c.resources.limits:
                special |= 1 << bit
    return tuple(v), special


def _marshal(pod: Pod) -> Tuple[Vec, int]:
    """(vector, special-bitmask) for a pod, cached on the Pod object."""
    cached = pod.__dict__.get(_CACHE_KEY)
    if cached is None:
        cached = pod.__dict__[_CACHE_KEY] = _compute_pod_marshal(pod)
    return cached


def pod_vector(pod: Pod) -> Vec:
    """Sum of container requests as an 8-dim nano-unit vector. Any request
    outside the well-known seven maps onto the EXOTIC dimension (total is
    always 0 there), reproducing Go's zero-value map lookup that makes such
    pods unreservable (packable.go:157-167)."""
    return _marshal(pod)[0]


def pod_vectors(pods: Sequence[Pod]) -> List[Vec]:
    return [_marshal(pod)[0] for pod in pods]


def marshal_pods(pods: Sequence[Pod]) -> Tuple[List[Vec], frozenset]:
    """One pass over the batch returning (vectors, required special
    resources)."""
    vecs: List[Vec] = []
    mask = 0
    for pod in pods:
        vec, bits = _marshal(pod)
        vecs.append(vec)
        mask |= bits
    return vecs, _required_from_mask(mask)


def _required_from_mask(mask: int) -> frozenset:
    return frozenset(
        name for bit, name in enumerate(_SPECIAL_RESOURCES) if mask & (1 << bit))


def _required_resources(pods: Sequence[Pod]) -> frozenset:
    """Which exotic resources the pod set requires (requiresResource,
    packable.go:221-233: presence in requests OR limits) — computed once per
    solve instead of once per type validator."""
    mask = 0
    for pod in pods:
        mask |= _marshal(pod)[1]
        if mask == _ALL_SPECIAL_BITS:
            break
    return _required_from_mask(mask)


def resource_list_vector(rl: res.ResourceList) -> Vec:
    v = [0] * NUM_RESOURCES
    for name, q in rl.items():
        idx = _WELL_KNOWN_RESOURCE_INDEX.get(name)
        if idx is None:
            if q.nano > 0:
                v[R_EXOTIC] = 1
        else:
            v[idx] += q.nano
    return tuple(v)


def instance_totals(it: InstanceType) -> Vec:
    """PackableFor totals (packable.go:93-106)."""
    v = [0] * NUM_RESOURCES
    v[R_CPU] = it.cpu.nano
    v[R_MEMORY] = it.memory.nano
    v[R_PODS] = it.pods.nano
    v[R_NVIDIA] = it.nvidia_gpus.nano
    v[R_AMD] = it.amd_gpus.nano
    v[R_NEURON] = it.aws_neurons.nano
    v[R_POD_ENI] = it.aws_pod_eni.nano
    return tuple(v)


def _validate(it: InstanceType, allowed: tuple,
              required: frozenset) -> Optional[str]:
    """Viability validators (packable.go:52-59,175-247). Returns reason or None.
    ``allowed`` is the requirement sets evaluated once per solve.

    Go's sets.Has on a nil set is false, so an *unconstrained* requirement
    rejects here — callers inject the full universe of zones/types/arch/OS/
    capacity-types before solving (solver.solve.universe_constraints).
    """
    cts, zones, its, archs, oss = allowed
    # offerings: some offering's (capacity type, zone) allowed
    if not any(
        (cts is not None and o.capacity_type in cts) and (zones is not None and o.zone in zones)
        for o in it.offerings
    ):
        return "no viable offering"
    if its is None or it.name not in its:
        return "instance type not allowed"
    if archs is None or it.architecture not in archs:
        return "architecture not allowed"
    if oss is None or not (set(it.operating_systems) & oss):
        return "operating system not allowed"
    # AWS pod ENI (packable.go:235-247): first requesting pod decides
    if res.AWS_POD_ENI in required and it.aws_pod_eni.is_zero():
        return "aws pod eni required"
    # GPUs (packable.go:205-219): GPU classes are exclusive both ways
    for name, qty in ((res.NVIDIA_GPU, it.nvidia_gpus), (res.AMD_GPU, it.amd_gpus),
                      (res.AWS_NEURON, it.aws_neurons)):
        if name in required and qty.is_zero():
            return f"{name} is required"
        if name not in required and not qty.is_zero():
            return f"{name} is not required"
    return None


def _gpu_sort_cmp(a: Tuple[Vec, int], b: Tuple[Vec, int]) -> int:
    """Ascending packable sort (packable.go:74-89): GPU-class equality gate,
    then CPU, then memory; otherwise by GPU counts."""
    av, bv = a[0], b[0]
    if av[R_AMD] == bv[R_AMD] or av[R_NVIDIA] == bv[R_NVIDIA] or av[R_NEURON] == bv[R_NEURON]:
        if av[R_CPU] == bv[R_CPU]:
            return -1 if av[R_MEMORY] < bv[R_MEMORY] else (1 if av[R_MEMORY] > bv[R_MEMORY] else 0)
        return -1 if av[R_CPU] < bv[R_CPU] else 1
    if av[R_AMD] < bv[R_AMD] or av[R_NVIDIA] < bv[R_NVIDIA] or av[R_NEURON] < bv[R_NEURON]:
        return -1
    return 1


def _allowed_sets(constraints: Constraints) -> tuple:
    reqs = constraints.requirements
    return (reqs.capacity_types(), reqs.zones(), reqs.instance_types(),
            reqs.architectures(), reqs.operating_systems())


def _fingerprint(c: Constraints) -> tuple:
    # identity + length: an in-place append to a live requirement or taint
    # list changes a length, a replacement changes an id
    return (id(c.requirements), len(c.requirements.items),
            id(c.taints), len(c.taints))


def allowed_sets_cached(constraints: Constraints) -> tuple:
    """:func:`_allowed_sets` memoized on the constraints object itself,
    guarded by its fingerprint: a window that hands back the same
    constraints object skips the five requirement-list walks."""
    fp = _fingerprint(constraints)
    hit = constraints.__dict__.get("_allowed_sets_memo")
    if hit is not None and hit[0] == fp:
        return hit[1]
    allowed = _allowed_sets(constraints)
    constraints.__dict__["_allowed_sets_memo"] = (fp, allowed)
    return allowed


def build_packables(
    instance_types: Sequence[InstanceType],
    constraints: Constraints,
    pods: Sequence[Pod],
    daemons: Sequence[Pod],
    required: Optional[frozenset] = None,
) -> Tuple[List[Packable], List[InstanceType]]:
    """PackablesFor (packable.go:44-91): validate → reserve overhead → pack
    daemons → sort ascending. Callers that already marshaled the batch
    (:func:`marshal_pods`) pass ``required`` to skip the O(pods) re-scan."""
    allowed = allowed_sets_cached(constraints)
    if required is None:
        required = _required_resources(pods)
    daemon_vecs = [pod_vector(d) for d in daemons]
    viable: List[Tuple[Vec, InstanceType, Packable]] = []
    for it in instance_types:
        if _validate(it, allowed, required) is not None:
            continue
        totals = instance_totals(it)
        p = Packable(index=-1, total=list(totals), reserved=[0] * NUM_RESOURCES)
        # kubelet/system overhead (packable.go:63-66)
        if not p.reserve(resource_list_vector(it.overhead)):
            continue
        # daemonset overhead (packable.go:67-71): all daemons must pack, in
        # list order (the reference does not sort daemons)
        if daemon_vecs:
            r = pack_one(p, daemon_vecs, list(range(len(daemon_vecs))))
            if r.unpacked:
                continue
        viable.append((totals, it, p))

    viable.sort(key=functools.cmp_to_key(lambda a, b: _gpu_sort_cmp((a[0], 0), (b[0], 0))))
    packables: List[Packable] = []
    sorted_types: List[InstanceType] = []
    for i, (_, it, p) in enumerate(viable):
        p.index = i
        packables.append(p)
        sorted_types.append(it)
    return packables, sorted_types


# -- universe packables (ops/device_filter.py) ---------------------------------
#
# The fused device filter masks the WHOLE catalog on the device, so its type
# axis must not depend on the constraints: every type that survives overhead
# reservation and daemon packing, in an order that agrees with the host
# comparator on any feasible subset a fused problem can see. The stable
# (cpu, memory) key is that order: _gpu_sort_cmp's GPU-equality gate holds
# uniformly inside any feasible subset with at least one GPU class uniformly
# zero (classes outside ``required`` must be zero per _validate), where the
# comparator IS lexicographic (cpu, memory), and restricting a stable key
# sort to a subset gives the subset's stable key sort. A problem requiring
# all three GPU classes at once has no such class and stays off the fused
# path.

_token_counter = itertools.count(1)
_packables_version_counter = itertools.count(1)
_packables_lock = threading.Lock()
_UNIVERSE_CACHE: dict = {}
_UNIVERSE_CACHE_CAP = 8


def _instance_token(it: InstanceType) -> int:
    """A monotonic token attached to the InstanceType object: a catalog
    refresh (new objects) gets new tokens, so a cache keyed by them cannot
    serve a stale catalog."""
    tok = it.__dict__.get("_marshal_token")
    if tok is None:
        tok = it.__dict__["_marshal_token"] = next(_token_counter)
    return tok


def build_universe_packables(
    instance_types: Sequence[InstanceType],
    daemons: Sequence[Pod] = (),
    daemon_vecs: Optional[tuple] = None,
) -> Tuple[List[Packable], List[InstanceType], int]:
    """Packables over the whole catalog, independent of any constraints:
    overhead reserved and daemons packed (no validators: feasibility comes
    later as the device mask), sorted by the stable ``(cpu, memory)`` key.
    Returns ``(packables, sorted_types, version)``: fresh ``Packable``
    copies on every call (callers may mutate them) over a shared type
    order, and a version that changes exactly when the catalog (its
    objects' tokens) or the daemon set does."""
    if daemon_vecs is None:
        daemon_vecs = tuple(pod_vector(d) for d in daemons)
    key = (tuple(_instance_token(it) for it in instance_types), daemon_vecs)
    with _packables_lock:
        hit = _UNIVERSE_CACHE.get(key)
    if hit is None:
        viable: List[Tuple[Vec, InstanceType, Packable]] = []
        for it in instance_types:
            totals = instance_totals(it)
            p = Packable(index=-1, total=list(totals), reserved=[0] * NUM_RESOURCES)
            if not p.reserve(resource_list_vector(it.overhead)):
                continue
            if daemon_vecs:
                r = pack_one(p, list(daemon_vecs), list(range(len(daemon_vecs))))
                if r.unpacked:
                    continue
            viable.append((totals, it, p))
        viable.sort(key=lambda v: (v[0][R_CPU], v[0][R_MEMORY]))
        packables: List[Packable] = []
        sorted_types: List[InstanceType] = []
        for i, (_, it, p) in enumerate(viable):
            p.index = i
            packables.append(p)
            sorted_types.append(it)
        version = next(_packables_version_counter)
        with _packables_lock:
            if len(_UNIVERSE_CACHE) >= _UNIVERSE_CACHE_CAP:
                _UNIVERSE_CACHE.pop(next(iter(_UNIVERSE_CACHE)))
            _UNIVERSE_CACHE[key] = (packables, sorted_types, version)
    else:
        packables, sorted_types, version = hit
    return [p.copy() for p in packables], list(sorted_types), version
