"""Adapter: k8s objects + instance catalog → integer-vector packing problem.

Mirrors PackablesFor (packable.go:44-91): viability validators, kubelet/system
overhead reservation, daemonset overhead packing, and the GPU-class-aware
ascending sort. Output feeds both the host oracle and the device encoder.

A port of the JAX package's ``solver/adapter.py``. A pod's resource vector
is computed once per Pod object and cached on it, with its special-resource
mask and an interned shape id: resource requests are immutable after
admission, so the first computation serves every later solve. A window's
marshal goes through the delta-marshal arena (``ops/encode.MarshalArena``):
a pod that went through an earlier window carries its arena row, so a
steady-state window is a gather of cached ints. Viability is the whole
catalog's columnar mask (``ops/feasibility.catalog_feasibility_mask``), and
``build_packables`` is memoized per (catalog, allowed sets, daemons,
required resources) with a content version the encoder's catalog cache and
the device ring key on.

Left out: the ``KARPENTER_MARSHAL_ARENA=0`` kill switch (the per-pod scan
stays as the arena's fallback).
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.ops import feasibility
from karpenter_tpu_torch.ops.feasibility import _fingerprint
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
# the per-pod cache entries on Pod.__dict__: the marshal tuple and the arena
# row (named apart from the JAX package's, whose pods carry their own)
_CACHE_KEY = "_torch_marshal"
_ROW_KEY = "_torch_arena_row"


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


# -- shape interning --------------------------------------------------------
# Every distinct resource vector gets a stable small integer id at marshal
# time, so the encoder's pod→shape dedupe runs as np.unique over int64 ids
# (nano-unit vectors themselves can exceed int64). Bounded: crossing the cap
# bumps the generation and clears the table; cached pod entries and
# in-flight id batches carry their generation, and any mismatch makes the
# consumer fall back to the dict dedupe, so a stale id never indexes the
# wrong vector.


def _intern_max_from_env() -> int:
    raw = os.environ.get("KARPENTER_INTERN_MAX", "")
    if not raw.strip():
        return 1 << 18
    try:
        return max(1, int(raw.strip()))
    except ValueError:
        logging.getLogger("karpenter.solver.adapter").warning(
            "KARPENTER_INTERN_MAX=%r is not an integer; using default %d", raw, 1 << 18)
        return 1 << 18


_INTERN_LOCK = threading.Lock()
_VEC_INTERN: dict = {}
_VEC_BY_ID: List[Vec] = []
_INTERN_MAX = _intern_max_from_env()
_INTERN_GEN = 0


def _intern_vec(vec: Vec) -> Tuple[int, int]:
    """Intern under the lock; returns (sid, generation) consistently."""
    global _INTERN_GEN
    with _INTERN_LOCK:
        sid = _VEC_INTERN.get(vec)
        if sid is None:
            if len(_VEC_BY_ID) >= _INTERN_MAX:
                _VEC_INTERN.clear()
                _VEC_BY_ID.clear()
                _INTERN_GEN += 1
            sid = len(_VEC_BY_ID)
            _VEC_BY_ID.append(vec)
            _VEC_INTERN[vec] = sid
        return sid, _INTERN_GEN


def interned_vecs_snapshot(sids, gen: int) -> Optional[List[Vec]]:
    """Map interned ids back to vectors, verifying the table is still the
    generation the ids were minted in; None = the caller must fall back."""
    with _INTERN_LOCK:
        if gen != _INTERN_GEN:
            return None
        try:
            return [_VEC_BY_ID[int(s)] for s in sids]
        except IndexError:
            return None


def _marshal(pod: Pod) -> Tuple[Vec, int, int, int]:
    """The (vector, special-bitmask, interned shape id, intern generation)
    tuple for a pod, cached on the Pod object. A cached entry from an older
    intern generation re-interns on next touch (vector and mask are
    reused)."""
    cached = pod.__dict__.get(_CACHE_KEY)
    if cached is None or cached[3] != _INTERN_GEN:
        vec, special = (_compute_pod_marshal(pod) if cached is None
                        else (cached[0], cached[1]))
        sid, gen = _intern_vec(vec)
        cached = pod.__dict__[_CACHE_KEY] = (vec, special, sid, gen)
    return cached


def pod_vector(pod: Pod) -> Vec:
    """Sum of container requests as an 8-dim nano-unit vector. Any request
    outside the well-known seven maps onto the EXOTIC dimension (total is
    always 0 there), reproducing Go's zero-value map lookup that makes such
    pods unreservable (packable.go:157-167). Call
    :func:`invalidate_pod_marshal` after mutating a pod's containers."""
    return _marshal(pod)[0]


def pod_special_mask(pod: Pod) -> int:
    """Which of _SPECIAL_RESOURCES the pod names in requests or limits, as a
    bitmask, cached alongside the vector."""
    return _marshal(pod)[1]


def invalidate_pod_marshal(pod: Pod) -> None:
    """Forget a pod's cached marshal and its arena row. (The JAX package
    drops only the marshal, so a pod it already placed in the arena keeps
    its old shape id there.)"""
    pod.__dict__.pop(_CACHE_KEY, None)
    pod.__dict__.pop(_ROW_KEY, None)


def pod_vectors(pods: Sequence[Pod]) -> List[Vec]:
    return [_marshal(pod)[0] for pod in pods]


def marshal_pods(pods: Sequence[Pod]) -> Tuple[List[Vec], frozenset]:
    """One pass over the batch returning (vectors, required special
    resources)."""
    vecs, required, _ = marshal_pods_interned(pods)
    return list(vecs), required


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


class _LazyVecs:
    """Sequence facade over a pod batch's vectors, materialized on first
    element access. The arena path hands the encoder interned shape ids,
    whose dedupe never reads the vectors, so in the steady state the list
    is never built; only the dict fallback (an intern rollover mid-flight)
    pays for it."""

    __slots__ = ("_pods", "_vecs")

    def __init__(self, pods: Sequence[Pod]):
        self._pods = pods
        self._vecs: Optional[List[Vec]] = None

    def _materialize(self) -> List[Vec]:
        if self._vecs is None:
            self._vecs = [_marshal(p)[0] for p in self._pods]
        return self._vecs

    def __len__(self) -> int:
        return len(self._pods)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())


def _marshal_pods_interned_scan(pods: Sequence[Pod]):
    """The always-correct per-pod scan (the arena's fallback): marshal
    every pod through its cached attribute."""
    vecs: List[Vec] = []
    sid_list: List[int] = []
    mask = 0
    gen_seen = -1
    mixed = False
    for pod in pods:
        vec, bits, sid, gen = _marshal(pod)
        vecs.append(vec)
        sid_list.append(sid)
        mask |= bits
        if gen != gen_seen:
            mixed = gen_seen != -1
            gen_seen = gen
    sids = (None if mixed or gen_seen < 0
            else (np.array(sid_list, dtype=np.int64), gen_seen))
    return vecs, _required_from_mask(mask), sids


def marshal_pods_interned(pods: Sequence[Pod]):
    """(vectors, required special resources, interned shape ids): the
    encoder's vectorized dedupe input. The third element is ``(int64 array,
    generation)``, or None when the batch spans an intern table reset (the
    encoder then takes the dict dedupe).

    Backed by the delta-marshal arena (ops/encode.py): a pod that went
    through an earlier window carries its arena row index, so a
    steady-state window is a cached-int gather plus one numpy fancy index,
    and the vector list is lazy. Any generation movement seen mid-window
    (intern rebind, vocab rebind, arena rollover, concurrent reset) voids
    the attempt and restarts it; after three attempts the per-pod scan
    answers."""
    from karpenter_tpu_torch.ops import encode as enc_mod

    arena = enc_mod.marshal_arena()
    n = len(pods)
    for _attempt in range(3):
        with _INTERN_LOCK:
            adapter_gen = _INTERN_GEN
        arena_gen = arena.begin_window(adapter_gen)
        rows = np.empty(n, np.int64)
        hits = 0
        restart = False
        for i, pod in enumerate(pods):
            cached = pod.__dict__.get(_ROW_KEY)
            if cached is not None and cached[0] == arena_gen:
                rows[i] = cached[1]
                hits += 1
                continue
            _vec, bits, sid, gen = _marshal(pod)
            row, g = arena.assign(sid, bits, gen)
            if g != arena_gen:
                restart = True
                break
            pod.__dict__[_ROW_KEY] = (arena_gen, row)
            rows[i] = row
        if restart:
            continue
        gathered = arena.gather(rows, arena_gen)
        if gathered is None:
            continue
        sids_arr, mask, sid_gen = gathered
        arena.note_window(hits, n - hits)
        return _LazyVecs(pods), _required_from_mask(mask), (sids_arr, sid_gen)
    return _marshal_pods_interned_scan(pods)


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


def allowed_sets_cached(constraints: Constraints) -> tuple:
    """:func:`_allowed_sets` memoized on the constraints object itself,
    guarded by its fingerprint (the CompiledConstraints idiom): the
    scheduler's tighten memo hands back the same constraints object window
    after window, so steady-state windows skip the five requirement-list
    walks."""
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
    if required is None:
        required = _required_resources(pods)
    return _build_packables_from(
        instance_types, allowed_sets_cached(constraints),
        [pod_vector(d) for d in daemons], required)


def _build_packables_from(
    instance_types: Sequence[InstanceType],
    allowed: tuple,
    daemon_vecs: Sequence[Vec],
    required: frozenset,
) -> Tuple[List[Packable], List[InstanceType]]:
    # whole-catalog viability as one columnar mask (memoized by catalog
    # identity + allowed + required); None = the catalog cannot be indexed,
    # and the scalar per-type validators answer. Same verdicts either way.
    mask = feasibility.catalog_feasibility_mask(instance_types, allowed, required)
    daemon_vecs = list(daemon_vecs)
    viable: List[Tuple[Vec, InstanceType, Packable]] = []
    for t, it in enumerate(instance_types):
        if mask is not None:
            if not mask[t]:
                continue
        elif _validate(it, allowed, required) is not None:
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


# -- build_packables memoization ---------------------------------------------
#
# Between catalog refreshes the (catalog, constraints, daemons, required)
# inputs repeat window after window. The key is identity-based for catalog
# objects (a monotonic token on each InstanceType: a new catalog from a
# provider refresh gets new tokens, so a stale hit is impossible) and
# value-based for everything else.

_token_counter = itertools.count(1)
_packables_version_counter = itertools.count(1)
_packables_lock = threading.Lock()
_PACKABLES_CACHE: dict = {}
_PACKABLES_CACHE_CAP = 64
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


def build_packables_cached(
    instance_types: Sequence[InstanceType],
    constraints: Constraints,
    pods: Sequence[Pod],
    daemons: Sequence[Pod],
    required: Optional[frozenset] = None,
) -> Tuple[List[Packable], List[InstanceType]]:
    """Memoized :func:`build_packables`. A hit returns fresh ``Packable``
    copies (callers may mutate them) over the shared sorted-type list. Pods
    enter the key only through the special resources they require."""
    packables, sorted_types, _ = build_packables_versioned(
        instance_types, constraints, pods, daemons, required)
    return packables, sorted_types


def build_packables_versioned(
    instance_types: Sequence[InstanceType],
    constraints: Constraints,
    pods: Sequence[Pod],
    daemons: Sequence[Pod],
    required: Optional[frozenset] = None,
) -> Tuple[List[Packable], List[InstanceType], int]:
    """:func:`build_packables_cached` plus a monotonic content version that
    identifies the exact packable list: a catalog refresh (new instance
    tokens), a provisioner spec change (new allowed sets), new daemon
    overhead or a new required-resource set each land on a new cache key
    and mint a new version; repeated windows with the same inputs repeat
    it. It keys the encoder's catalog cache and, through the encoding's
    catalog token, lets the device ring prove a slot already holds these
    bytes."""
    allowed = allowed_sets_cached(constraints)
    daemon_vecs = tuple(pod_vector(d) for d in daemons)
    if required is None:
        required = _required_resources(pods)
    key = (tuple(_instance_token(it) for it in instance_types),
           allowed, daemon_vecs, required)
    with _packables_lock:
        hit = _PACKABLES_CACHE.get(key)
    if hit is None:
        packables, sorted_types = _build_packables_from(
            instance_types, allowed, daemon_vecs, required)
        version = next(_packables_version_counter)
        with _packables_lock:
            if len(_PACKABLES_CACHE) >= _PACKABLES_CACHE_CAP:
                _PACKABLES_CACHE.pop(next(iter(_PACKABLES_CACHE)))
            _PACKABLES_CACHE[key] = (packables, sorted_types, version)
    else:
        packables, sorted_types, version = hit
    return [p.copy() for p in packables], list(sorted_types), version


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
