"""Device-resident fused feasibility: the schedules × types mask on the device.

Which instance types can each schedule of a window use? The scalar answer is
``adapter._validate``, one type at a time on the host. This module answers
for the whole window at once on the device and hands the answer straight to
the pack kernel (the JAX package's ops/device_filter.py, its fused window):

- **Catalog bit-planes** (:class:`Planes`): the per-key value vocabularies
  of one instance-type list as bit words, one-hot name and arch words
  ``(T, W)``, multi-bit OS words, and a per-capacity-type zone bitmask
  ``(T, C, W_z)`` for the (capacity type, zone) offering product, which is
  not separable. Planes are cached by catalog identity and stay on the
  device across windows, keyed by ``planes.key``.
- **Schedule rows**: each schedule's ``(allowed, required)`` key becomes a
  few allowed-bitmask words (``allowed=None`` becomes an all-zero row: Go's
  ``sets.Has(nil)`` rejection, exactly like the scalar validator).
- **One mask program per window** (:func:`window_mask`): the (B, T) mask
  as an AND over requirement keys of ``allowed_word & type_value_bit``,
  plus ``last_valid``, any-feasible and sampled probe columns, all as
  tensors on the device. The mask is the pack kernel's ``valid`` input and
  never reaches the host. It is torch integer ops, not a hand kernel.

Torch on the CPU has no ``>>``, ``+`` or ``minimum`` for uint32, so the
planes and rows are int32 bit patterns (``&`` and ``!= 0`` are exact on
them) and the capacity-type shift is done in int64.

The device verdict stays a FILTER: the probe columns are re-checked against
the scalar validator at decode, every chosen type is re-validated in the
option walk, and a problem that diverges is solved again on the host path
(scalar wins), counted under ``device-mask-mismatch``. Every retreat
from the fused path is counted in the JAX package's
``karpenter_filter_device_fallback_total`` by reason (and in
:func:`fallback_counts`, the same counts as an attribute); the mask
program, the verification, the gang column and the affinity matrix are
timed in ``karpenter_filter_device_seconds``. ``KARPENTER_DEVICE_FILTER=0``
is the kill switch. An error from the device is not caught here.

Type-axis contract: fused problems encode against the universe packables
(``adapter.build_universe_packables``), the whole catalog sorted by the
stable ``(cpu, memory)`` key; restricted to any fused-eligible feasible
subset, that order is the host comparator's, so masking the universe axis
IS the host path's sorted feasible axis and decode indices agree.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.backend import DeviceLike, resolve_device, to_device_int32
from karpenter_tpu_torch.metrics.filter import (
    FILTER_DEVICE_FALLBACK_TOTAL, FILTER_DEVICE_SECONDS, FILTER_FALLBACK_TOTAL,
    FILTER_PLANE_RING_REUSES_TOTAL,
)
from karpenter_tpu_torch.ops.feasibility import _catalog_token
from karpenter_tpu_torch.utils import resources as res

_ENV = "KARPENTER_DEVICE_FILTER"

# special-resource bits of planes.special and the row's required word, in
# adapter._SPECIAL_RESOURCES order: ENI, then the GPU classes, which are
# exclusive both ways (packable.go:205-219)
_ENI_BIT = 1
_GPU_BITS = 0b1110
_GPU_CLASSES = (res.NVIDIA_GPU, res.AMD_GPU, res.AWS_NEURON)

_MAX_CT_VOCAB = 32       # capacity-type bits live in ONE row word
_PROBE_K = 32            # sampled columns per window (the full row when T <= K)

_LOCK = threading.Lock()
_PLANES_CACHE: dict = {}           # catalog token tuple -> Planes | _FAILED
_PLANES_CACHE_CAP = 8
_FAILED = object()
_ROW_CACHE: dict = {}              # (planes key, allowed, required) -> row
_ROW_CACHE_CAP = 1024
_RESIDENT: dict = {}               # (planes key, device) -> plane tensors
_RESIDENT_CAP = 8                  # catalogs a device
_window_counter = itertools.count(1)
_FALLBACKS: Dict[str, int] = {}


def enabled() -> bool:
    """The kill switch: ``KARPENTER_DEVICE_FILTER`` set to 0, false or off
    disables the fused path; anything else leaves it on."""
    return os.environ.get(_ENV, "").strip().lower() not in ("0", "false", "off")


def _count(reason: str) -> None:
    FILTER_DEVICE_FALLBACK_TOTAL.inc(reason=reason)
    with _LOCK:
        _FALLBACKS[reason] = _FALLBACKS.get(reason, 0) + 1


def fallback_counts() -> Dict[str, int]:
    """Why windows or problems left the fused path, by reason, since the
    last :func:`reset_fallback_counts`: ``device-mask-mismatch`` (the device
    mask disagreed with the scalar validator for a problem),
    ``ct-vocab-overflow``, ``mixed-universe``, ``gpu-trio``,
    ``bucket-mismatch``."""
    with _LOCK:
        return dict(_FALLBACKS)


def reset_fallback_counts() -> None:
    with _LOCK:
        _FALLBACKS.clear()


def _words(nbits: int) -> int:
    return max(1, -(-nbits // 32))


class Planes:
    """Bit-planes (uint32 words) of one instance-type list, the type axis
    padded to the encoder's TYPE_BUCKETS so the mask lines up with the
    padded encoding's type axis. Padding rows are all zero, which the mask
    algebra rejects: a padded type column is never valid."""

    __slots__ = ("key", "n", "TB", "name_vocab", "arch_vocab", "os_vocab",
                 "ct_vocab", "zone_vocab", "name_plane", "arch_plane",
                 "os_plane", "offer_plane", "special")

    def host_arrays(self) -> Dict[str, np.ndarray]:
        return {"name_plane": self.name_plane, "arch_plane": self.arch_plane,
                "os_plane": self.os_plane, "offer_plane": self.offer_plane,
                "special": self.special}


def _set_bit(arr: np.ndarray, index: tuple, b: int) -> None:
    arr[index + (b // 32,)] |= np.uint32(1 << (b % 32))


def _build_planes(instance_types, key: tuple) -> Optional[Planes]:
    from karpenter_tpu_torch.ops.encode import TYPE_BUCKETS, bucket

    n = len(instance_types)
    TB = bucket(max(n, 1), TYPE_BUCKETS)
    if TB is None:
        return None  # beyond the largest type bucket
    p = Planes()
    p.key, p.n, p.TB = key, n, TB
    p.name_vocab, p.arch_vocab, p.os_vocab = {}, {}, {}
    p.ct_vocab, p.zone_vocab = {}, {}
    # first pass: the vocabularies, so word counts are known before the planes
    for it in instance_types:
        p.name_vocab.setdefault(it.name, len(p.name_vocab))
        p.arch_vocab.setdefault(it.architecture, len(p.arch_vocab))
        for os_name in it.operating_systems:
            p.os_vocab.setdefault(os_name, len(p.os_vocab))
        for o in it.offerings:
            p.ct_vocab.setdefault(o.capacity_type, len(p.ct_vocab))
            p.zone_vocab.setdefault(o.zone, len(p.zone_vocab))
    if len(p.ct_vocab) > _MAX_CT_VOCAB:
        return None  # capacity-type bits must fit one row word
    C = max(1, len(p.ct_vocab))
    p.name_plane = np.zeros((TB, _words(len(p.name_vocab))), np.uint32)
    p.arch_plane = np.zeros((TB, _words(len(p.arch_vocab))), np.uint32)
    p.os_plane = np.zeros((TB, _words(len(p.os_vocab))), np.uint32)
    p.offer_plane = np.zeros((TB, C, _words(len(p.zone_vocab))), np.uint32)
    p.special = np.zeros((TB,), np.uint32)
    for t, it in enumerate(instance_types):
        _set_bit(p.name_plane, (t,), p.name_vocab[it.name])
        _set_bit(p.arch_plane, (t,), p.arch_vocab[it.architecture])
        for os_name in it.operating_systems:
            _set_bit(p.os_plane, (t,), p.os_vocab[os_name])
        for o in it.offerings:
            _set_bit(p.offer_plane, (t, p.ct_vocab[o.capacity_type]), p.zone_vocab[o.zone])
        sp = _ENI_BIT if not it.aws_pod_eni.is_zero() else 0
        for i, qty in enumerate((it.nvidia_gpus, it.amd_gpus, it.aws_neurons)):
            if not qty.is_zero():
                sp |= 1 << (1 + i)
        p.special[t] = sp
    for arr in p.host_arrays().values():
        arr.flags.writeable = False
    return p


def planes_for(instance_types) -> Optional[Planes]:
    """Planes for this catalog identity, cached. None: the catalog cannot
    be put in planes (more capacity types than one word holds, or more
    types than the largest bucket), counted; the caller takes the host
    path."""
    key = tuple(_catalog_token(it) for it in instance_types)
    with _LOCK:
        hit = _PLANES_CACHE.get(key)
    if hit is _FAILED:
        return None
    if hit is not None:
        return hit
    planes = _build_planes(instance_types, key)
    if planes is None:
        _count("ct-vocab-overflow")
    with _LOCK:
        if len(_PLANES_CACHE) >= _PLANES_CACHE_CAP:
            _PLANES_CACHE.pop(next(iter(_PLANES_CACHE)))
        _PLANES_CACHE[key] = planes if planes is not None else _FAILED
    return planes


def _window_planes(planes: Planes, device: torch.device) -> tuple:
    """:func:`resident_planes` for a mask program: a program that finds its
    catalog's planes already on the device counts them in
    ``karpenter_filter_plane_ring_reuses_total`` (zero plane bytes copied)."""
    with _LOCK:
        held = (planes.key, str(device)) in _RESIDENT
    planes_d = resident_planes(planes, device)
    if held:
        FILTER_PLANE_RING_REUSES_TOTAL.inc(amount=float(len(planes_d)))
    return planes_d


def resident_planes(planes: Planes, device: torch.device) -> tuple:
    """The planes as int32 tensors on ``device``, copied there once per
    catalog identity and device and kept across windows (a window whose
    catalog the device already holds copies no plane bytes): a mesh holds
    one copy of the planes per distinct device, the JAX package's
    replicated planes."""
    key = (planes.key, str(device))
    with _LOCK:
        hit = _RESIDENT.get(key)
    if hit is not None:
        return hit
    planes_d = tuple(to_device_int32(list(planes.host_arrays().values()), device))
    with _LOCK:
        # the cap holds per device: one card's catalogs never evict
        # another's
        held = [k for k in _RESIDENT if k[1] == key[1]]
        if len(held) >= _RESIDENT_CAP:
            _RESIDENT.pop(held[0])
        _RESIDENT[key] = planes_d
    return planes_d


def _bits_row(vocab: Dict[str, int], allowed, nwords: int) -> np.ndarray:
    """Allowed-set bitmask words over a plane vocabulary. ``None`` → all
    zero (rejects everything, as the scalar validator's Go sets.Has(nil));
    values outside the vocabulary set nothing (no type has them)."""
    row = np.zeros((nwords,), np.uint32)
    for v in allowed or ():
        b = vocab.get(v)
        if b is not None:
            _set_bit(row, (), b)
    return row


def schedule_row(planes: Planes, allowed: tuple, required: frozenset) -> tuple:
    """One schedule's row: the allowed bitmask words of each key and the
    required special-resource bits. Cached per (planes, allowed,
    required)."""
    key = (planes.key, allowed, required)
    with _LOCK:
        hit = _ROW_CACHE.get(key)
    if hit is not None:
        return hit
    cts, zones, its, archs, oss = allowed
    req = _ENI_BIT if res.AWS_POD_ENI in required else 0
    for i, name in enumerate(_GPU_CLASSES):
        if name in required:
            req |= 1 << (1 + i)
    ct_bits = 0
    for v in cts or ():
        b = planes.ct_vocab.get(v)
        if b is not None:
            ct_bits |= 1 << b
    row = (
        _bits_row(planes.name_vocab, its, planes.name_plane.shape[1]),
        _bits_row(planes.arch_vocab, archs, planes.arch_plane.shape[1]),
        _bits_row(planes.os_vocab, oss, planes.os_plane.shape[1]),
        _bits_row(planes.zone_vocab, zones, planes.offer_plane.shape[2]),
        np.uint32(ct_bits),
        np.uint32(req),
    )
    with _LOCK:
        if len(_ROW_CACHE) >= _ROW_CACHE_CAP:
            _ROW_CACHE.pop(next(iter(_ROW_CACHE)))
        _ROW_CACHE[key] = row
    return row


def _stack_rows(planes: Planes, rows: Sequence[tuple], B: int) -> tuple:
    """Per-schedule rows → (B, W) uint32 arrays; rows past ``len(rows)``
    are all zero (they reject everything)."""
    name_r = np.zeros((B, planes.name_plane.shape[1]), np.uint32)
    arch_r = np.zeros((B, planes.arch_plane.shape[1]), np.uint32)
    os_r = np.zeros((B, planes.os_plane.shape[1]), np.uint32)
    zone_r = np.zeros((B, planes.offer_plane.shape[2]), np.uint32)
    ct_r = np.zeros((B,), np.uint32)
    req_r = np.zeros((B,), np.uint32)
    for b, (nr, ar, osr, zr, ct, rq) in enumerate(rows):
        name_r[b], arch_r[b], os_r[b], zone_r[b] = nr, ar, osr, zr
        ct_r[b], req_r[b] = ct, rq
    return name_r, arch_r, os_r, zone_r, ct_r, req_r


def _mask_expr(name_p, arch_p, os_p, offer_p, special_p,
               name_r, arch_r, os_r, zone_r, ct_r, req_r) -> torch.Tensor:
    """The (B, T) mask algebra on int32 bit patterns: one AND-reduce of
    ``allowed_word & type_value_bit`` per requirement key, the offering
    product and the exclusive special-resource rule. Exactly the scalar
    validator (``adapter._validate``)."""
    def axis_ok(plane, row):  # (T, W) x (B, W) -> (B, T)
        return ((plane[None, :, :] & row[:, None, :]) != 0).any(-1)

    # offerings: feasible iff SOME offering has its capacity type AND its
    # zone allowed; a per-(type, capacity type) zone bitmask keeps the
    # product exact (any-ct AND any-zone would not be)
    zc = ((offer_p[None, :, :, :] & zone_r[:, None, None, :]) != 0).any(-1)  # (B, T, C)
    C = offer_p.shape[1]
    shifts = torch.arange(C, dtype=torch.int64, device=ct_r.device)
    ct_bits = ((ct_r.to(torch.int64)[:, None] >> shifts) & 1) != 0  # (B, C)
    offer_ok = (zc & ct_bits[:, None, :]).any(-1)
    req = req_r[:, None]
    tb = special_p[None, :]
    eni_ok = (req & _ENI_BIT & ~tb) == 0
    gpu_ok = (req & _GPU_BITS) == (tb & _GPU_BITS)
    return (axis_ok(name_p, name_r) & axis_ok(arch_p, arch_r) & axis_ok(os_p, os_r)
            & offer_ok & eni_ok & gpu_ok)


def window_mask(planes_d: tuple, rows_d: tuple, probe_idx: torch.Tensor):
    """The window's mask program: ``(mask, last_valid, any_feasible,
    probe)``, all on the device. ``mask`` (B, T) bool is the pack kernel's
    ``valid``; ``last_valid`` (B,) int32 the largest feasible type (0 for a
    row with none, where ``any_feasible`` is False); ``probe`` the mask's
    columns at ``probe_idx`` for the decode-side check."""
    mask = _mask_expr(*planes_d, *rows_d)
    iota = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    lv = torch.where(mask, iota[None, :], -1).amax(dim=1)
    any_feas = lv >= 0
    last_valid = lv.clamp(min=0).to(torch.int32)
    probe = mask.index_select(1, probe_idx)
    return mask, last_valid, any_feas, probe


def _pairs_mask(planes: Planes, pairs, dev: torch.device) -> torch.Tensor:
    """The (len(pairs), TB) mask of ``pairs`` of (allowed, required) keys
    as a tensor on ``dev``: the planes resident there, one copy of the
    rows."""
    rows = [schedule_row(planes, allowed, required) for allowed, required in pairs]
    stacked = _stack_rows(planes, rows, max(1, len(rows)))
    return _mask_expr(*_window_planes(planes, dev), *to_device_int32(stacked, dev))


def compute_mask(instance_types, pairs, device: DeviceLike = None) -> Optional[np.ndarray]:
    """The (len(pairs), len(instance_types)) device mask of ``pairs`` of
    (allowed, required) keys, copied to the host: the verdicts the fused
    path keeps on the device, for tests and checks. None when the catalog
    cannot be put in planes."""
    planes = planes_for(instance_types)
    if planes is None:
        return None
    mask = _pairs_mask(planes, pairs, resolve_device(device))
    return mask.cpu().numpy()[:len(pairs), :planes.n]


GANG_COLUMN_RUNS = 0  # member-column programs run since import


def gang_member_column(instance_types, member_keys,
                       device: DeviceLike = None) -> Optional[np.ndarray]:
    """The gang member-AND column ((T,) bool: every member key's
    validators accept the type), the JAX package's ``_rows_jit`` /
    ``gang_member_column``: the window mask algebra on the member keys'
    unpadded rows, AND-reduced over them on ``device`` (default: the CUDA
    device), one (T,) copy back. None when there are no keys, the kill
    switch is set or the catalog cannot be put in planes: the caller takes
    the host columns."""
    global GANG_COLUMN_RUNS
    if not enabled() or not member_keys:
        return None
    t0 = time.perf_counter()
    planes = planes_for(instance_types)
    if planes is None:
        return None
    col = _pairs_mask(planes, member_keys, resolve_device(device)).all(0)
    with _LOCK:
        GANG_COLUMN_RUNS += 1
    out = col.cpu().numpy()[:planes.n]
    FILTER_DEVICE_SECONDS.observe(time.perf_counter() - t0, stage="gang")
    return out


class FusedMismatch(Exception):
    """Raised at decode when the kernel's chosen type fails the scalar
    validator: the device mask was wrong for this problem, which is then
    solved again on the host path."""


class FusedBatch:
    """What the batched run needs to consume the device mask: per shard of
    the solver mesh its rows' mask and last_valid tensors (the pack
    kernel's ``valid`` and ``last_valid`` there, :attr:`masks`), the shared
    universe packables and type axis, and per problem the verification
    state (probe columns, a memo of scalar verdicts) and its soft-affinity
    votes (``soft``, one entry per member, None for no preference: the
    policy scoring program prices them, ops/policy.py). ``shards`` holds a
    ``(mask, last_valid, any_feasible, probe)`` tuple a shard, in mesh
    order, over the members padded to a multiple of the mesh size."""

    def __init__(self, batch_idx, encs, packables, uni_types, verify, mesh, shards,
                 probe_idx, soft=None):
        self.batch_idx = list(batch_idx)
        self.soft = list(soft) if soft is not None else [None] * len(self.batch_idx)
        self.encs = list(encs)
        self.packables = packables
        self.uni_types = uni_types
        self.verify = list(verify)         # [(allowed, required)] per member
        self.mesh = mesh
        self.device = mesh[0]
        self.shards = list(shards)
        self.probe_idx = probe_idx         # host (K,) int32
        self._ok_memos: List[Optional[dict]] = [None] * len(self.batch_idx)

    @property
    def masks(self) -> List[tuple]:
        """The ``(valid, last_valid)`` tensors of each shard, on its device."""
        return [(m, lv) for m, lv, _, _ in self.shards]

    def _ok(self, b: int, t: int) -> bool:
        """The scalar validator for (member b, universe type t), memoized."""
        from karpenter_tpu_torch.solver.adapter import _validate

        memo = self._ok_memos[b]
        if memo is None:
            memo = self._ok_memos[b] = {}
        if t not in memo:
            allowed, required = self.verify[b]
            memo[t] = _validate(self.uni_types[t], allowed, required) is None
        return memo[t]

    def _options_fn(self, b: int):
        """instance_options over the FEASIBLE subsequence of the universe
        axis: the next ``maxn`` feasible types from ``chosen`` (host_ffd.
        instance_options over the host's feasible list, by the order
        equivalence above), every scanned type re-validated by the scalar
        validator; the chosen type's check is the main verification."""
        from karpenter_tpu_torch.solver.host_ffd import R_MEMORY, R_PODS

        def options_fn(packables, chosen, maxn):
            if not self._ok(b, chosen):
                raise FusedMismatch(chosen)
            base = packables[chosen]
            out: List[int] = []
            taken, j = 0, chosen
            while j < len(packables) and taken < maxn:
                if self._ok(b, j):
                    taken += 1
                    if base.total[R_MEMORY] <= packables[j].total[R_MEMORY] \
                            and base.total[R_PODS] <= packables[j].total[R_PODS]:
                        out.append(packables[j].index)
                j += 1
            return out

        return options_fn

    def decode_all(self, decode, records, dropped_full):
        """Decode every member under the self-heal contract: its probe
        columns re-checked against the scalar validator, an all-False row
        re-derived, every chosen type re-validated in the option walk. A
        member that diverges gets None (the handle solves it on the host
        path) and is counted under ``device-mask-mismatch``."""
        t0 = time.perf_counter()
        # one device→host copy a shard, gathered in batch order
        checks = np.concatenate([torch.cat([probe_d, any_d[:, None]], dim=1).cpu().numpy()
                                 for _, _, any_d, probe_d in self.shards])
        probe, any_feas = checks[:, :-1], checks[:, -1]
        out: List[Optional[object]] = []
        for b, enc in enumerate(self.encs):
            bad = None
            for k, t in enumerate(self.probe_idx):
                if bool(probe[b, k]) != self._ok(b, int(t)):
                    bad = f"probe type {int(t)}"
                    break
            if bad is None and not any_feas[b] and any(
                    self._ok(b, t) for t in range(len(self.uni_types))):
                bad = "all-false row"
            if bad is None:
                try:
                    out.append(decode(enc, records[b], dropped_full[b], self.packables,
                                      options_fn=self._options_fn(b)))
                    continue
                except FusedMismatch:
                    pass
            FILTER_FALLBACK_TOTAL.inc(reason="device-mask-mismatch")
            _count("device-mask-mismatch")
            out.append(None)
        FILTER_DEVICE_SECONDS.observe(time.perf_counter() - t0, stage="verify")
        return out


def _probe_indices(n: int) -> np.ndarray:
    """The window's verification columns: every real type of a small
    catalog, else a deterministic per-window sample; always (_PROBE_K,)."""
    if n <= _PROBE_K:
        idx = np.arange(n, dtype=np.int32)
    else:
        rng = np.random.default_rng(next(_window_counter))
        idx = rng.choice(n, size=_PROBE_K, replace=False).astype(np.int32)
    if len(idx) < _PROBE_K:
        idx = np.concatenate([idx, np.full(_PROBE_K - len(idx), idx[-1] if len(idx) else 0,
                                           np.int32)])
    return idx


def prepare_fused(problems, marshaled, device=None) -> Optional[FusedBatch]:
    """Dispatch-side fused preparation of one window over the solver mesh
    ``device`` resolves to (parallel/mesh.resolve_mesh): universe
    packables, the planes on each distinct device of the mesh, the rows
    padded to a multiple of the mesh size and cut into one range a shard,
    the universe encodings and the mask program on each shard's rows on
    its device, enqueued without a synchronisation. Returns a
    :class:`FusedBatch` of at least two members, or None when the window
    cannot be fused (kill switch, mixed catalogs, no packables, planes
    refused, fewer than two eligible members); the caller then takes the
    classic host-filtered batch path. ``marshaled[i]`` is problem i's
    ``adapter.marshal_pods_interned`` triple (pod vectors, required special
    resources, interned shape ids); the members encode against the
    universe packables' versioned catalog arrays."""
    if not enabled():
        return None
    t0 = time.perf_counter()
    from karpenter_tpu_torch.ops.encode import encode, pad_encoding
    from karpenter_tpu_torch.parallel.mesh import batch_sharding, resolve_mesh
    from karpenter_tpu_torch.solver import adapter

    mesh = resolve_mesh(device)
    # one universe per fused batch: every member shares the catalog
    # identity and the daemon overhead (the shared type axis and planes)
    key0 = None
    for prob in problems:
        key = (tuple(adapter._instance_token(it) for it in prob.instance_types),
               tuple(adapter.pod_vector(d) for d in prob.daemons))
        if key0 is None:
            key0 = key
        elif key != key0:
            _count("mixed-universe")
            return None
    if key0 is None or not key0[0]:
        return None
    packables, uni_types, uni_version = adapter.build_universe_packables(
        problems[0].instance_types, daemon_vecs=key0[1])
    if not packables:
        return None
    planes = planes_for(uni_types)
    if planes is None:
        return None

    batch_idx, encs, verify, soft = [], [], [], []
    for i, prob in enumerate(problems):
        vecs, required, sids = marshaled[i]
        if len(required & set(_GPU_CLASSES)) >= 3:
            # all three GPU classes required: the host comparator's order on
            # the feasible subset is no longer the stable (cpu, mem) key
            _count("gpu-trio")
            continue
        allowed = adapter.allowed_sets_cached(prob.constraints)
        if any(a is None or len(a) == 0 for a in allowed):
            # a None or empty allowed set rejects every type: the solo path
            # answers "all unschedulable" at once
            continue
        enc = encode(vecs, list(range(len(prob.pods))), packables, pad=False,
                     sids=sids, catalog_version=uni_version)
        penc = None if enc is None else pad_encoding(enc)
        if penc is None:
            continue
        batch_idx.append(i)
        encs.append(penc)
        verify.append((allowed, required))
        soft.append(getattr(prob, "soft_affinity", None))
    if len(batch_idx) < 2:
        return None
    TB = encs[0].totals.shape[0]
    if TB != planes.TB or any(e.totals.shape[0] != TB for e in encs):
        _count("bucket-mismatch")
        return None

    rows = [schedule_row(planes, allowed, required) for allowed, required in verify]
    # the padding rows are all zero: they reject every type
    stacked = _stack_rows(planes, rows, -(-len(encs) // len(mesh)) * len(mesh))
    probe_idx = _probe_indices(planes.n)
    shards = []
    for sh in batch_sharding(stacked[0].shape[0], mesh):
        *rows_d, probe_d = to_device_int32([*(a[sh.rows] for a in stacked), probe_idx],
                                           sh.device)
        shards.append(window_mask(_window_planes(planes, sh.device), tuple(rows_d),
                                  probe_d.long()))
    fused = FusedBatch(batch_idx, encs, packables, uni_types, verify, mesh, shards,
                       probe_idx, soft=soft)
    FILTER_DEVICE_SECONDS.observe(time.perf_counter() - t0, stage="dispatch")
    return fused



# -- pod-pod affinity: the selectors × peers match matrix (B5) ----------------
#
# Peers (distinct pod-label signatures) intern their (key, value) pairs into
# dense bit positions; each peer becomes one row of 32-bit words with its
# pair bits set. Every supported selector clause reduces to ANY / NONE over a
# clause bitmask against that plane: match_labels and In are ANY over the
# named pair bits, NotIn is NONE over them, Exists / DoesNotExist are ANY /
# NONE over all pair bits of the key. The (S, P) matrix is one device
# program: per-clause hits, then the violations summed per selector by
# ``index_add_``. The planes and masks are built on the host, as the JAX
# package builds them; the caller (ops/feasibility.affinity_match_matrix)
# probe-checks cells against the scalar matches() oracle.

_AFFINITY_MATRIX_CACHE: dict = {}
_AFFINITY_MATRIX_CACHE_CAP = 64
# elements of the (C, P, words) intermediate one step of the program holds:
# the word axis is walked in slices so a 1,024 × 4,096 matrix stays bounded
_AFFINITY_STEP_ELEMS = 1 << 26
AFFINITY_RUNS = 0  # device programs run since import (cache hits excluded)


def affinity_planes(sel_sigs: tuple, peer_sigs: tuple) -> Optional[tuple]:
    """Host encoding of one matrix: ``(peer_plane (Ppad, W), cmask (Cpad,
    W), ckind (Cpad,), csel (Cpad,))`` as uint32 / int32 arrays, or None
    when every selector is empty (the matrix is all True). ``ckind`` is 0
    for ANY-of, 1 for NONE-of; padding clauses are NONE over the empty
    mask, charged to selector 0, never a violation."""
    pair_vocab: Dict[tuple, int] = {}
    key_bits: Dict[str, list] = {}
    for sig in peer_sigs:
        for kv in sig:
            if kv not in pair_vocab:
                pair_vocab[kv] = len(pair_vocab)
                key_bits.setdefault(kv[0], []).append(pair_vocab[kv])
    W = _words(len(pair_vocab))
    P = len(peer_sigs)
    Ppad = max(8, 1 << (P - 1).bit_length())
    peer_plane = np.zeros((Ppad, W), np.uint32)
    for p, sig in enumerate(peer_sigs):
        for kv in sig:
            _set_bit(peer_plane, (p,), pair_vocab[kv])

    def clause_mask(bits) -> np.ndarray:
        row = np.zeros((W,), np.uint32)
        for b in bits:
            _set_bit(row, (), b)
        return row

    masks: List[np.ndarray] = []
    kinds: List[int] = []
    sel_of: List[int] = []
    for s, (match_labels, exprs) in enumerate(sel_sigs):
        for kv in match_labels:
            b = pair_vocab.get(kv)
            # an unseen pair matches no peer: the empty ANY mask makes the
            # clause (and the row's cells) False, as the scalar oracle does
            masks.append(clause_mask([] if b is None else [b]))
            kinds.append(0)
            sel_of.append(s)
        for key, op, values in exprs:
            if op in ("In", "NotIn"):
                bits = [pair_vocab[(key, v)] for v in values if (key, v) in pair_vocab]
                masks.append(clause_mask(bits))
                kinds.append(0 if op == "In" else 1)
            else:  # Exists / DoesNotExist: ANY / NONE over the key's pairs
                masks.append(clause_mask(key_bits.get(key, [])))
                kinds.append(0 if op == "Exists" else 1)
            sel_of.append(s)
    C = len(masks)
    if C == 0:
        return None
    Cpad = -(-C // 8) * 8
    while len(masks) < Cpad:
        masks.append(np.zeros((W,), np.uint32))
        kinds.append(1)
        sel_of.append(0)
    return (peer_plane, np.stack(masks), np.asarray(kinds, np.int32),
            np.asarray(sel_of, np.int32))


def affinity_program(peer_plane, cmask, ckind, csel, S: int) -> torch.Tensor:
    """The device program on int32 bit patterns: (Cpad, Ppad) clause hits
    (any shared bit), ``ok`` as ANY or NONE by the clause kind, violations
    summed per selector with ``index_add_`` on int32 → (S, Ppad) bool."""
    C, P, W = cmask.shape[0], peer_plane.shape[0], peer_plane.shape[1]
    step = max(1, _AFFINITY_STEP_ELEMS // max(1, C * P))
    hit = torch.zeros((C, P), dtype=torch.bool, device=peer_plane.device)
    for w0 in range(0, W, step):
        w1 = min(W, w0 + step)
        hit |= ((peer_plane[None, :, w0:w1] & cmask[:, None, w0:w1]) != 0).any(-1)
    ok = torch.where(ckind[:, None] == 0, hit, ~hit)
    viol = torch.zeros((S, P), dtype=torch.int32, device=peer_plane.device)
    viol.index_add_(0, csel.long(), (~ok).to(torch.int32))
    return viol == 0


def affinity_matrix_plain(sel_sigs: tuple, peer_sigs: tuple) -> np.ndarray:
    """The same algebra in numpy on the same host encoding: the plain twin
    the tests hold the device program against. No path of the provisioner
    runs it."""
    S, P = len(sel_sigs), len(peer_sigs)
    enc = affinity_planes(sel_sigs, peer_sigs)
    if enc is None:
        return np.ones((S, P), bool)
    peer_plane, cmask, ckind, csel = enc
    hit = ((peer_plane[None, :, :] & cmask[:, None, :]) != 0).any(-1)
    ok = np.where(ckind[:, None] == 0, hit, ~hit)
    viol = np.zeros((S, peer_plane.shape[0]), np.int32)
    np.add.at(viol, csel, (~ok).astype(np.int32))
    return (viol == 0)[:, :P]


def affinity_matrix(sel_sigs: tuple, peer_sigs: tuple,
                    device: DeviceLike = None) -> np.ndarray:
    """(S, P) match matrix of pre-validated selector signatures (the
    feasibility layer's ``selector_signature`` tuples: only In / NotIn /
    Exists / DoesNotExist reach here) against peer label signatures,
    computed on ``device`` (default: the CUDA device; ``"cpu"`` runs the
    same torch ops on the CPU) and cached per (selectors, peers). The
    result is read-only."""
    global AFFINITY_RUNS
    ckey = (sel_sigs, peer_sigs)
    with _LOCK:
        hit = _AFFINITY_MATRIX_CACHE.get(ckey)
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    dev = resolve_device(device)
    S, P = len(sel_sigs), len(peer_sigs)
    enc = affinity_planes(sel_sigs, peer_sigs)
    if enc is None:
        # every selector is empty: matches() is True everywhere
        mat = np.ones((S, P), bool)
    else:
        planes_d = to_device_int32(list(enc), dev)
        out = affinity_program(*planes_d, S)
        with _LOCK:
            AFFINITY_RUNS += 1
        mat = out[:, :P].cpu().numpy()
    mat = np.asarray(mat, bool)
    mat.flags.writeable = False
    FILTER_DEVICE_SECONDS.observe(time.perf_counter() - t0, stage="affinity")
    with _LOCK:
        if len(_AFFINITY_MATRIX_CACHE) >= _AFFINITY_MATRIX_CACHE_CAP:
            _AFFINITY_MATRIX_CACHE.pop(next(iter(_AFFINITY_MATRIX_CACHE)))
        _AFFINITY_MATRIX_CACHE[ckey] = mat
    return mat


def clear_affinity_cache() -> None:
    with _LOCK:
        _AFFINITY_MATRIX_CACHE.clear()
