"""Encode a packing problem into dense int32 arrays.

Pods collapse to unique resource *shapes* with counts: the greedy pack then
walks shapes (dozens to thousands) instead of pods (tens of thousands),
vectorized over all instance types at once.

Quantities are nano-unit integers on the host; each resource dimension is
divided by the GCD of all its values so realistic problems (milli CPUs,
Mi-aligned memory) fit int32 exactly. If any dimension cannot be encoded
exactly below 2**31, encoding fails and the caller falls back to the host
oracle — exactness is never traded for speed.

A port of the JAX package's ``ops/encode.py``, with its two window caches:
the delta-marshal arena (:class:`MarshalArena`, which the adapter's
``marshal_pods_interned`` gathers a window's interned shape ids from) and
the versioned catalog encoding (:func:`_catalog_encoding`, whose content
token lets the device ring skip a copy it already holds). Their counts
feed the JAX package's ``karpenter_marshal_*`` and
``karpenter_catalog_encoding_rebuilds_total`` series (metrics/marshal.py);
``MarshalArena.stats()`` and :data:`CATALOG_REBUILDS` keep the same counts
as attributes.
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.metrics.marshal import (
    CATALOG_ENCODING_REBUILDS_TOTAL, MARSHAL_DELTA_FRACTION,
    MARSHAL_ROW_CACHE_EVICTIONS_TOTAL, MARSHAL_ROW_CACHE_HITS_TOTAL,
    MARSHAL_ROW_CACHE_MISSES_TOTAL,
)
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES, Packable, R_PODS, Vec

INT32_LIMIT = 2**31 - 1

# Shapes and types are padded to these sizes, so a kernel sees one of a
# small set of shapes. Above the largest bucket the problem goes to the host.
SHAPE_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                 16384, 32768)
TYPE_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    for b in buckets:
        if n <= b:
            return b
    return None


@dataclass
class EncodedProblem:
    shapes: np.ndarray        # (S, R) int32, reserve semantics (pods includes +1)
    counts: np.ndarray        # (S,) int32
    totals: np.ndarray        # (T, R) int32
    reserved0: np.ndarray     # (T, R) int32
    valid: np.ndarray         # (T,) bool
    last_valid: int           # index of the largest viable type
    num_shapes: int           # unpadded S
    num_types: int            # unpadded T
    shape_pods: List[List[int]]   # pod ids per shape, pack order
    scales: Tuple[int, ...]   # per-resource divisor (nano → device units)
    pods_unit: int = 1        # one pod in device units (10**9 / scales[R_PODS])
    # content identity of the catalog-side arrays (totals/reserved0/valid):
    # set when the encoding came through the versioned catalog cache, so the
    # device ring can skip copying bytes it already holds. None = unversioned
    # (every fill copies).
    catalog_token: Optional[tuple] = None


def _gcd_scale(columns: List[List[int]]) -> Optional[Tuple[int, ...]]:
    scales = []
    for vals in columns:
        g = 0
        for v in vals:
            g = math.gcd(g, v)
        g = g or 1
        if max((v // g for v in vals), default=0) > INT32_LIMIT:
            return None
        scales.append(g)
    return tuple(scales)


def _dedupe_interned(sids: np.ndarray, gen: int, pod_ids: Sequence[int]):
    """Vectorized pod→shape dedupe over interned shape ids. Returns
    (vecs descending, counts, pod-id groups) with the exact semantics of
    the dict path (shapes descending by full resource vector, pod ids
    within a shape in batch order), or None when the intern table rolled
    over under the caller (generation mismatch: fall back)."""
    from karpenter_tpu_torch.solver.adapter import interned_vecs_snapshot

    sids = np.asarray(sids, dtype=np.int64)
    uniq, inverse, cnts = np.unique(sids, return_inverse=True, return_counts=True)
    uniq_vecs = interned_vecs_snapshot(uniq, gen)
    if uniq_vecs is None:
        return None
    order = sorted(range(len(uniq)), key=lambda i: tuple(-v for v in uniq_vecs[i]))
    order_a = np.asarray(order, np.int64)
    pos = np.empty(len(uniq), np.int64)
    pos[order_a] = np.arange(len(uniq), dtype=np.int64)
    shape_of_pod = pos[inverse.reshape(-1)]
    sort_order = np.argsort(shape_of_pod, kind="stable")
    pid_sorted = np.asarray(pod_ids, dtype=np.int64)[sort_order]
    counts_ord = cnts[order_a]
    bounds = np.cumsum(counts_ord)[:-1]
    groups = [seg.tolist() for seg in np.split(pid_sorted, bounds)]
    return [uniq_vecs[i] for i in order], counts_ord.tolist(), groups


# -- delta-marshal row arena -------------------------------------------------
#
# Consecutive windows share almost all of their pods, so re-deriving
# (interned shape id, special mask) per pod per window is rework. The arena
# pins each distinct marshal row, (sid, special), in numpy columns; a pod
# caches its row index (and the arena generation it was minted in) on its
# __dict__, and a window's sid array is ONE numpy gather over the cached
# rows. Only new or churned signatures pay the Python marshal.
#
# Invalidation is generational, never in place: the arena generation bumps
# whenever (a) the adapter's shape intern table rebinds (cached sids would
# dangle), (b) the feasibility vocab rebinds, or (c) the row capacity
# overflows. A bump voids every cached per-pod row at once (the mismatch
# makes them misses), so a stale row is never gathered. Generations come
# from one process-wide counter (:func:`_next_generation`), so a fresh
# arena starts past every generation an earlier arena handed out: a row
# cached under a dropped arena never matches the arena that replaced it.


def _arena_max_from_env() -> int:
    raw = os.environ.get("KARPENTER_MARSHAL_ARENA_MAX", "")
    if not raw.strip():
        return 1 << 20
    try:
        return max(1, int(raw.strip()))
    except ValueError:
        logging.getLogger("karpenter.ops.encode").warning(
            "KARPENTER_MARSHAL_ARENA_MAX=%r is not an integer; using default %d",
            raw, 1 << 20)
        return 1 << 20


class MarshalArena:
    """Pinned, signature-keyed marshal rows (see the block comment above).
    ``hits``, ``misses`` and ``evictions`` count pod rows over the arena's
    life; ``delta_fraction`` is the last window's share of misses."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = cap if cap is not None else _arena_max_from_env()
        self.generation = _next_generation()
        self._lock = threading.Lock()
        size = max(min(4096, self.cap), 1)
        self._sids = np.empty(size, np.int64)
        self._special = np.empty(size, np.int64)
        self._rows: dict = {}          # (sid, special) -> row index
        self._n = 0
        self._adapter_gen: Optional[int] = None
        self._vocab_gen: Optional[int] = None
        self.hits = self.misses = self.evictions = 0
        self.delta_fraction = 0.0

    def _reset_locked(self, adapter_gen, vocab_gen) -> None:
        if self._n:
            MARSHAL_ROW_CACHE_EVICTIONS_TOTAL.inc(amount=float(self._n))
        self.evictions += self._n
        self._rows.clear()
        self._n = 0
        self.generation = _next_generation()
        self._adapter_gen = adapter_gen
        self._vocab_gen = vocab_gen

    def begin_window(self, adapter_gen: int) -> int:
        """Validate against the live intern generations (the adapter's shape
        table and the feasibility vocab); a mismatch resets the arena.
        Returns the arena generation cached pod rows must carry to count as
        hits."""
        from karpenter_tpu_torch.ops import feasibility

        vocab_gen = feasibility.intern_table_stats()[1]
        with self._lock:
            if self._adapter_gen != adapter_gen or self._vocab_gen != vocab_gen:
                self._reset_locked(adapter_gen, vocab_gen)
            return self.generation

    def assign(self, sid: int, special: int, adapter_gen: int) -> Tuple[int, int]:
        """Row index for (sid, special), minting one on first sight.
        Returns (row, generation); the generation may have moved past the
        caller's ``begin_window`` (capacity rollover, or the adapter table
        rebound mid-window), and then every row index the caller collected
        is void and it must restart."""
        with self._lock:
            if adapter_gen != self._adapter_gen:
                self._reset_locked(adapter_gen, self._vocab_gen)
            row = self._rows.get((sid, special))
            if row is None:
                if self._n >= self.cap:
                    self._reset_locked(self._adapter_gen, self._vocab_gen)
                n = self._n
                if n >= self._sids.shape[0]:
                    grown = min(max(self._sids.shape[0] * 2, 1024), self.cap)
                    self._sids = np.resize(self._sids, grown)
                    self._special = np.resize(self._special, grown)
                self._sids[n] = sid
                self._special[n] = special
                self._rows[(sid, special)] = n
                self._n = n + 1
                row = n
            return row, self.generation

    def gather(self, rows: np.ndarray,
               generation: int) -> Optional[Tuple[np.ndarray, int, int]]:
        """(sid array, OR of the special masks, adapter generation) for a
        window's row indices, or None when the arena generation moved past
        the caller's (a concurrent reset): the caller restarts its window."""
        with self._lock:
            if generation != self.generation:
                return None
            sids = self._sids[rows]
            special = int(np.bitwise_or.reduce(self._special[rows])) if rows.size else 0
            return sids, special, self._adapter_gen

    def note_window(self, hits: int, misses: int) -> None:
        if hits:
            MARSHAL_ROW_CACHE_HITS_TOTAL.inc(amount=float(hits))
        if misses:
            MARSHAL_ROW_CACHE_MISSES_TOTAL.inc(amount=float(misses))
        if hits + misses:
            MARSHAL_DELTA_FRACTION.set(misses / (hits + misses))
        with self._lock:
            self.hits += hits
            self.misses += misses
            if hits + misses:
                self.delta_fraction = misses / (hits + misses)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"rows": self._n, "generation": self.generation,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


_ARENA: Optional[MarshalArena] = None
_ARENA_LOCK = threading.Lock()
# arena generations, unique across every arena of the process
_GENERATIONS = itertools.count(1)
_GENERATION_LOCK = threading.Lock()


def _next_generation() -> int:
    with _GENERATION_LOCK:
        return next(_GENERATIONS)


def marshal_arena() -> MarshalArena:
    """The process-wide arena (marshal rows are process-wide state, like the
    shape intern table they index into)."""
    global _ARENA
    with _ARENA_LOCK:
        if _ARENA is None:
            _ARENA = MarshalArena()
        return _ARENA


def reset_marshal_arena() -> None:
    """Drop the process arena. The next arena's generations start past
    every generation this one handed out, so every pod row cached under it
    misses."""
    global _ARENA
    with _ARENA_LOCK:
        _ARENA = None


# -- versioned catalog encoding cache ----------------------------------------
#
# The catalog-side arrays (totals/reserved0/valid) are a pure function of
# (packables version, GCD scales, padded T): the version identifies the
# exact packable list (adapter.build_packables_versioned), and the scales
# couple the catalog columns to the pod columns of the same window.
# Steady-state windows repeat the key, so they reuse the shared read-only
# arrays and inherit a content token the device ring uses to skip the
# host→device copy (solver/pipeline.DeviceRing.fill).

_CATALOG_ENC_LOCK = threading.Lock()
_CATALOG_ENC_CACHE: dict = {}
_CATALOG_ENC_CAP = 32
CATALOG_REBUILDS = 0  # catalog encodings built (cache misses) since import


def _catalog_arrays(packables: Sequence[Packable], scales: Tuple[int, ...], TB: int):
    totals = np.zeros((TB, NUM_RESOURCES), np.int32)
    reserved0 = np.zeros((TB, NUM_RESOURCES), np.int32)
    valid = np.zeros((TB,), bool)
    for t, p in enumerate(packables):
        totals[t] = [v // g for v, g in zip(p.total, scales)]
        reserved0[t] = [v // g for v, g in zip(p.reserved, scales)]
        valid[t] = True
    return totals, reserved0, valid


def _catalog_encoding(catalog_version: int, scales: Tuple[int, ...],
                      packables: Sequence[Packable], TB: int):
    """(totals, reserved0, valid, token) at padded size ``TB``: shared
    read-only arrays, rebuilt (and counted) only on a fresh key."""
    global CATALOG_REBUILDS
    key = (catalog_version, scales, TB)
    with _CATALOG_ENC_LOCK:
        hit = _CATALOG_ENC_CACHE.get(key)
    if hit is not None:
        return hit
    arrays = _catalog_arrays(packables, scales, TB)
    for arr in arrays:
        arr.setflags(write=False)
    entry = (*arrays, ("cat", catalog_version, scales, TB))
    CATALOG_ENCODING_REBUILDS_TOTAL.inc()
    with _CATALOG_ENC_LOCK:
        CATALOG_REBUILDS += 1
        if len(_CATALOG_ENC_CACHE) >= _CATALOG_ENC_CAP:
            _CATALOG_ENC_CACHE.pop(next(iter(_CATALOG_ENC_CACHE)))
        _CATALOG_ENC_CACHE[key] = entry
    return entry


def clear_catalog_encoding_cache() -> None:
    """Make the next window rebuild (and count) its catalog encoding."""
    with _CATALOG_ENC_LOCK:
        _CATALOG_ENC_CACHE.clear()


def encode(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    pad: bool = True,
    sids: Optional[Tuple[np.ndarray, int]] = None,
    catalog_version: Optional[int] = None,
) -> Optional[EncodedProblem]:
    """Returns None when the problem can't be encoded exactly (host fallback).

    ``pod_vecs`` may be in any order: pods dedupe to shapes by hashing and
    only the shape set is sorted, descending by full resource vector — the
    order the host oracle sorts pods in. ``packables`` must be ascending
    (adapter.build_packables output). Nano-unit arithmetic stays in Python
    ints until after GCD scaling (nano memory overflows int64 beyond ~9Gi).

    ``pad=True`` pads to the SHAPE/TYPE buckets and fails beyond the largest
    bucket; ``pad=False`` emits exact-size arrays (see :func:`pad_encoding`).

    ``sids`` (the adapter's ``marshal_pods_interned`` ids, ``(int64 array,
    generation)``) dedupes pods with np.unique instead of a dict over the
    pod axis, with the same order and grouping; an intern rollover under
    the caller falls back to the dict. ``catalog_version`` (from
    ``adapter.build_packables_versioned``) takes the catalog arrays from
    the versioned cache and sets ``catalog_token``.
    """
    if not packables:
        return None

    deduped = None
    if sids is not None and len(sids[0]) == len(pod_vecs):
        deduped = _dedupe_interned(sids[0], sids[1], pod_ids)
    if deduped is not None:
        ordered, counts_list, groups = deduped
    else:
        by_vec: Dict[Vec, List[int]] = {}
        for vec, pid in zip(pod_vecs, pod_ids):
            by_vec.setdefault(vec, []).append(pid)
        items = sorted(by_vec.items(), key=lambda kv: tuple(-v for v in kv[0]))
        ordered = [vec for vec, _ in items]
        counts_list = [len(pids) for _, pids in items]
        groups = [pids for _, pids in items]
    shape_vecs: List[List[int]] = []
    counts: List[int] = []
    shape_pods: List[List[int]] = []
    for vec, n, pids in zip(ordered, counts_list, groups):
        reserve_vec = list(vec)
        reserve_vec[R_PODS] += 10**9  # implicit pods:1 in nano units
        shape_vecs.append(reserve_vec)
        counts.append(n)
        shape_pods.append(pids)

    S, T = len(shape_vecs), len(packables)
    SB, TB = S, T
    if pad:
        SB, TB = bucket(S, SHAPE_BUCKETS), bucket(T, TYPE_BUCKETS)
        if SB is None or TB is None:
            return None

    # -- per-resource exact scaling -----------------------------------------
    columns = []
    for r in range(NUM_RESOURCES):
        col = [sv[r] for sv in shape_vecs]
        col += [p.total[r] for p in packables]
        col += [p.reserved[r] for p in packables]
        if r == R_PODS:
            # the kernel subtracts the implicit pods:1 for the early-exit
            # vector, so the scale must divide one pod exactly
            col.append(10**9)
        columns.append(col)
    scales = _gcd_scale(columns)
    if scales is None:
        return None

    shapes = np.zeros((SB, NUM_RESOURCES), np.int32)
    counts_a = np.zeros((SB,), np.int32)
    for s in range(S):
        shapes[s] = [v // g for v, g in zip(shape_vecs[s], scales)]
        counts_a[s] = counts[s]
    token: Optional[tuple] = None
    if catalog_version is not None:
        totals, reserved0, valid, token = _catalog_encoding(
            catalog_version, scales, packables, TB)
    else:
        totals, reserved0, valid = _catalog_arrays(packables, scales, TB)

    return EncodedProblem(
        shapes=shapes, counts=counts_a, totals=totals, reserved0=reserved0,
        valid=valid, last_valid=T - 1, num_shapes=S, num_types=T,
        shape_pods=shape_pods, scales=scales,
        pods_unit=10**9 // scales[R_PODS], catalog_token=token,
    )


def pad_encoding(enc: EncodedProblem) -> Optional[EncodedProblem]:
    """Pad an exact-size encoding (``encode(pad=False)``) to the buckets;
    None above the largest bucket. Lets the solve path encode once and serve
    both the device (padded) and the host fallback."""
    S, T = enc.num_shapes, enc.num_types
    if enc.shapes.shape[0] != S or enc.totals.shape[0] != T:
        return enc  # already padded
    SB, TB = bucket(S, SHAPE_BUCKETS), bucket(T, TYPE_BUCKETS)
    if SB is None or TB is None:
        return None
    shapes = np.zeros((SB, NUM_RESOURCES), np.int32)
    counts = np.zeros((SB,), np.int32)
    totals = np.zeros((TB, NUM_RESOURCES), np.int32)
    reserved0 = np.zeros((TB, NUM_RESOURCES), np.int32)
    valid = np.zeros((TB,), bool)
    shapes[:S] = enc.shapes
    counts[:S] = enc.counts
    totals[:T] = enc.totals
    reserved0[:T] = enc.reserved0
    valid[:T] = enc.valid
    return EncodedProblem(
        shapes=shapes, counts=counts, totals=totals, reserved0=reserved0,
        valid=valid, last_valid=enc.last_valid, num_shapes=S, num_types=T,
        shape_pods=enc.shape_pods, scales=enc.scales,
        pods_unit=enc.pods_unit,
        # the padded catalog content is a pure function of the exact content
        # and the bucket, so the identity extends rather than resets
        catalog_token=(enc.catalog_token + ("pad", TB)
                       if enc.catalog_token is not None else None),
    )


def encoding_from_arrays(shapes, counts, totals, reserved0, valid,
                         last_valid: int, pods_unit: int,
                         shape_pods: Sequence[Sequence[int]],
                         num_shapes: int, num_types: int,
                         scales: Tuple[int, ...] = ()) -> EncodedProblem:
    """An :class:`EncodedProblem` from plain arrays — the numpy fields of an
    encoding made elsewhere (another implementation of this encoder, a file),
    so both sides of a comparison solve the same encoded problem."""
    return EncodedProblem(
        shapes=np.ascontiguousarray(shapes, np.int32),
        counts=np.ascontiguousarray(counts, np.int32),
        totals=np.ascontiguousarray(totals, np.int32),
        reserved0=np.ascontiguousarray(reserved0, np.int32),
        valid=np.ascontiguousarray(valid, bool),
        last_valid=int(last_valid), num_shapes=int(num_shapes),
        num_types=int(num_types),
        shape_pods=[list(p) for p in shape_pods], scales=tuple(scales),
        pods_unit=int(pods_unit),
    )
