"""Encode a packing problem into dense int32 arrays.

Pods collapse to unique resource *shapes* with counts: the greedy pack then
walks shapes (dozens to thousands) instead of pods (tens of thousands),
vectorized over all instance types at once.

Quantities are nano-unit integers on the host; each resource dimension is
divided by the GCD of all its values so realistic problems (milli CPUs,
Mi-aligned memory) fit int32 exactly. If any dimension cannot be encoded
exactly below 2**31, encoding fails and the caller falls back to the host
oracle — exactness is never traded for speed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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


def encode(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    pad: bool = True,
) -> Optional[EncodedProblem]:
    """Returns None when the problem can't be encoded exactly (host fallback).

    ``pod_vecs`` may be in any order: pods dedupe to shapes by hashing and
    only the shape set is sorted, descending by full resource vector — the
    order the host oracle sorts pods in. ``packables`` must be ascending
    (adapter.build_packables output). Nano-unit arithmetic stays in Python
    ints until after GCD scaling (nano memory overflows int64 beyond ~9Gi).

    ``pad=True`` pads to the SHAPE/TYPE buckets and fails beyond the largest
    bucket; ``pad=False`` emits exact-size arrays (see :func:`pad_encoding`).
    """
    if not packables:
        return None

    by_vec: Dict[Vec, List[int]] = {}
    for vec, pid in zip(pod_vecs, pod_ids):
        by_vec.setdefault(vec, []).append(pid)
    items = sorted(by_vec.items(), key=lambda kv: tuple(-v for v in kv[0]))
    shape_vecs: List[List[int]] = []
    counts: List[int] = []
    shape_pods: List[List[int]] = []
    for vec, pids in items:
        reserve_vec = list(vec)
        reserve_vec[R_PODS] += 10**9  # implicit pods:1 in nano units
        shape_vecs.append(reserve_vec)
        counts.append(len(pids))
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
    totals = np.zeros((TB, NUM_RESOURCES), np.int32)
    reserved0 = np.zeros((TB, NUM_RESOURCES), np.int32)
    valid = np.zeros((TB,), bool)
    for t, p in enumerate(packables):
        totals[t] = [v // g for v, g in zip(p.total, scales)]
        reserved0[t] = [v // g for v, g in zip(p.reserved, scales)]
        valid[t] = True

    return EncodedProblem(
        shapes=shapes, counts=counts_a, totals=totals, reserved0=reserved0,
        valid=valid, last_valid=T - 1, num_shapes=S, num_types=T,
        shape_pods=shape_pods, scales=scales,
        pods_unit=10**9 // scales[R_PODS],
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
