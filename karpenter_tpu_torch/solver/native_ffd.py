"""Host FFD solve on the native C++ ring (native/ffd.cc).

Same contract as models/ffd.solve_ffd_numpy: encode → pack → decode, exact
node parity with the per-pod Go-semantics oracle (host_ffd.pack). The solo
solve and a window under ``SolverConfig.device_min_pods`` pods answer here
instead of launching the card (solver/solve.py, solver/batch_solve.py).

A result of None means the encoding's own limits were reached (no exact
encoding, the record buffer overflowed), and the next executor answers. A
ring that cannot be built or loaded raises (``native.load``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch import native
from karpenter_tpu_torch.models.ffd import _decode, encode_prices
from karpenter_tpu_torch.ops.encode import encode
from karpenter_tpu_torch.solver.host_ffd import (
    HostSolveResult, MAX_INSTANCE_TYPES, Packable, R_PODS, Vec,
)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _inputs(enc):
    S, T = enc.num_shapes, enc.num_types
    return (np.ascontiguousarray(enc.shapes[:S], np.int64),
            np.ascontiguousarray(enc.counts[:S], np.int64),
            np.ascontiguousarray(enc.totals[:T], np.int64),
            np.ascontiguousarray(enc.reserved0[:T], np.int64))


def solve_ffd_native(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    max_instance_types: int = MAX_INSTANCE_TYPES,
    prices=None,                 # per-packable effective $/h (cost mode)
    cost_tiebreak: bool = False,
    enc=None,                    # precomputed encoding (unpadded or padded)
) -> Optional[HostSolveResult]:
    """The shape-level ring; None when no exact encoding exists or the
    record buffer overflowed."""
    lib = native.load()
    if not packables:
        return HostSolveResult(packings=[], unschedulable=list(pod_ids))
    if enc is None:
        # pad=False: host kernels take exact-size arrays, no cardinality limit
        enc = encode(pod_vecs, pod_ids, packables, pad=False)
    if enc is None:
        return None

    S, T = enc.num_shapes, enc.num_types
    shapes, counts, totals, reserved0 = _inputs(enc)

    # every record commits >=1 pod and every drop event consumes a shape,
    # so pods + S is a TRUE upper bound on records. (A min() with an
    # S*T-derived term used to sit here "for tiny problems" — at tiny
    # S*T it became a CAP instead of a generosity: 227 pods over 2 shapes
    # x 2 types need ~115 records but were capped at 32, so the kernel
    # reported overflow and silently declined. Found by the 2,000-case
    # fuzz soak, case 1897.) The dense (records x S) output buffer is
    # clamped to a 512 MiB budget rather than declining upfront: the
    # fast-forward keeps ACTUAL record counts far below the worst case,
    # so the kernel usually fits the clamp — and if it genuinely doesn't,
    # it reports overflow (-1) and the next executor answers, as on any
    # other decline.
    budget_records = (512 * 1024 * 1024) // (S * 8)
    max_records = min(len(pod_vecs) + S, budget_records) + 16
    out_chosen = np.zeros(max_records, np.int64)
    out_qty = np.zeros(max_records, np.int64)
    out_packed = np.zeros((max_records, S), np.int64)
    out_dropped = np.zeros(S, np.int64)

    if cost_tiebreak and prices is not None:
        prices_arr = np.ascontiguousarray(encode_prices(prices, T), np.int64)
        prices_ptr, cost_flag = _ptr(prices_arr), 1
    else:
        prices_ptr, cost_flag = None, 0

    n = lib.kt_ffd_pack(
        _ptr(shapes), _ptr(counts), _ptr(totals), _ptr(reserved0),
        S, T, shapes.shape[1], int(enc.pods_unit), R_PODS,
        _ptr(out_chosen), _ptr(out_qty), _ptr(out_packed), _ptr(out_dropped),
        max_records, prices_ptr, cost_flag)
    if n < 0:
        return None  # record buffer overflow: the next executor answers

    records = [(int(out_chosen[i]), int(out_qty[i]), out_packed[i]) for i in range(n)]
    return _decode(enc, records, out_dropped, packables, max_instance_types)


# Above this many distinct shapes the shape-level greedy (dense S×T pass per
# node, fast-forward rarely collapsing anything) loses to the per-pod
# kernel's is_full_for early exit + active-shape skip list.
PER_POD_SHAPE_CROSSOVER = 2048


def solve_ffd_native_auto(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    max_instance_types: int = MAX_INSTANCE_TYPES,
    prices=None,
    cost_tiebreak: bool = False,
    enc=None,                    # precomputed UNPADDED encoding
) -> Optional[HostSolveResult]:
    """Route to the C++ executor suited to the problem's shape cardinality.
    The per-pod kernel has no cost-tie-break mode, so cost solves always
    take the shape-level kernel. If the shape-level kernel declines (its
    dense record output has a memory guard), the per-pod kernel's sparse
    ABI answers instead."""
    per_pod_tried = False
    if not cost_tiebreak:
        distinct = enc.num_shapes if enc is not None else len(set(pod_vecs))
        if distinct > PER_POD_SHAPE_CROSSOVER:
            per_pod_tried = True
            result = solve_ffd_per_pod_native(
                pod_vecs, pod_ids, packables, max_instance_types, enc=enc)
            if result is not None:
                return result
    result = solve_ffd_native(pod_vecs, pod_ids, packables, max_instance_types,
                              prices=prices, cost_tiebreak=cost_tiebreak, enc=enc)
    if result is None and not cost_tiebreak and not per_pod_tried:
        result = solve_ffd_per_pod_native(
            pod_vecs, pod_ids, packables, max_instance_types, enc=enc)
    return result


def solve_ffd_per_pod_native(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    max_instance_types: int = MAX_INSTANCE_TYPES,
    enc=None,                    # precomputed encoding (unpadded or padded)
) -> Optional[HostSolveResult]:
    """The per-POD Go-semantics oracle on the C++ kernel
    (kt_ffd_pack_per_pod): the algorithm of host_ffd.pack (packer.go:109-141
    transcribed), fast enough to verify 50k-pod solves. One record per node
    (no fast-forward), in a sparse ABI: each node's (shape, count) pairs
    between its offsets."""
    lib = native.load()
    if not packables:
        return HostSolveResult(packings=[], unschedulable=list(pod_ids))
    if enc is None:
        # pad=False: no shape-cardinality limit
        enc = encode(pod_vecs, pod_ids, packables, pad=False)
    if enc is None:
        return None

    S, T = enc.num_shapes, enc.num_types
    shapes, counts, totals, reserved0 = _inputs(enc)

    max_records = len(pod_vecs) + 1  # one record per node; nodes ≤ pods
    max_pairs = len(pod_vecs) + S + 1  # Σ pods-per-node ≤ pods (sparse ABI)
    out_chosen = np.zeros(max_records, np.int64)
    out_offsets = np.zeros(max_records + 1, np.int64)
    out_pair_shape = np.zeros(max_pairs, np.int64)
    out_pair_count = np.zeros(max_pairs, np.int64)
    out_dropped = np.zeros(S, np.int64)

    n = lib.kt_ffd_pack_per_pod(
        _ptr(shapes), _ptr(counts), _ptr(totals), _ptr(reserved0),
        S, T, shapes.shape[1], int(enc.pods_unit), R_PODS,
        _ptr(out_chosen), _ptr(out_offsets), _ptr(out_pair_shape),
        _ptr(out_pair_count), _ptr(out_dropped), max_records, max_pairs)
    if n < 0:
        return None

    records = [
        (int(out_chosen[i]), 1,
         [(int(out_pair_shape[j]), int(out_pair_count[j]))
          for j in range(int(out_offsets[i]), int(out_offsets[i + 1]))])
        for i in range(n)
    ]
    return _decode(enc, records, out_dropped, packables, max_instance_types)
