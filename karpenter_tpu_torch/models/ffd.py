"""Device FFD: encode → pack_chunk loop → decode.

Exact parity with the reference Go packer. Produces the same
HostSolveResult structure as the host oracle, so callers and tests are
representation-agnostic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.backend import DeviceLike, resolve_device
from karpenter_tpu_torch.ops.encode import EncodedProblem, encode, pad_encoding
from karpenter_tpu_torch.solver.host_ffd import (
    HostPacking, HostSolveResult, Packable, R_PODS, Vec, instance_options,
)

DEFAULT_CHUNK_ITERS = 64
MAX_CHUNKS = 4096  # hard safety valve; each iteration provably makes progress
_INT32_MAX = 2**31 - 1


def device_args(enc: EncodedProblem, device: torch.device) -> tuple:
    """THE kernel argument tuple (shapes, counts, dropped, totals,
    reserved0, valid, last_valid, pods_unit) on ``device``; the two scalars
    stay Python ints."""
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    return (
        put(enc.shapes, torch.int32), put(enc.counts, torch.int32),
        torch.zeros(enc.counts.shape[0], dtype=torch.int32, device=device),
        put(enc.totals, torch.int32), put(enc.reserved0, torch.int32),
        put(enc.valid, torch.bool), int(enc.last_valid), int(enc.pods_unit),
    )


def encode_prices(prices, padded_t: int) -> np.ndarray:
    """Effective $/h per packable → (T_padded,) int32 micro-$ for the
    kernel's cost tie-break. Only the ordering matters on device; inf (no
    viable offering) and the padding both map to int32 max so they never
    win a tie."""
    out = np.full((padded_t,), _INT32_MAX, np.int32)
    for i, p in enumerate(prices):
        if p != float("inf"):
            out[i] = min(int(p * 1e6), _INT32_MAX)
    return out


def solve_ffd_device(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    chunk_iters: int = DEFAULT_CHUNK_ITERS,
    prices: Optional[Sequence[float]] = None,  # per-packable effective $/h
    cost_tiebreak: bool = False,
    enc: Optional[EncodedProblem] = None,  # precomputed (possibly unpadded)
    device: DeviceLike = None,
) -> Optional[HostSolveResult]:
    """Solve on ``device`` (default: the CUDA device; raises without one);
    None only when the problem is not encodable, before anything reaches
    the device (the caller falls back to the host oracle). A chunk loop
    that does not finish within ``MAX_CHUNKS`` raises. Pods may arrive
    unsorted; the same descending order as the host oracle is applied
    here.

    The fast-forward bound ``maxfit`` is computed once per solve on the
    device, the kernel's fill-log bound and walked-resource mask once from
    the host encoding. Each chunk runs ``chunk_iters`` node decisions in one
    kernel launch and one device→host copy; between chunks, compaction gathers
    the alive shapes into the next smaller shape bucket (ops/compact.py),
    with ``dropped`` passed as zeros and its delta scattered on the host.
    An exception from the kernel propagates."""
    from karpenter_tpu_torch.ops.compact import (
        compact_alive, scatter_dropped, sparse_record,
    )
    from karpenter_tpu_torch.ops.pack import compute_maxfit, unpack_flat
    from karpenter_tpu_torch.ops.pack_cuda import (
        compute_log_bound, pack_chunk, requested_mask,
    )

    dev = resolve_device(device)
    if not packables:
        return HostSolveResult(packings=[], unschedulable=list(pod_ids))
    if enc is None:
        enc = encode(pod_vecs, pod_ids, packables, pad=False)
    if enc is None:
        return None
    enc = pad_encoding(enc)
    if enc is None:
        return None

    S, L = enc.shapes.shape[0], chunk_iters
    use_cost = cost_tiebreak and prices is not None
    prices_d = None
    if use_cost:
        prices_d = torch.as_tensor(
            encode_prices(prices, enc.totals.shape[0])).to(dev)
    (shapes_d, counts_d, dropped_d, totals, reserved0, valid, last_valid,
     pods_unit) = device_args(enc, dev)
    maxfit_d = compute_maxfit(shapes_d, totals, reserved0, valid)
    maxfit_full = maxfit_d.cpu().numpy()
    log_bound = compute_log_bound(enc.totals, enc.reserved0, enc.valid,
                                  enc.pods_unit)
    used = requested_mask(enc.shapes)

    shapes_full = enc.shapes
    dropped_full = np.zeros(S, np.int64)
    records = []  # (chosen, qty, packed-vec | sparse [(shape, n), ...])
    perm = None
    S_cur = S
    for _ in range(MAX_CHUNKS):
        buf = pack_chunk(shapes_d, counts_d, dropped_d, totals, reserved0,
                         valid, last_valid, pods_unit, num_iters=L,
                         prices=prices_d, cost_tiebreak=use_cost,
                         maxfit=maxfit_d, log_bound=log_bound,
                         resource_mask=used).cpu().numpy()
        counts_h, dropped_h, done, chosen_h, q_h, packed_h = unpack_flat(
            buf, S_cur, L)
        for i in range(L):
            if q_h[i] > 0:
                rec = (packed_h[i] if perm is None
                       else sparse_record(packed_h[i], perm))
                records.append((int(chosen_h[i]), int(q_h[i]), rec))
        scatter_dropped(dropped_full, dropped_h, perm)
        if done:
            break
        c = compact_alive(counts_h, perm, shapes_full, maxfit_full)
        if c is not None:
            perm, S_cur = c.perm, c.num_shapes
            shapes_d = torch.as_tensor(c.shapes).to(dev)
            counts_d = torch.as_tensor(c.counts).to(dev)
            maxfit_d = torch.as_tensor(c.maxfit).to(dev)
        else:
            counts_d = torch.as_tensor(np.ascontiguousarray(counts_h)).to(dev)
        dropped_d = torch.zeros(S_cur, dtype=torch.int32, device=dev)
    else:
        # impossible by construction (every decision commits or drops);
        # reached only with a chunk_iters too small for the problem
        raise RuntimeError(
            f"solve_ffd_device did not converge in {MAX_CHUNKS} chunks of "
            f"{L} node decisions")

    return _decode(enc, records, dropped_full, packables)


def solve_ffd_numpy(
    pod_vecs: Sequence[Vec],
    pod_ids: Sequence[int],
    packables: Sequence[Packable],
    prices: Optional[Sequence[float]] = None,
    cost_tiebreak: bool = False,
) -> Optional[HostSolveResult]:
    """Numpy mirror of the device kernel, shape-level greedy with the same
    fast-forward. Fast enough for 50k-pod parity checks at low shape
    cardinality, where the naive per-pod oracle (host_ffd.pack) is
    O(pods × types × nodes)."""
    if not packables:
        return HostSolveResult(packings=[], unschedulable=list(pod_ids))
    enc = encode(pod_vecs, pod_ids, packables)
    if enc is None:
        return None

    S, T = enc.num_shapes, enc.num_types
    shapes = enc.shapes[:S].astype(np.int64)
    counts = enc.counts[:S].astype(np.int64).copy()
    totals = enc.totals[:T].astype(np.int64)
    reserved0 = enc.reserved0[:T].astype(np.int64)
    pods_one = np.zeros(shapes.shape[1], np.int64)
    pods_one[R_PODS] = enc.pods_unit

    avail0 = totals - reserved0
    # unrolled over R so peak memory stays (S, T), never (S, T, R)
    kfit0 = np.full((S, T), _INT32_MAX, np.int64)
    with np.errstate(divide="ignore"):
        for r in range(shapes.shape[1]):
            col = shapes[:, r][:, None]
            kr_r = np.where(col > 0, avail0[None, :, r] // np.maximum(col, 1),
                            _INT32_MAX)
            np.minimum(kfit0, kr_r, out=kfit0)
    maxfit = kfit0.max(axis=1)  # (S,)

    dropped = np.zeros(S, np.int64)
    records = []
    while counts.any():
        has = counts > 0
        largest = int(np.argmax(has))
        smallest = S - 1 - int(np.argmax(has[::-1]))
        smallest_fits = np.maximum(shapes[smallest] - pods_one, 0)

        reserved = reserved0.copy()
        stopped = np.zeros(T, bool)
        npacked = np.zeros(T, np.int64)
        k_all = np.zeros((S, T), np.int64)
        for s in range(largest, smallest + 1):
            if counts[s] == 0:
                continue
            if stopped.all():
                break  # stopped types never restart: the rest are no-ops
            active = ~stopped
            avail = totals - reserved
            kr = np.where(shapes[s][None, :] > 0,
                          avail // np.maximum(shapes[s][None, :], 1), _INT32_MAX)
            k = np.clip(kr.min(axis=1), 0, counts[s]) * active
            failure = active & (k < counts[s])
            reserved = reserved + k[:, None] * shapes[s][None, :]
            full = np.any((totals > 0) & (reserved + smallest_fits[None, :] >= totals), axis=1)
            npacked = npacked + k
            stopped |= failure & (full | (npacked == 0))
            k_all[s] = k

        max_pods = int(npacked[T - 1])
        if max_pods == 0:
            dropped[largest] += counts[largest]
            counts[largest] = 0
            continue
        tie = npacked == max_pods
        if cost_tiebreak and prices is not None:
            p_arr = encode_prices(prices, T).astype(np.int64)
            best_price = p_arr[tie].min()
            chosen = int(np.argmax(tie & (p_arr == best_price)))
        else:
            chosen = int(np.argmax(tie))
        # a copy, not a view: a record must not keep the (S, T) k_all alive
        packedv = k_all[:, chosen].copy()
        # fast-forward validity: every packed shape must stay STRICTLY
        # above maxfit through all repeats
        terms = np.where(packedv > 0,
                         (counts - maxfit - 1) // np.maximum(packedv, 1),
                         _INT32_MAX)
        q = int(max(1, 1 + terms.min()))
        counts = counts - q * packedv
        records.append((chosen, q, packedv))
    return _decode(enc, records, dropped, packables)


def _decode(
    enc: EncodedProblem,
    records,
    dropped: np.ndarray,
    packables: Sequence[Packable],
) -> HostSolveResult:
    """Materialize packings: map per-shape counts back to pod ids and dedupe
    by instance-option set (the hash dedupe in packer.go:130-139)."""
    queues = [list(p) for p in enc.shape_pods]
    heads = [0] * len(queues)
    packings: List[HostPacking] = []
    by_options = {}
    for chosen, qty, packedv in records:
        options = instance_options(packables, chosen)
        key = tuple(options)
        # iterate only the shapes this record touches; records carry either
        # a dense per-shape vector or a sparse [(shape, count), ...] list
        if isinstance(packedv, list):
            touched = packedv
        else:
            arr = np.asarray(packedv[:enc.num_shapes])
            touched = [(int(s), int(arr[s])) for s in np.flatnonzero(arr)]
        for _ in range(qty):
            node_pods: List[int] = []
            for s, n in touched:
                node_pods.extend(queues[s][heads[s]:heads[s] + n])
                heads[s] += n
            if key in by_options:
                main = by_options[key]
                main.node_quantity += 1
                main.pod_ids.append(node_pods)
            else:
                p = HostPacking(pod_ids=[node_pods], instance_type_indices=options)
                by_options[key] = p
                packings.append(p)
    unschedulable: List[int] = []
    for s in range(enc.num_shapes):
        n = int(dropped[s])
        if n:
            unschedulable.extend(queues[s][heads[s]:heads[s] + n])
            heads[s] += n
    return HostSolveResult(packings=packings, unschedulable=unschedulable)
