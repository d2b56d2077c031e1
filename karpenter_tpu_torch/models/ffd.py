"""Device FFD: encode → chunk loop (:class:`DeviceRun`, one problem or a
window's batch) → decode.

Exact parity with the reference Go packer. Produces the same
HostSolveResult structure as the host oracle, so callers and tests are
representation-agnostic.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.backend import DeviceLike, resolve_device, to_device_int32
from karpenter_tpu_torch.ops.encode import EncodedProblem, encode, pad_encoding
from karpenter_tpu_torch.solver.host_ffd import (
    MAX_INSTANCE_TYPES, HostPacking, HostSolveResult, Packable, R_PODS, Vec,
    instance_options,
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
    donate: bool = True,
) -> Optional[HostSolveResult]:
    """Solve on ``device`` (default: the CUDA device; raises without one);
    None only when the problem is not encodable, before anything reaches
    the device (the caller falls back to the host oracle). Pods may arrive
    unsorted; the same descending order as the host oracle is applied
    here. The device side is a :class:`DeviceRun` of one problem, the
    batched window's run with B = 1; an exception from the kernel, or a
    chunk loop that does not finish within ``MAX_CHUNKS``, propagates.

    ``donate`` routes the problem's tensors through the process
    ``DeviceRing`` (solver/pipeline.py): a repeat solve refills the last
    solve's tensors in place, and tensors whose content token matches (the
    catalog tensors by the encoder's catalog token, the shapes by a byte
    digest) copy nothing."""
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
    run = DeviceRun([enc], [prices if cost_tiebreak else None], chunk_iters, dev,
                    donate=donate, solo=True)
    records, dropped = run.finish()
    return _decode(enc, records[0], dropped[0], packables)


def _digest(arr: np.ndarray) -> tuple:
    """A content token for a pod-side array: exact byte equality."""
    return ("bytes", hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                                     digest_size=16).digest())


def _device_tensor(name: str):
    """A device tensor of the run, which raises once the run's ring slot is
    released: a later window refills those tensors in place, so a read
    would see its bytes (the JAX package's read of a donated buffer
    raises the same way)."""
    def get(self):
        if self._released:
            raise RuntimeError(
                f"DeviceRun.{name} was read after the run's fetch released its ring "
                "slot; the slot's tensors now hold a later window's inputs")
        return self._t[name]

    def put(self, value):
        self._t[name] = value

    return property(get, put)


class DeviceRun:
    """The device side of one solve of B >= 1 encoded problems: the batch
    tensors on the device and the chunk loop.

    Every problem is padded to the largest (S, T) bucket of the batch
    (parallel/batched_pack.pad_problems). ``maxfit`` is computed once on the
    device; the kernel's log bound and walked-resource mask once on the
    host from the encodings (neither reads the feasibility mask). Each
    chunk is one launch (parallel/batched_pack.pack_batch_ring: a batch of
    one through ``pack_chunk``, more through ``pack_batch``) and one
    device→host copy. ``mask``, when given, is the device feasibility
    mask's ``(valid, last_valid)`` tensors (ops/device_filter.py), used in
    place of the encodings' without touching the host. ``prices_list``
    holds each problem's per-packable $/h, an int32 ndarray row already
    encoded in micro-$ on the padded type axis (the policy scoring
    program's, ops/policy.py), or None; a row without prices gets
    INT32_MAX, which leaves the tie-break to the lowest index, as for an
    unpriced catalog.

    With ``donate`` the tensors come from a slot of the process
    ``DeviceRing`` (solver/pipeline.py) under the names and content tokens
    the JAX package's runs give them: the solo solve's (``solo`` = True,
    ``models/ffd.py:205-260`` there: its counts refill from the host at
    every resume, its prices are copied off the ring) or the batched
    window's (``solver/batch_solve.py:474-536``: the kernel's resume
    counts and dropped rows are handed back to the slot, so a resume that
    compacts nothing copies nothing to the device). The slot is released
    once :meth:`finish` has its last chunk on the host; the run's device
    tensors raise ``RuntimeError`` after that. Without ``donate`` the
    invariants and first counts go to the device in one copy."""

    shapes_d = _device_tensor("shapes_d")
    counts_d = _device_tensor("counts_d")
    dropped_d = _device_tensor("dropped_d")
    totals_d = _device_tensor("totals_d")
    reserved0_d = _device_tensor("reserved0_d")
    valid_d = _device_tensor("valid_d")
    last_valid_d = _device_tensor("last_valid_d")
    pods_unit_d = _device_tensor("pods_unit_d")
    prices_d = _device_tensor("prices_d")
    maxfit_d = _device_tensor("maxfit_d")

    def __init__(self, encs, prices_list, chunk_iters: int, device: torch.device,
                 mask=None, donate: bool = True, solo: bool = False):
        from karpenter_tpu_torch.ops.pack import compute_maxfit
        from karpenter_tpu_torch.ops.pack_cuda import batch_log_bound, requested_mask
        from karpenter_tpu_torch.parallel.batched_pack import pad_problems

        self._t = {}
        self._released = False
        self.encs = encs
        self.device = device
        self.L = chunk_iters
        self.solo = solo
        (shapes, counts, dropped, totals, reserved0, valid, last_valid, pods_unit,
         B) = pad_problems(encs)
        if mask is not None and tuple(mask[0].shape) != valid.shape:
            raise ValueError(f"mask shape {tuple(mask[0].shape)} != batch valid shape "
                             f"{valid.shape}")
        self.use_cost = any(p is not None for p in prices_list)
        # an explicit INT32_MAX row per unpriced problem; the batched ring
        # carries the row (zeros) even when nothing is priced, as the JAX
        # package's does
        prices = np.full((B, totals.shape[1]), _INT32_MAX if self.use_cost else 0, np.int32)
        for b, pr in enumerate(prices_list):
            if isinstance(pr, np.ndarray) and pr.dtype == np.int32:
                prices[b, :pr.shape[0]] = pr  # pre-encoded micro-$ row
            elif pr is not None:
                prices[b] = encode_prices(pr, totals.shape[1])
        self._ring = self._slot = None
        if donate:
            self._fill_from_ring(shapes, counts, dropped, totals, reserved0, valid,
                                 last_valid, pods_unit, prices, mask)
        else:
            host = [shapes, counts, totals, reserved0, pods_unit]
            if mask is None:
                host += [valid, last_valid]
            if self.use_cost:
                host.append(prices)
            # the invariants and the first counts in one host→device copy
            (self.shapes_d, self.counts_d, self.totals_d, self.reserved0_d,
             self.pods_unit_d, *rest) = to_device_int32(host, device)
            if mask is None:
                valid_i, self.last_valid_d, *rest = rest
                self.valid_d = valid_i != 0
            self.prices_d = rest[0] if self.use_cost else None
            self.dropped_d = torch.zeros_like(self.counts_d)
        if mask is not None:
            self.valid_d, self.last_valid_d = mask
        self.shapes_host = shapes
        self.maxfit_full_d = compute_maxfit(self.shapes_d, self.totals_d, self.reserved0_d,
                                            self.valid_d)
        self.maxfit_d = self.maxfit_full_d
        self._maxfit_host: Optional[np.ndarray] = None
        self.log_bound = batch_log_bound(totals, reserved0, pods_unit)
        self.resource_mask = requested_mask(shapes.reshape(-1, shapes.shape[2]))
        self.S0 = shapes.shape[1]
        self.buckets = [self.S0]   # the shape bucket of each chunk
        self.launches = 0
        self._pending = None

    def _fill_from_ring(self, shapes, counts, dropped, totals, reserved0, valid,
                        last_valid, pods_unit, prices, mask) -> None:
        from karpenter_tpu_torch.solver.pipeline import DeviceRing, get_ring

        self._ring = ring = get_ring()
        cats = tuple(e.catalog_token for e in self.encs)
        have_cat = all(t is not None for t in cats)
        if self.solo:
            prefix = "solo_"
            host = {"solo_shapes": shapes, "solo_counts": counts, "solo_dropped": dropped,
                    "solo_totals": totals, "solo_reserved0": reserved0, "solo_valid": valid,
                    "solo_last_valid": last_valid, "solo_pods_unit": pods_unit}
            cat = lambda field: ("solo", field, cats[0]) if have_cat else None  # noqa: E731
            dropped_tok = ("zeros", dropped.shape)
        else:
            prefix = ""
            host = {"shapes": shapes, "counts": counts, "dropped": dropped,
                    "totals": totals, "reserved0": reserved0, "valid": valid,
                    "last_valid": last_valid, "pods_unit": pods_unit, "prices": prices}
            if mask is not None:
                # the fused mask's tensors never come from the host, and the
                # distinct signature keeps fused and classic windows apart
                del host["valid"], host["last_valid"]
            cat = lambda field: ("cat-batch", field, cats) if have_cat else None  # noqa: E731
            dropped_tok = None
        self._slot = ring.acquire(DeviceRing.signature(host))
        try:
            def put(name, arr, token=None):
                return ring.fill(self._slot, prefix + name, arr, self.device, token=token)

            self.shapes_d = put("shapes", shapes, _digest(shapes))
            self.counts_d = put("counts", counts)
            self.dropped_d = put("dropped", dropped, dropped_tok)
            self.totals_d = put("totals", totals, cat("totals"))
            self.reserved0_d = put("reserved0", reserved0, cat("reserved0"))
            if mask is None:
                self.valid_d = put("valid", valid, cat("valid"))
                self.last_valid_d = put("last_valid", last_valid, cat("last_valid"))
            self.pods_unit_d = put("pods_unit", pods_unit, cat("pods_unit"))
            if self.solo:
                # the solo solve's prices are copied off the ring
                self.prices_d = (torch.from_numpy(prices).to(self.device)
                                 if self.use_cost else None)
            else:
                prices_d = put("prices", prices, _digest(prices))
                self.prices_d = prices_d if self.use_cost else None
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Release the ring slot (idempotent). Its tensors stay on the
        device for a later window to refill in place; this run's device
        tensors raise from here on."""
        slot, self._slot = self._slot, None
        if slot is not None:
            self._ring.release(slot)
            self._released = True

    def launch(self) -> None:
        """Enqueue the next chunk; a no-op while one is pending."""
        from karpenter_tpu_torch.parallel.batched_pack import pack_batch_ring

        if self._pending is not None:
            return
        self._pending = pack_batch_ring(
            self.shapes_d, self.counts_d, self.dropped_d, self.totals_d,
            self.reserved0_d, self.valid_d, self.last_valid_d, self.pods_unit_d,
            self.L, prices=self.prices_d, cost_tiebreak=self.use_cost,
            maxfit=self.maxfit_d, log_bound=self.log_bound,
            resource_mask=self.resource_mask)
        if self._slot is not None and not self.solo:
            # the resume tensors belong to the slot from here on
            _, counts_next, dropped_next = self._pending
            self._ring.hand_back(self._slot, counts=counts_next, dropped=dropped_next)
        self.launches += 1

    def finish(self):
        """Copy each chunk to the host, resume until every problem is done,
        and return per problem its records ``(chosen, q, packed row or
        sparse [(shape, n), ...])`` and its dropped counts, in the original
        shape index space. Between chunks the batch keeps ONE S: when the
        largest alive set of any problem fits a smaller bucket, every row is
        compacted to it (ops/compact.compact_rows); otherwise the next chunk
        resumes from the kernel's own ``counts_next`` and zeroed
        ``dropped_next`` (the solo ring refills its counts from the host
        copy instead). Each problem's dropped deltas accumulate on the host
        through its permutation. The ring slot is released at the end,
        once the last chunk is on the host, or on an error."""
        try:
            return self._finish()
        finally:
            self.close()

    def _finish(self):
        from karpenter_tpu_torch.ops.compact import (
            compact_rows, scatter_dropped, sparse_record,
        )
        from karpenter_tpu_torch.ops.encode import SHAPE_BUCKETS, bucket
        from karpenter_tpu_torch.parallel.batched_pack import unpack_batch_flat

        B, L = len(self.encs), self.L
        records: List[list] = [[] for _ in range(B)]
        dropped_full = [np.zeros(self.S0, np.int64) for _ in range(B)]
        perms: List[Optional[np.ndarray]] = [None] * B
        S_cur = self.S0
        prefix = "solo_" if self.solo else ""
        for _ in range(MAX_CHUNKS):
            self.launch()  # a no-op for a chunk already enqueued
            (flat, counts_next, dropped_next), self._pending = self._pending, None
            buf = flat.cpu().numpy()  # the chunk's one device→host copy
            counts_f, dropped_f, done, chosen, q, packed = unpack_batch_flat(buf, S_cur, L)
            for b in range(B):
                perm = perms[b]
                for i in np.flatnonzero(q[b] > 0):
                    rec = packed[b, i] if perm is None else sparse_record(packed[b, i], perm)
                    records[b].append((int(chosen[b, i]), int(q[b, i]), rec))
                scatter_dropped(dropped_full[b], dropped_f[b], perm)
            if done.all():
                break
            alive_max = int((counts_f > 0).sum(axis=1).max(initial=0))
            S_new = bucket(max(alive_max, 1), SHAPE_BUCKETS)
            if S_new is not None and S_new < S_cur:
                if self._maxfit_host is None:
                    self._maxfit_host = self.maxfit_full_d.cpu().numpy()
                perms, shapes_c, counts_c, maxfit_c = compact_rows(
                    counts_f, perms, self.shapes_host, self._maxfit_host, S_new)
                S_cur = S_new
                self.buckets.append(S_new)
                zeros_c = np.zeros_like(counts_c)
                if self._slot is None:
                    self.shapes_d, self.counts_d, self.maxfit_d = to_device_int32(
                        [shapes_c, counts_c, maxfit_c], self.device)
                    self.dropped_d = torch.zeros_like(self.counts_d)
                    continue
                # smaller rows: the fills see the new shape and make counted
                # fresh allocations (a compaction is an event, not the steady
                # state); maxfit is copied off the ring
                ring, slot = self._ring, self._slot
                self.shapes_d = ring.fill(slot, prefix + "shapes", shapes_c, self.device)
                self.counts_d = ring.fill(slot, prefix + "counts", counts_c, self.device)
                self.dropped_d = ring.fill(
                    slot, prefix + "dropped", zeros_c, self.device,
                    token=("zeros", zeros_c.shape) if self.solo else None)
                self.maxfit_d = torch.from_numpy(maxfit_c).to(self.device)
                if self.solo:
                    ring.note_allocation(1)
            elif self._slot is not None and self.solo:
                # the solo resume: the counts row refills the slot's tensor
                # in place; the zeros row matches its token and copies nothing
                zeros = np.zeros_like(counts_f)
                self.counts_d = self._ring.fill(self._slot, "solo_counts", counts_f,
                                                self.device)
                self.dropped_d = self._ring.fill(self._slot, "solo_dropped", zeros,
                                                 self.device, token=("zeros", zeros.shape))
            else:
                self.counts_d, self.dropped_d = counts_next, dropped_next
        else:
            # impossible by construction (every decision commits or drops);
            # reached only with a chunk_iters too small for the problem
            raise RuntimeError(f"device solve did not converge in {MAX_CHUNKS} chunks "
                               f"of {L} node decisions")
        return records, dropped_full


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
    max_instance_types: int = MAX_INSTANCE_TYPES,
    options_fn=None,
) -> HostSolveResult:
    """Materialize packings: map per-shape counts back to pod ids and dedupe
    by instance-option set (the hash dedupe in packer.go:130-139).

    ``options_fn`` (the signature of :func:`instance_options`) lets the
    fused device-filter path substitute its feasibility-aware option walk
    over the universe type axis (ops/device_filter.py); it may raise to
    reject the decode, and the caller then solves the problem on the host
    path."""
    queues = [list(p) for p in enc.shape_pods]
    heads = [0] * len(queues)
    packings: List[HostPacking] = []
    by_options = {}
    for chosen, qty, packedv in records:
        options = (options_fn or instance_options)(packables, chosen, max_instance_types)
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
