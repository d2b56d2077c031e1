"""Device FFD: encode → chunk loop (:class:`DeviceRun`, one problem or a
window's batch over a mesh, one :class:`ShardRun` a shard) → decode.

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
    mesh=None,  # a solver mesh (parallel/mesh.py): the type-axis SPMD route
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
    digest) copy nothing.

    With a ``mesh`` whose size divides the padded type bucket
    (:func:`routes_type_spmd`), every chunk and every resume runs
    ``parallel/type_sharded.pack_chunk_type_sharded`` over it, off the
    ring (:func:`solve_type_sharded`); a mesh that does not divide it
    takes the standard kernel, a routing rule by shape."""
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
    if routes_type_spmd(enc, mesh):
        records, dropped = solve_type_sharded(
            enc, prices if cost_tiebreak else None, chunk_iters, mesh)
        result = _decode(enc, records, dropped, packables)
        result.type_spmd = True
        return result
    run = DeviceRun([enc], [prices if cost_tiebreak else None], chunk_iters, dev,
                    donate=donate, solo=True)
    records, dropped = run.finish()
    return _decode(enc, records[0], dropped[0], packables)


def routes_type_spmd(enc: EncodedProblem, mesh) -> bool:
    """Whether a solve of the padded ``enc`` over ``mesh`` takes the
    type-axis SPMD route: a mesh whose size divides the type bucket."""
    return mesh is not None and enc.totals.shape[0] % len(mesh) == 0


def solve_type_sharded(enc: EncodedProblem, prices: Optional[Sequence[float]],
                       chunk_iters: int, mesh):
    """The chunk loop of the type-axis SPMD route over the padded ``enc``:
    ``pack_chunk_type_sharded`` a chunk, one device→host copy of its flat
    buffer, and between chunks the alive shapes compacted to the smallest
    bucket that holds them (as the JAX route does; the chunk computes its
    own bound, so nothing else is sliced). Returns the records and the
    dropped counts in the original shape index space."""
    from karpenter_tpu_torch.ops.compact import scatter_dropped, sparse_record
    from karpenter_tpu_torch.ops.encode import SHAPE_BUCKETS, bucket
    from karpenter_tpu_torch.ops.pack import unpack_flat
    from karpenter_tpu_torch.parallel.type_sharded import pack_chunk_type_sharded

    dev0, L = mesh[0], chunk_iters
    shapes_d, counts_d, _, totals, reserved0, valid, last_valid, pods_unit = \
        device_args(enc, dev0)
    prices_d = None
    if prices is not None:
        prices_d = torch.from_numpy(encode_prices(prices, enc.totals.shape[0])).to(dev0)
    S_cur = enc.shapes.shape[0]
    records: list = []
    dropped_full = np.zeros(S_cur, np.int64)
    perm: Optional[np.ndarray] = None
    for _ in range(MAX_CHUNKS):
        flat = pack_chunk_type_sharded(
            shapes_d, counts_d, torch.zeros_like(counts_d), totals, reserved0, valid,
            last_valid, pods_unit, num_iters=L, mesh=mesh, prices=prices_d,
            cost_tiebreak=prices_d is not None)
        counts_f, dropped_f, done, chosen, q, packed = unpack_flat(flat.cpu().numpy(), S_cur, L)
        for i in np.flatnonzero(q > 0):
            rec = packed[i] if perm is None else sparse_record(packed[i], perm)
            records.append((int(chosen[i]), int(q[i]), rec))
        scatter_dropped(dropped_full, dropped_f, perm)
        if done:
            return records, dropped_full
        alive = np.flatnonzero(counts_f > 0)
        S_new = bucket(max(alive.size, 1), SHAPE_BUCKETS)
        if S_new < S_cur:
            perm = alive if perm is None else perm[alive]
            shapes_c = np.zeros((S_new, enc.shapes.shape[1]), np.int32)
            counts_c = np.zeros(S_new, np.int32)
            shapes_c[:alive.size] = enc.shapes[perm]
            counts_c[:alive.size] = counts_f[alive]
            shapes_d, counts_d = to_device_int32([shapes_c, counts_c], dev0)
            S_cur = S_new
        else:
            counts_d = torch.from_numpy(np.ascontiguousarray(counts_f)).to(dev0)
    raise RuntimeError(f"device solve did not converge in {MAX_CHUNKS} chunks "
                       f"of {L} node decisions")


def _digest(arr: np.ndarray) -> tuple:
    """A content token for a pod-side array: exact byte equality."""
    return ("bytes", hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                                     digest_size=16).digest())


def _device_tensor(name: str):
    """A device tensor of a shard, which raises once the run's ring slot is
    released: a later window refills those tensors in place, so a read
    would see its bytes (the JAX package's read of a donated buffer
    raises the same way)."""
    def get(self):
        if self._run._released:
            raise RuntimeError(
                f"DeviceRun.{name} was read after the run's fetch released its ring "
                "slot; the slot's tensors now hold a later window's inputs")
        return self._t[name]

    def put(self, value):
        self._t[name] = value

    return property(get, put)


def _one_shard(name: str):
    """A tensor of a run over one shard (every run over a one-device mesh):
    the shard's own. A run over several shards keeps it per shard."""
    def get(self):
        if len(self.shards) != 1:
            raise AttributeError(
                f"DeviceRun.{name}: a run over {len(self.shards)} shards keeps it per "
                f"shard (DeviceRun.shards[k].{name})")
        return getattr(self.shards[0], name)

    return property(get)


class DeviceRun:
    """The device side of one solve of B >= 1 encoded problems over a mesh
    of devices (parallel/mesh.py): the batch's rows cut into one
    :class:`ShardRun` a shard, each with its tensors on its device and its
    own chunk loop.

    Every problem is padded to the largest (S, T) bucket of the batch and
    the batch to a multiple of the mesh size
    (parallel/batched_pack.pad_problems); the padding problems finish in
    their first chunk and are dropped at the gather. The kernel's log bound
    and walked-resource mask are computed once on the host from the
    encodings (neither reads the feasibility mask). :meth:`launch` enqueues
    every shard's chunk before anything waits; :meth:`finish` walks each
    shard's chunk loop in turn and gathers the rows in batch order. A
    one-device mesh is one shard of every row: one launch and one
    device→host copy a chunk. ``device`` is a device (a one-device mesh) or
    a mesh.

    ``mask``, when given, is the device feasibility mask's ``(valid,
    last_valid)`` tensors a shard (ops/device_filter.py), used in place of
    the encodings' without touching the host. ``prices_list`` holds each
    problem's per-packable $/h, an int32 ndarray row already encoded in
    micro-$ on the padded type axis (the policy scoring program's,
    ops/policy.py), or None; a row without prices gets INT32_MAX, which
    leaves the tie-break to the lowest index, as for an unpriced catalog.

    With ``donate`` the tensors come from ONE slot of the process
    ``DeviceRing`` (solver/pipeline.py), which holds a tensor a shard under
    the names and content tokens the JAX package's runs give them (shard
    k > 0 adds ``@k``): the solo solve's (``solo`` = True,
    ``models/ffd.py:205-260`` there: its counts refill from the host at
    every resume, its prices are copied off the ring) or the batched
    window's (``solver/batch_solve.py:474-536``: the kernel's resume
    counts and dropped rows are handed back to the slot, so a resume that
    compacts nothing copies nothing to the device). The slot is released
    once :meth:`finish` has every shard's last chunk on the host; the run's
    device tensors raise ``RuntimeError`` after that. Without ``donate``
    each shard's invariants and first counts go to its device in one
    copy."""

    shapes_d = _one_shard("shapes_d")
    counts_d = _one_shard("counts_d")
    dropped_d = _one_shard("dropped_d")
    totals_d = _one_shard("totals_d")
    reserved0_d = _one_shard("reserved0_d")
    valid_d = _one_shard("valid_d")
    last_valid_d = _one_shard("last_valid_d")
    pods_unit_d = _one_shard("pods_unit_d")
    prices_d = _one_shard("prices_d")
    maxfit_d = _one_shard("maxfit_d")

    def __init__(self, encs, prices_list, chunk_iters: int, device,
                 mask=None, donate: bool = True, solo: bool = False):
        from karpenter_tpu_torch.ops.pack_cuda import batch_log_bound, requested_mask
        from karpenter_tpu_torch.parallel.batched_pack import pad_problems
        from karpenter_tpu_torch.parallel.mesh import batch_sharding, solver_mesh

        self._released = False
        self.encs = encs
        self.mesh = solver_mesh([device] if isinstance(device, (str, torch.device))
                                else device)
        self.device = self.mesh[0]
        self.L = chunk_iters
        self.solo = solo
        (shapes, counts, dropped, totals, reserved0, valid, last_valid, pods_unit,
         self.B) = pad_problems(encs, len(self.mesh))
        shards = batch_sharding(shapes.shape[0], self.mesh)
        if mask is not None:
            got = (sum(int(m[0].shape[0]) for m in mask), int(mask[0][0].shape[1]))
            if len(mask) != len(shards) or got != valid.shape:
                raise ValueError(f"mask shape {got} over {len(mask)} shards != batch valid "
                                 f"shape {valid.shape} over {len(shards)}")
        self.use_cost = any(p is not None for p in prices_list)
        # an explicit INT32_MAX row per unpriced problem; the batched ring
        # carries the row (zeros) even when nothing is priced, as the JAX
        # package's does
        prices = np.full((shapes.shape[0], totals.shape[1]),
                         _INT32_MAX if self.use_cost else 0, np.int32)
        for b, pr in enumerate(prices_list):
            if isinstance(pr, np.ndarray) and pr.dtype == np.int32:
                prices[b, :pr.shape[0]] = pr  # pre-encoded micro-$ row
            elif pr is not None:
                prices[b] = encode_prices(pr, totals.shape[1])
        self.log_bound = batch_log_bound(totals, reserved0, pods_unit)
        self.resource_mask = requested_mask(shapes.reshape(-1, shapes.shape[2]))
        self.S0 = shapes.shape[1]
        host = {"shapes": shapes, "counts": counts, "dropped": dropped, "totals": totals,
                "reserved0": reserved0, "valid": valid, "last_valid": last_valid,
                "pods_unit": pods_unit, "prices": prices}
        self._ring = self._slot = None
        if donate:
            self._acquire(host, mask is not None)
        self.shards: List[ShardRun] = []
        try:
            for sh in shards:
                self.shards.append(ShardRun(self, sh, host, None if mask is None
                                            else mask[sh.index]))
        except BaseException:
            self.close()
            raise

    def _acquire(self, host: dict, fused: bool) -> None:
        """Take the run's ring slot, keyed by the padded batch's signature
        (and the mesh, when it has several shards)."""
        from karpenter_tpu_torch.solver.pipeline import DeviceRing, get_ring

        self._ring = get_ring()
        if self.solo:
            names = ("shapes", "counts", "dropped", "totals", "reserved0", "valid",
                     "last_valid", "pods_unit")
            sig_host = {"solo_" + n: host[n] for n in names}
        else:
            sig_host = dict(host)
            if fused:
                # the fused mask's tensors never come from the host, and the
                # distinct signature keeps fused and classic windows apart
                del sig_host["valid"], sig_host["last_valid"]
        sig = DeviceRing.signature(sig_host)
        if len(self.mesh) > 1:
            sig += (("mesh", tuple(str(d) for d in self.mesh)),)
        self._slot = self._ring.acquire(sig)

    def cat_token(self, field: str) -> Optional[tuple]:
        """The content token of a catalog-side tensor: the encoder's
        catalog tokens of the batch (None when one is missing)."""
        cats = tuple(e.catalog_token for e in self.encs)
        if not all(t is not None for t in cats):
            return None
        return ("solo", field, cats[0]) if self.solo else ("cat-batch", field, cats)

    @property
    def launches(self) -> int:
        """Kernel launches of the run, summed over its shards."""
        return sum(sh.launches for sh in self.shards)

    @property
    def buckets(self) -> List[int]:
        """The shape buckets the run's chunks walked, largest first (a
        shard's own walk, for a run of one shard)."""
        return sorted({s for sh in self.shards for s in sh.buckets}, reverse=True)

    def close(self) -> None:
        """Release the ring slot (idempotent). Its tensors stay on their
        devices for a later window to refill in place; this run's device
        tensors raise from here on."""
        slot, self._slot = self._slot, None
        if slot is not None:
            self._ring.release(slot)
            self._released = True

    def launch(self) -> None:
        """Enqueue every shard's next chunk before anything waits; a no-op
        for a shard with a chunk pending or all its rows done."""
        for sh in self.shards:
            sh.launch()

    def finish(self):
        """Walk each shard's chunk loop until every problem is done
        (:meth:`ShardRun.step`), and return per problem its records
        ``(chosen, q, packed row or sparse [(shape, n), ...])`` and its
        dropped counts, in the original shape index space, in batch order.
        The shards are stepped in turn: each waits for its own chunk and
        enqueues its next one before the next shard waits. The ring slot is
        released at the end, once every last chunk is on the host, or on an
        error."""
        try:
            return self._finish()
        finally:
            self.close()

    def _finish(self):
        self.launch()
        running = list(self.shards)
        for _ in range(MAX_CHUNKS):
            running = [sh for sh in running if not sh.step()]
            if not running:
                break
        else:
            # impossible by construction (every decision commits or drops);
            # reached only with a chunk_iters too small for the problem
            raise RuntimeError(f"device solve did not converge in {MAX_CHUNKS} chunks "
                               f"of {self.L} node decisions")
        records = [r for sh in self.shards for r in sh.records][:self.B]
        dropped = [d for sh in self.shards for d in sh.dropped_full][:self.B]
        return records, dropped


class ShardRun:
    """One shard of a :class:`DeviceRun`: rows ``[start, stop)`` of the
    padded batch on the shard's device, and their chunk loop.

    ``maxfit`` is computed once on the device. Each chunk is one launch
    (parallel/batched_pack.pack_batch_ring: a shard of one row through
    ``pack_chunk``, more through ``pack_batch``) and one device→host copy.
    Between chunks the shard keeps ONE S: when the largest alive set of
    its rows fits a smaller bucket, every row is compacted to it
    (ops/compact.compact_rows); otherwise the next chunk resumes from the
    kernel's own ``counts_next`` and zeroed ``dropped_next`` (the solo ring
    refills its counts from the host copy instead). Shards finish at
    different chunks; each row's dropped deltas accumulate on the host
    through its permutation."""

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

    def __init__(self, run: DeviceRun, shard, host: dict, mask):
        from karpenter_tpu_torch.ops.pack import compute_maxfit

        self._run = run
        self._t = {}
        self.shard = shard
        self.device = shard.device
        rows = {name: arr[shard.rows] for name, arr in host.items()}
        self.rows = shard.stop - shard.start
        if run._slot is not None:
            self._fill_from_ring(rows, mask is not None)
        else:
            names = ["shapes", "counts", "totals", "reserved0", "pods_unit"]
            if mask is None:
                names += ["valid", "last_valid"]
            if run.use_cost:
                names.append("prices")
            # the invariants and the first counts in one host→device copy
            (self.shapes_d, self.counts_d, self.totals_d, self.reserved0_d,
             self.pods_unit_d, *rest) = to_device_int32([rows[n] for n in names], self.device)
            if mask is None:
                valid_i, self.last_valid_d, *rest = rest
                self.valid_d = valid_i != 0
            self.prices_d = rest[0] if run.use_cost else None
            self.dropped_d = torch.zeros_like(self.counts_d)
        if mask is not None:
            self.valid_d, self.last_valid_d = mask
        self.shapes_host = rows["shapes"]
        self.maxfit_full_d = compute_maxfit(self.shapes_d, self.totals_d, self.reserved0_d,
                                            self.valid_d)
        self.maxfit_d = self.maxfit_full_d
        self._maxfit_host: Optional[np.ndarray] = None
        self.S0 = self.S_cur = self.shapes_host.shape[1]
        self.buckets = [self.S0]   # the shape bucket of each chunk
        self.launches = 0
        self._pending = None
        self.records: List[list] = [[] for _ in range(self.rows)]
        self.dropped_full = [np.zeros(self.S0, np.int64) for _ in range(self.rows)]
        self._perms: List[Optional[np.ndarray]] = [None] * self.rows
        self.done = False

    def _name(self, name: str) -> str:
        """The shard's ring name for ``name``: the solo solve's prefix, and
        ``@k`` for shard k > 0."""
        k = self.shard.index
        return ("solo_" if self._run.solo else "") + name + (f"@{k}" if k else "")

    def _put(self, name: str, arr: np.ndarray, token=None) -> torch.Tensor:
        run = self._run
        return run._ring.fill(run._slot, self._name(name), arr, self.device, token=token)

    def _fill_from_ring(self, rows: dict, fused: bool) -> None:
        run = self._run
        cat = run.cat_token
        self.shapes_d = self._put("shapes", rows["shapes"], _digest(rows["shapes"]))
        self.counts_d = self._put("counts", rows["counts"])
        self.dropped_d = self._put("dropped", rows["dropped"],
                                   ("zeros", rows["dropped"].shape) if run.solo else None)
        self.totals_d = self._put("totals", rows["totals"], cat("totals"))
        self.reserved0_d = self._put("reserved0", rows["reserved0"], cat("reserved0"))
        if not fused:
            self.valid_d = self._put("valid", rows["valid"], cat("valid"))
            self.last_valid_d = self._put("last_valid", rows["last_valid"], cat("last_valid"))
        self.pods_unit_d = self._put("pods_unit", rows["pods_unit"], cat("pods_unit"))
        if run.solo:
            # the solo solve's prices are copied off the ring
            self.prices_d = (torch.from_numpy(rows["prices"]).to(self.device)
                             if run.use_cost else None)
        else:
            prices_d = self._put("prices", rows["prices"], _digest(rows["prices"]))
            self.prices_d = prices_d if run.use_cost else None

    def launch(self) -> None:
        """Enqueue the shard's next chunk on its device's current stream; a
        no-op while one is pending or once every row is done."""
        from karpenter_tpu_torch.parallel.batched_pack import pack_batch_ring

        if self._pending is not None or self.done:
            return
        run = self._run
        self._pending = pack_batch_ring(
            self.shapes_d, self.counts_d, self.dropped_d, self.totals_d,
            self.reserved0_d, self.valid_d, self.last_valid_d, self.pods_unit_d,
            run.L, prices=self.prices_d, cost_tiebreak=run.use_cost,
            maxfit=self.maxfit_d, log_bound=run.log_bound,
            resource_mask=run.resource_mask)
        if run._slot is not None and not run.solo:
            # the resume tensors belong to the slot from here on
            _, counts_next, dropped_next = self._pending
            run._ring.hand_back(run._slot, **{self._name("counts"): counts_next,
                                              self._name("dropped"): dropped_next})
        self.launches += 1

    def step(self) -> bool:
        """Copy the shard's pending chunk to the host (its one device→host
        copy), take in its rows, and, while a row is still running, prepare
        the next chunk's tensors and enqueue it. True once every row of the
        shard is done."""
        from karpenter_tpu_torch.ops.compact import (
            compact_rows, scatter_dropped, sparse_record,
        )
        from karpenter_tpu_torch.ops.encode import SHAPE_BUCKETS, bucket
        from karpenter_tpu_torch.parallel.batched_pack import unpack_batch_flat

        run = self._run
        self.launch()  # a no-op for a chunk already enqueued
        (flat, counts_next, dropped_next), self._pending = self._pending, None
        buf = flat.cpu().numpy()  # the chunk's one device→host copy
        counts_f, dropped_f, done, chosen, q, packed = unpack_batch_flat(
            buf, self.S_cur, run.L)
        for b in range(self.rows):
            perm = self._perms[b]
            for i in np.flatnonzero(q[b] > 0):
                rec = packed[b, i] if perm is None else sparse_record(packed[b, i], perm)
                self.records[b].append((int(chosen[b, i]), int(q[b, i]), rec))
            scatter_dropped(self.dropped_full[b], dropped_f[b], perm)
        if done.all():
            self.done = True
            return True
        alive_max = int((counts_f > 0).sum(axis=1).max(initial=0))
        S_new = bucket(max(alive_max, 1), SHAPE_BUCKETS)
        if S_new is not None and S_new < self.S_cur:
            if self._maxfit_host is None:
                self._maxfit_host = self.maxfit_full_d.cpu().numpy()
            self._perms, shapes_c, counts_c, maxfit_c = compact_rows(
                counts_f, self._perms, self.shapes_host, self._maxfit_host, S_new)
            self.S_cur = S_new
            self.buckets.append(S_new)
            zeros_c = np.zeros_like(counts_c)
            if run._slot is None:
                self.shapes_d, self.counts_d, self.maxfit_d = to_device_int32(
                    [shapes_c, counts_c, maxfit_c], self.device)
                self.dropped_d = torch.zeros_like(self.counts_d)
            else:
                # smaller rows: the fills see the new shape and make counted
                # fresh allocations (a compaction is an event, not the
                # steady state); maxfit is copied off the ring
                self.shapes_d = self._put("shapes", shapes_c)
                self.counts_d = self._put("counts", counts_c)
                self.dropped_d = self._put(
                    "dropped", zeros_c, ("zeros", zeros_c.shape) if run.solo else None)
                self.maxfit_d = torch.from_numpy(maxfit_c).to(self.device)
                if run.solo:
                    run._ring.note_allocation(1)
        elif run._slot is not None and run.solo:
            # the solo resume: the counts row refills the slot's tensor in
            # place; the zeros row matches its token and copies nothing
            zeros = np.zeros_like(counts_f)
            self.counts_d = self._put("counts", counts_f)
            self.dropped_d = self._put("dropped", zeros, ("zeros", zeros.shape))
        else:
            self.counts_d, self.dropped_d = counts_next, dropped_next
        self.launch()
        return False


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
