"""The FFD chunk solve: a hand-written CUDA kernel and its plain twin.

``pack_chunk`` runs up to ``num_iters`` first-fit-decreasing node decisions
of one encoded problem and returns the flat buffer of ``ops.pack``. On a
CUDA tensor it launches ``csrc/pack.cu`` (built with nvcc into a shared
library at first use, bound with ctypes) or raises; on a CPU tensor it runs
``pack_chunk_plain``, the eager torch transcription of the same function.
Both follow the TPU kernel's row contract (karpenter_tpu/ops/pack_pallas.py):
rows past ``done`` or with q == 0 hold chosen = -1, q = 0 and packed = 0,
so the two give bit-identical buffers.

``pack_batch`` runs B problems of one bucket in one launch of the same
kernel, a cluster per problem, and ``pack_batch_plain`` is its twin.

The kernel runs one problem on a thread-block cluster whose size
:func:`launch_shape` fixes from the type bucket, one type per thread, and
walks the resources of :func:`requested_mask` (its body for 3 of them when
the mask has at most 3 bits, else its body for all 8). Its divisions by per-shape constants are emulated by
:func:`divisor_constants` and :func:`floor_div_by_constant`, and its
per-type fill logs are sized by :func:`compute_log_bound`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from karpenter_tpu_torch import build_dir
from karpenter_tpu_torch.ops.pack import (
    INT32_MAX, compute_maxfit, flat_size, flatten_chunk_outputs,
)
from karpenter_tpu_torch.solver.host_ffd import R_PODS

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pack.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernel's launch limits (csrc/pack.cu): portable cluster size, threads
# holding types in one CTA (one more warp walks last_valid)
MAX_CLUSTER = 8
MAX_TYPE_THREADS = 512
_DIVISOR_TABLE_WORDS = 32  # int32 words per shape in each CTA's divisor table

# launches of the CUDA kernel since the counts were last set to 0: one
# problem (pack_chunk) and a batch of problems (pack_batch)
LAUNCHES = 0
BATCH_LAUNCHES = 0
# seconds the last nvcc build took and what ptxas said (registers, spills)
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""

_LIB = None
_LIB_LOCK = threading.Lock()

IntOrTensor = Union[int, torch.Tensor]


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the pack kernel cannot be built")


def nvcc_build(source: Path, stem: str) -> Tuple[Path, Optional[float], str]:
    """Compile one CUDA source into the library directory (``build_dir``)
    as a shared library named by ``stem`` and the source's digest (an
    edited source never loads a stale library). Returns (path, seconds nvcc took, its output); seconds is None
    and the output empty when the library was already there."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib_path = Path(build_dir.PATH) / f"lib{stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, None, ""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def build() -> Path:
    """Compile csrc/pack.cu into build/ and return the library's path."""
    global BUILD_SECONDS, BUILD_LOG
    path, seconds, log = nvcc_build(SOURCE, "kt_pack")
    if seconds is not None:
        BUILD_SECONDS, BUILD_LOG = seconds, log
    return path


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.kt_pack.argtypes = [ptr] * 10 + [i32] * 8 + [ptr] * 4
            lib.kt_pack.restype = i32
            lib.kt_error_string.argtypes = [i32]
            lib.kt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, fn: str = "pack_chunk") -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def launch_shape(T: int) -> int:
    """The kernel's cluster size for a type bucket of T: a CTA per 64
    types, up to 8, one type per thread. Measured (PERF.md, the cluster-size
    table of ``chip_smoke.py``) at T = 512; T = 4096 gives 8 CTAs of 512
    type threads."""
    return max(1, min(MAX_CLUSTER, T // 64))


def launch_threads(T: int, cluster: int) -> int:
    """Threads per CTA for T types over ``cluster`` CTAs, as csrc/pack.cu
    launches them: whole warps of types, and one warp that walks
    last_valid."""
    per_cta = -(-T // cluster)
    return -(-per_cta // 32) * 32 + 32


def requested_mask(shapes) -> int:
    """A bit for each resource dimension some shape requests (numpy or CPU
    tensor): the kernel walks only those. Compaction only drops shapes, so
    a solve's mask holds for all its chunks."""
    used = (np.asarray(shapes) > 0).any(axis=0)
    return int(sum(1 << r for r in np.flatnonzero(used)))


def compute_log_bound(totals, reserved0, valid, pods_unit: int) -> int:
    """The most steps with k > 0 one type's fill can take in a decision.

    Each shape carries at least ``pods_unit`` on R_PODS (the implicit pod
    that ``ops.encode`` adds), so every step with k > 0 reserves at least
    that much of the type's pods, and type t takes at most
    ``(totals[t, R_PODS] - reserved0[t, R_PODS]) // pods_unit`` of them.
    The maximum over valid types (numpy or CPU tensors); INT32_MAX when
    ``pods_unit`` < 1 gives no bound. The kernel sizes its per-type logs
    with it and ends the chunk with an error if a chosen type's log would
    overflow."""
    if pods_unit < 1:
        return INT32_MAX
    valid = np.asarray(valid, bool)
    free = (np.asarray(totals, np.int64)[valid, R_PODS]
            - np.asarray(reserved0, np.int64)[valid, R_PODS])
    return int(max(0, (free // pods_unit).max(initial=0)))


def divisor_constants(d: torch.Tensor) -> torch.Tensor:
    """The kernel's per-(shape, resource) reciprocal, in int64:
    ``(2**32 - 1) // d`` for ``d`` > 0 and 0 for ``d`` == 0."""
    d = d.to(torch.int64)
    return torch.where(d > 0, (2**32 - 1) // d.clamp(min=1), 0)


def floor_div_by_constant(n: torch.Tensor, d: torch.Tensor,
                          m: torch.Tensor) -> torch.Tensor:
    """``n // d`` as the kernel computes it, in int64, for 0 <= n < 2**31
    and 1 <= d < 2**31 with ``m = divisor_constants(d)``: the high word of
    n·m is the quotient or one less (n < 2**31 bounds the error of m below
    one), and one exact correction fixes it."""
    n, d = n.to(torch.int64), d.to(torch.int64)
    q = (n * m) >> 32
    return q + (n - q * d >= d).to(torch.int64)


def pack_chunk(shapes: torch.Tensor, counts: torch.Tensor,
               dropped: torch.Tensor, totals: torch.Tensor,
               reserved0: torch.Tensor, valid: torch.Tensor,
               last_valid: IntOrTensor, pods_unit: IntOrTensor, num_iters: int,
               prices: Optional[torch.Tensor] = None,
               cost_tiebreak: bool = False,
               maxfit: Optional[torch.Tensor] = None,
               log_bound: Optional[int] = None,
               resource_mask: Optional[int] = None) -> torch.Tensor:
    """Up to ``num_iters`` node decisions → the flat int32 buffer
    ``[counts S | dropped S | done 1 | chosen L | q L | packed L·S]``.

    ``last_valid`` and ``pods_unit`` are ints or one-element int32 tensors
    on the tensors' device (a solve passes its device copies, so nothing is
    read back); ``shapes`` (S, 8), ``counts``/``dropped`` (S,),
    ``totals``/``reserved0`` (T, 8) are int32, ``valid`` (T,) bool,
    ``prices`` (T,) int32 micro-$ (read only with ``cost_tiebreak``: the
    cheapest max-pods type wins, the lowest index breaks price ties), ``maxfit`` (S,) int32 from
    :func:`compute_maxfit`, ``log_bound`` from :func:`compute_log_bound`
    and ``resource_mask`` from :func:`requested_mask` (each computed here
    when omitted; the last two with a device→host copy). A mask with more
    bits than the shapes request gives the same buffer, walked slower.
    Preconditions, as :func:`karpenter_tpu_torch.ops.encode.encode`
    guarantees them: shapes descending, each carrying at least
    ``pods_unit`` pods, 0 <= reserved0 <= totals, valid[last_valid].
    A kernel that cannot keep them sets the done word to -1, on which
    :func:`karpenter_tpu_torch.ops.pack.unpack_flat` raises."""
    if shapes.device.type == "cpu":
        return pack_chunk_plain(shapes, counts, dropped, totals, reserved0,
                                valid, last_valid, pods_unit, num_iters,
                                prices=prices, cost_tiebreak=cost_tiebreak,
                                maxfit=maxfit)
    if shapes.device.type != "cuda":
        raise ValueError(f"pack_chunk: unsupported device {shapes.device}")
    if maxfit is None:
        maxfit = compute_maxfit(shapes, totals, reserved0, valid)
    if log_bound is None:
        log_bound = compute_log_bound(totals.cpu().numpy(), reserved0.cpu().numpy(),
                                      valid.cpu().numpy(), int(pods_unit))
    if resource_mask is None:
        resource_mask = requested_mask(shapes.cpu().numpy())
    return launch_pack(shapes, counts, dropped, totals, reserved0, valid,
                       last_valid, pods_unit, num_iters, prices, cost_tiebreak,
                       maxfit, log_bound, resource_mask, launch_shape(totals.shape[0]))


def launch_pack(shapes: torch.Tensor, counts: torch.Tensor,
                dropped: torch.Tensor, totals: torch.Tensor,
                reserved0: torch.Tensor, valid: torch.Tensor,
                last_valid: IntOrTensor, pods_unit: IntOrTensor, num_iters: int,
                prices: Optional[torch.Tensor], cost_tiebreak: bool,
                maxfit: torch.Tensor, log_bound: int, resource_mask: int,
                cluster: int) -> torch.Tensor:
    """One launch of csrc/pack.cu on CUDA tensors at a given cluster size:
    what :func:`pack_chunk` runs at the size :func:`launch_shape` picks (the
    other sizes are for measuring that rule). It is the batched launch of
    :func:`launch_pack_batch` with B = 1. Checks every argument and raises
    on a refused launch."""
    global LAUNCHES
    if shapes.dim() != 2 or totals.dim() != 2:
        raise ValueError(f"pack_chunk: shapes and totals must be (·, 8), got "
                         f"{tuple(shapes.shape)} and {tuple(totals.shape)}")
    one = [_one_problem(v, shapes.device) for v in (last_valid, pods_unit)]
    row = [None if t is None else t[None] for t in (
        shapes, counts, dropped, totals, reserved0, valid, prices, maxfit)]
    out = _launch("pack_chunk", *row[:6], *one, num_iters, row[6], cost_tiebreak,
                  row[7], log_bound, resource_mask, cluster)
    LAUNCHES += 1
    return out[0]


def _one_problem(v, device: torch.device) -> torch.Tensor:
    """An int or a one-element tensor → a (1,) tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1)
    return torch.tensor([int(v)], dtype=torch.int32, device=device)


def _launch(fn: str, shapes, counts, dropped, totals, reserved0, valid,
            last_valid, pods_unit, num_iters, prices, cost_tiebreak, maxfit,
            log_bound, resource_mask, cluster) -> torch.Tensor:
    """The launch behind :func:`launch_pack` (B = 1) and
    :func:`launch_pack_batch`, every tensor with a leading axis of B and
    ``last_valid``/``pods_unit`` (B,) int32 tensors: checks every argument,
    allocates the output and the scratch, launches on the current stream
    and raises on a refused launch."""
    dev = shapes.device
    if shapes.dim() != 3 or totals.dim() != 3:
        raise ValueError(f"{fn}: shapes and totals must be (B, ·, 8), got "
                         f"{tuple(shapes.shape)} and {tuple(totals.shape)}")
    B = shapes.shape[0]
    lead = (B,)
    S, T, L = shapes.shape[-2], totals.shape[-2], int(num_iters)
    use_cost = bool(cost_tiebreak and prices is not None)
    _check("shapes", shapes, torch.int32, lead + (S, 8), dev, fn)
    for name, t in (("counts", counts), ("dropped", dropped), ("maxfit", maxfit)):
        _check(name, t, torch.int32, lead + (S,), dev, fn)
    _check("totals", totals, torch.int32, lead + (T, 8), dev, fn)
    _check("reserved0", reserved0, torch.int32, lead + (T, 8), dev, fn)
    _check("valid", valid, torch.bool, lead + (T,), dev, fn)
    if use_cost:
        _check("prices", prices, torch.int32, lead + (T,), dev, fn)
    # per-problem device values; the kernel ends a problem whose last_valid
    # lies outside [0, T) with its error word
    _check("last_valid", last_valid, torch.int32, lead, dev, fn)
    _check("pods_unit", pods_unit, torch.int32, lead, dev, fn)
    if not (1 <= cluster <= MAX_CLUSTER
            and launch_threads(T, cluster) <= MAX_TYPE_THREADS + 32):
        raise ValueError(f"{fn}: no launch of {cluster} CTAs for T={T}")
    if not 0 <= int(resource_mask) < 1 << 8:
        raise ValueError(f"{fn}: resource mask {resource_mask} outside [0, 256)")
    # a type logs at most one entry per live shape, so S caps any bound
    log_cap = max(1, min(int(log_bound), S))
    out = torch.empty((B, flat_size(S, L)), dtype=torch.int32, device=dev)
    consts = torch.empty(B * cluster * S * _DIVISOR_TABLE_WORDS, dtype=torch.int32, device=dev)
    log = torch.empty(B * 2 * T * log_cap * 2, dtype=torch.int32, device=dev)
    lib = _library()
    # the runtime launches on its current device: make it the tensors' one
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kt_pack(
            shapes.data_ptr(), counts.data_ptr(), dropped.data_ptr(),
            totals.data_ptr(), reserved0.data_ptr(), valid.data_ptr(),
            prices.data_ptr() if use_cost else None, maxfit.data_ptr(),
            last_valid.data_ptr(), pods_unit.data_ptr(), B, S, T, L,
            int(use_cost), int(resource_mask), int(cluster), log_cap,
            consts.data_ptr(), log.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"pack kernel launch failed (B={B}, S={S}, T={T}, L={L}, cluster={cluster}): "
            f"{lib.kt_error_string(rc).decode()} ({rc})")
    return out


def batch_log_bound(totals, reserved0, pods_unit) -> int:
    """:func:`compute_log_bound` of a batch ((B, T, 8) totals and reserved0,
    (B,) pods_unit; numpy or CPU tensors): the maximum over problems, each
    over EVERY type of its axis. The valid mask is ignored: a bound over a
    superset of the types is still a bound, and so the host never needs
    the device's feasibility mask to size the logs."""
    pods_unit = np.asarray(pods_unit, np.int64)
    if pods_unit.size == 0:
        return 0
    if (pods_unit < 1).any():
        return INT32_MAX
    free = (np.asarray(totals, np.int64)[:, :, R_PODS]
            - np.asarray(reserved0, np.int64)[:, :, R_PODS])
    return int(max(0, (free // pods_unit[:, None]).max(initial=0)))


def pack_batch(shapes: torch.Tensor, counts: torch.Tensor,
               dropped: torch.Tensor, totals: torch.Tensor,
               reserved0: torch.Tensor, valid: torch.Tensor,
               last_valid: torch.Tensor, pods_unit: torch.Tensor,
               num_iters: int, prices: Optional[torch.Tensor] = None,
               cost_tiebreak: bool = False,
               maxfit: Optional[torch.Tensor] = None,
               log_bound: Optional[int] = None,
               resource_mask: Optional[int] = None) -> torch.Tensor:
    """:func:`pack_chunk` over B independent problems of one (S, T) bucket
    in ONE launch → (B, 2S+1+2L+L·S) int32, row b the flat buffer of
    problem b (the Pallas kernel under ``jax.vmap``).

    Every argument of :func:`pack_chunk` gains a leading axis of B;
    ``last_valid`` and ``pods_unit`` are (B,) int32 tensors, so a device
    feasibility mask and its ``last_valid`` reach the kernel without
    touching the host. ``maxfit`` (B, S) comes from
    :func:`karpenter_tpu_torch.ops.pack.compute_maxfit`, ``log_bound``
    from :func:`batch_log_bound` and ``resource_mask`` from
    :func:`requested_mask` over every problem's shapes (each computed here
    when omitted, the last two from host copies of the shapes, totals,
    reserved0 and pods_unit). On a CPU tensor it runs
    :func:`pack_batch_plain`. With B = 1 a row equals :func:`pack_chunk`'s
    buffer bit for bit: it is the same kernel."""
    if shapes.device.type == "cpu":
        return pack_batch_plain(shapes, counts, dropped, totals, reserved0,
                                valid, last_valid, pods_unit, num_iters,
                                prices=prices, cost_tiebreak=cost_tiebreak,
                                maxfit=maxfit)
    if shapes.device.type != "cuda":
        raise ValueError(f"pack_batch: unsupported device {shapes.device}")
    if maxfit is None:
        maxfit = compute_maxfit(shapes, totals, reserved0, valid)
    if log_bound is None:
        log_bound = batch_log_bound(totals.cpu().numpy(), reserved0.cpu().numpy(),
                                    pods_unit.cpu().numpy())
    if resource_mask is None:
        resource_mask = requested_mask(shapes.cpu().numpy().reshape(-1, shapes.shape[-1]))
    return launch_pack_batch(shapes, counts, dropped, totals, reserved0, valid,
                             last_valid, pods_unit, num_iters, prices,
                             cost_tiebreak, maxfit, log_bound, resource_mask,
                             launch_shape(totals.shape[1]))


def launch_pack_batch(shapes: torch.Tensor, counts: torch.Tensor,
                      dropped: torch.Tensor, totals: torch.Tensor,
                      reserved0: torch.Tensor, valid: torch.Tensor,
                      last_valid: torch.Tensor, pods_unit: torch.Tensor,
                      num_iters: int, prices: Optional[torch.Tensor],
                      cost_tiebreak: bool, maxfit: torch.Tensor,
                      log_bound: int, resource_mask: int,
                      cluster: int) -> torch.Tensor:
    """One batched launch of csrc/pack.cu, a cluster of ``cluster`` CTAs
    per problem: what :func:`pack_batch` runs at the size
    :func:`launch_shape` picks. Checks every argument as
    :func:`launch_pack` does and raises on a refused launch. The scratch is
    sized from this launch's S: the divisor tables alone take
    B·cluster·S·128 bytes (~200 MB at B = 24, 8 CTAs, S = 8192)."""
    global BATCH_LAUNCHES
    out = _launch("pack_batch", shapes, counts, dropped, totals, reserved0, valid,
                  last_valid, pods_unit, num_iters, prices, cost_tiebreak, maxfit,
                  log_bound, resource_mask, cluster)
    BATCH_LAUNCHES += 1
    return out


def pack_batch_plain(shapes: torch.Tensor, counts: torch.Tensor,
                     dropped: torch.Tensor, totals: torch.Tensor,
                     reserved0: torch.Tensor, valid: torch.Tensor,
                     last_valid: torch.Tensor, pods_unit: torch.Tensor,
                     num_iters: int, prices: Optional[torch.Tensor] = None,
                     cost_tiebreak: bool = False,
                     maxfit: Optional[torch.Tensor] = None,
                     stats: Optional[dict] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`pack_batch`, on any device:
    :func:`pack_chunk_plain` problem by problem, the rows stacked.
    ``stats`` accumulates over the problems."""
    lv = [int(v) for v in last_valid.cpu().tolist()]
    pu = [int(v) for v in pods_unit.cpu().tolist()]
    rows = [pack_chunk_plain(
        shapes[b], counts[b], dropped[b], totals[b], reserved0[b], valid[b],
        lv[b], pu[b], num_iters,
        prices=None if prices is None else prices[b],
        cost_tiebreak=cost_tiebreak,
        maxfit=None if maxfit is None else maxfit[b], stats=stats)
        for b in range(shapes.shape[0])]
    return torch.stack(rows)


def pack_chunk_plain(shapes: torch.Tensor, counts: torch.Tensor,
                     dropped: torch.Tensor, totals: torch.Tensor,
                     reserved0: torch.Tensor, valid: torch.Tensor,
                     last_valid: int, pods_unit: int, num_iters: int,
                     prices: Optional[torch.Tensor] = None,
                     cost_tiebreak: bool = False,
                     maxfit: Optional[torch.Tensor] = None,
                     stats: Optional[dict] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`pack_chunk`, on any device: the
    same function as the kernel, vectorized over the T types and sequential
    over shapes and node decisions. Count-0 shapes are skipped (they are
    no-ops), and the walk stops once every type has stopped.

    ``stats``, when given, accumulates ``shape_steps`` (shape steps walked)
    and ``type_steps`` (active type columns summed over those steps) — the
    work this input needs — and keeps in ``log_steps`` the most steps with
    k > 0 that one type took in one decision (the kernel logs those)."""
    dev = shapes.device
    S, R = shapes.shape
    T, L = totals.shape[0], int(num_iters)
    last_valid, pods_unit = int(last_valid), int(pods_unit)
    if maxfit is None:
        maxfit = compute_maxfit(shapes, totals, reserved0, valid)
    use_cost = bool(cost_tiebreak and prices is not None)
    i32, i64 = torch.int32, torch.int64

    shapes_h = shapes.cpu().numpy()
    counts_d = counts.to(i64).clone()
    dropped_d = dropped.to(i64).clone()
    maxfit_d = maxfit.to(i64)
    has_total = totals > 0
    iota = torch.arange(T, dtype=i32, device=dev)
    pods_one = np.zeros(R, np.int64)
    pods_one[R_PODS] = pods_unit
    chosen_out = torch.full((L,), -1, dtype=i32, device=dev)
    q_out = torch.zeros(L, dtype=i32, device=dev)
    packed_out = torch.zeros((L, S), dtype=i32, device=dev)
    shape_steps, log_steps = 0, 0
    type_steps = torch.zeros((), dtype=i64, device=dev)
    cols = {}  # shape row → (its positive resources, their sizes, the row)

    counts_h = counts_d.cpu().numpy()
    done = not (counts_h > 0).any()
    for it in range(L):
        if done:
            break
        live = np.flatnonzero(counts_h > 0)
        lo, hi = int(live[0]), int(live[-1])
        smallest_fits = torch.as_tensor(
            np.maximum(shapes_h[hi] - pods_one, 0), dtype=i32, device=dev)

        # pass 1: greedy-fill every type column over the live shapes
        resv = reserved0.clone()
        stopped = ~valid
        npacked = torch.zeros(T, dtype=i32, device=dev)
        steps, ks = [], []
        for j, s in enumerate(live):
            if j % 8 == 0 and bool(stopped.all()):
                break  # stopped types never restart: the rest are no-ops
            count = int(counts_h[s])
            if s not in cols:
                pos = np.flatnonzero(shapes_h[s] > 0)
                cols[s] = (torch.as_tensor(pos, device=dev),
                           torch.as_tensor(shapes_h[s][pos], device=dev), shapes[s])
            pos, divisors, shape = cols[s]
            if stats is not None:
                type_steps += stopped.logical_not().sum()
            if pos.numel():
                avail = (totals - resv)[:, pos]
                kfit = torch.div(avail, divisors, rounding_mode="floor").amin(dim=1)
            else:
                kfit = torch.full((T,), INT32_MAX, dtype=i32, device=dev)
            k = kfit.clamp_(0, count).masked_fill_(stopped, 0)
            failure = (k < count).masked_fill_(stopped, False)
            resv += k[:, None] * shape
            full = (resv + smallest_fits >= totals).logical_and_(has_total).any(dim=1)
            npacked += k
            stopped |= (npacked == 0).logical_or_(full).logical_and_(failure)
            steps.append(int(s))
            ks.append(k)
        shape_steps += len(steps)
        if stats is not None and ks:
            log_steps = max(log_steps, int((torch.stack(ks) > 0).sum(0).max()))

        max_pods = int(npacked[last_valid])
        tie = valid & (npacked == max_pods)
        if use_cost:
            best = torch.where(tie, prices, INT32_MAX).min()
            tie = tie & (prices == best)
        chosen = int(torch.where(tie, iota, INT32_MAX).min())
        nothing = max_pods == 0

        packedv = torch.zeros(S, dtype=i64, device=dev)
        if ks and chosen < T:
            idx = torch.as_tensor(steps, dtype=i64, device=dev)
            packedv[idx] = torch.stack(ks)[:, chosen].to(i64)
        if nothing:
            q = 0
            drop = int(counts_h[lo])
            counts_d[lo] = 0
            dropped_d[lo] += drop
        else:
            # exact fast-forward (docs/solver.md §4), formed in int64
            numer = counts_d - maxfit_d - 1
            per = torch.where(numer < 0, -1, torch.div(
                numer, packedv.clamp(min=1), rounding_mode="floor"))
            terms = torch.where(packedv > 0, per, INT32_MAX)
            q = max(1, 1 + int(terms.min()))
            counts_d = counts_d - q * packedv
            chosen_out[it] = chosen
            q_out[it] = q
            packed_out[it] = packedv.to(i32)
        counts_h = counts_d.cpu().numpy()
        done = not (counts_h > 0).any()

    if stats is not None:
        stats["shape_steps"] = stats.get("shape_steps", 0) + shape_steps
        stats["type_steps"] = stats.get("type_steps", 0) + int(type_steps)
        stats["log_steps"] = max(stats.get("log_steps", 0), log_steps)
    return flatten_chunk_outputs(counts_d, dropped_d, done, chosen_out,
                                 q_out, packed_out)
