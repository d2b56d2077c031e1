"""The FFD chunk solve: a hand-written CUDA kernel and its plain twin.

``pack_chunk`` runs up to ``num_iters`` first-fit-decreasing node decisions
of one encoded problem and returns the flat buffer of ``ops.pack``. On a
CUDA tensor it launches ``csrc/pack.cu`` (built with nvcc into a shared
library at first use, bound with ctypes) or raises; on a CPU tensor it runs
``pack_chunk_plain``, the eager torch transcription of the same function.
Both follow the TPU kernel's row contract (karpenter_tpu/ops/pack_pallas.py):
rows past ``done`` or with q == 0 hold chosen = -1, q = 0 and packed = 0,
so the two give bit-identical buffers.
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
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch.ops.pack import (
    INT32_MAX, compute_maxfit, flat_size, flatten_chunk_outputs,
)
from karpenter_tpu_torch.solver.host_ffd import R_PODS

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pack.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0
# seconds the last nvcc build took and what ptxas said (registers, spills)
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""

_LIB = None
_LIB_LOCK = threading.Lock()


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the pack kernel cannot be built")


def build() -> Path:
    """Compile csrc/pack.cu into build/ (keyed by the source's digest, so an
    edited source never loads a stale library) and return the library's
    path."""
    global BUILD_SECONDS, BUILD_LOG
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libkt_pack_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, lib_path)
    return lib_path


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.kt_pack_chunk.argtypes = [ptr] * 8 + [i32] * 6 + [ptr, ptr]
            lib.kt_pack_chunk.restype = i32
            lib.kt_error_string.argtypes = [i32]
            lib.kt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"pack_chunk: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def pack_chunk(shapes: torch.Tensor, counts: torch.Tensor,
               dropped: torch.Tensor, totals: torch.Tensor,
               reserved0: torch.Tensor, valid: torch.Tensor,
               last_valid: int, pods_unit: int, num_iters: int,
               prices: Optional[torch.Tensor] = None,
               cost_tiebreak: bool = False,
               maxfit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Up to ``num_iters`` node decisions → the flat int32 buffer
    ``[counts S | dropped S | done 1 | chosen L | q L | packed L·S]``.

    ``shapes`` (S, 8), ``counts``/``dropped`` (S,), ``totals``/``reserved0``
    (T, 8) are int32, ``valid`` (T,) bool, ``prices`` (T,) int32 micro-$
    (read only with ``cost_tiebreak``: the cheapest max-pods type wins,
    the lowest index breaks price ties), ``maxfit`` (S,) int32 from
    :func:`compute_maxfit` (computed here when omitted). Preconditions, as
    :func:`karpenter_tpu_torch.ops.encode.encode` guarantees them: shapes
    descending, 0 <= reserved0 <= totals, valid[last_valid]."""
    global LAUNCHES
    if shapes.device.type == "cpu":
        return pack_chunk_plain(shapes, counts, dropped, totals, reserved0,
                                valid, last_valid, pods_unit, num_iters,
                                prices=prices, cost_tiebreak=cost_tiebreak,
                                maxfit=maxfit)
    if shapes.device.type != "cuda":
        raise ValueError(f"pack_chunk: unsupported device {shapes.device}")
    dev = shapes.device
    S, T, L = shapes.shape[0], totals.shape[0], int(num_iters)
    if maxfit is None:
        maxfit = compute_maxfit(shapes, totals, reserved0, valid)
    use_cost = bool(cost_tiebreak and prices is not None)
    _check("shapes", shapes, torch.int32, (S, 8), dev)
    for name, t in (("counts", counts), ("dropped", dropped), ("maxfit", maxfit)):
        _check(name, t, torch.int32, (S,), dev)
    _check("totals", totals, torch.int32, (T, 8), dev)
    _check("reserved0", reserved0, torch.int32, (T, 8), dev)
    _check("valid", valid, torch.bool, (T,), dev)
    if use_cost:
        _check("prices", prices, torch.int32, (T,), dev)
    if not 0 <= int(last_valid) < T:
        raise ValueError(f"pack_chunk: last_valid {last_valid} outside [0, {T})")
    out = torch.empty(flat_size(S, L), dtype=torch.int32, device=dev)
    lib = _library()
    # the runtime launches on its current device: make it the tensors' one
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kt_pack_chunk(
            shapes.data_ptr(), counts.data_ptr(), dropped.data_ptr(),
            totals.data_ptr(), reserved0.data_ptr(), valid.data_ptr(),
            prices.data_ptr() if use_cost else None, maxfit.data_ptr(),
            S, T, L, int(last_valid), int(pods_unit), int(use_cost),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"pack kernel launch failed (S={S}, T={T}, L={L}): "
            f"{lib.kt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out


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
    work this input needs."""
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
    shape_steps = 0
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
    return flatten_chunk_outputs(counts_d, dropped_d, done, chosen_out,
                                 q_out, packed_out)
