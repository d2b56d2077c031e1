"""One node decision's fill walk over a type shard: a CUDA kernel and its plain twin.

``type_fill`` runs the shape walk of one node decision over one shard of
the instance-type axis (parallel/type_sharded.py calls it once a shard and
decision) and returns each type's pods packed and its fill of each shape.
On a CUDA tensor it launches ``csrc/type_shard.cu`` (built with nvcc into a
shared library at first use, bound with ctypes) or raises; on a CPU tensor
it runs ``type_fill_plain``, the eager torch version of the same function.
Both compute what the JAX package's ``_local_pack.node_iter`` walk
computes before its collectives (karpenter_tpu/parallel/type_sharded.py:
94-146), bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.ops import pack_cuda
from karpenter_tpu_torch.ops.pack import INT32_MAX
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES, R_PODS

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "type_shard.cu"

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0
# seconds the last nvcc build took and what ptxas said (registers, spills)
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Path:
    """Compile csrc/type_shard.cu into the build directory and return the
    library's path."""
    global BUILD_SECONDS, BUILD_LOG
    path, seconds, log = pack_cuda.nvcc_build(SOURCE, "kt_type_shard")
    if seconds is not None:
        BUILD_SECONDS, BUILD_LOG = seconds, log
    return path


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.kt_type_fill.argtypes = [ptr] * 5 + [i32] * 3 + [ptr] * 3
            lib.kt_type_fill.restype = i32
            lib.kt_type_fill_error_string.argtypes = [i32]
            lib.kt_type_fill_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def type_fill(shapes: torch.Tensor, counts: torch.Tensor, totals: torch.Tensor,
              reserved0: torch.Tensor, valid: torch.Tensor,
              pods_unit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One node decision's walk over a shard of T types → ``(npacked (T,),
    k (S, T))``, int32. ``shapes`` (S, 8) and ``counts`` (S,) are the
    problem's (descending, as ops.encode makes them), ``totals`` and
    ``reserved0`` (T, 8) int32 and ``valid`` (T,) bool the shard's types.
    The live shapes (count > 0) are walked from the largest to the
    smallest; a type stops at a failure when it is full or has packed
    nothing, and an invalid type starts stopped. On a CPU tensor it runs
    :func:`type_fill_plain`; on a CUDA tensor it launches the kernel."""
    global LAUNCHES
    if shapes.device.type == "cpu":
        return type_fill_plain(shapes, counts, totals, reserved0, valid, pods_unit)
    if shapes.device.type != "cuda":
        raise ValueError(f"type_fill: unsupported device {shapes.device}")
    dev = shapes.device
    S, T = shapes.shape[0], totals.shape[0]
    for name, t, dtype, shape in (
            ("shapes", shapes, torch.int32, (S, NUM_RESOURCES)),
            ("counts", counts, torch.int32, (S,)),
            ("totals", totals, torch.int32, (T, NUM_RESOURCES)),
            ("reserved0", reserved0, torch.int32, (T, NUM_RESOURCES)),
            ("valid", valid, torch.bool, (T,))):
        pack_cuda._check(name, t, dtype, shape, dev, "type_fill")
    npacked = torch.empty(T, dtype=torch.int32, device=dev)
    k = torch.empty((S, T), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.kt_type_fill(shapes.data_ptr(), counts.data_ptr(), totals.data_ptr(),
                              reserved0.data_ptr(), valid.data_ptr(), S, T, int(pods_unit),
                              npacked.data_ptr(), k.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"type_fill kernel launch failed (S={S}, T={T}): "
                           f"{lib.kt_type_fill_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return npacked, k


def type_fill_plain(shapes: torch.Tensor, counts: torch.Tensor, totals: torch.Tensor,
                    reserved0: torch.Tensor, valid: torch.Tensor, pods_unit: int,
                    stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`type_fill`, on any device:
    vectorized over the types, sequential over the live shapes. ``stats``,
    when given, accumulates ``shape_steps`` (shapes walked) and
    ``type_steps`` (active types summed over those steps): the work this
    input needs."""
    dev = shapes.device
    S, R = shapes.shape
    T = totals.shape[0]
    i32 = torch.int32
    npacked = torch.zeros(T, dtype=i32, device=dev)
    k_all = torch.zeros((S, T), dtype=i32, device=dev)
    counts_h = counts.cpu().numpy()
    live = np.flatnonzero(counts_h > 0)
    if live.size == 0:
        return npacked, k_all
    shapes_h = shapes.cpu().numpy()
    pods_one = np.zeros(R, np.int64)
    pods_one[R_PODS] = int(pods_unit)
    smallest_fits = torch.as_tensor(
        np.maximum(shapes_h[live[-1]].astype(np.int64) - pods_one, 0), dtype=i32, device=dev)
    reserved = reserved0.clone()
    stopped = ~valid
    has_total = totals > 0
    shape_steps = 0
    type_steps = 0
    for s in live:
        if bool(stopped.all()):
            break  # stopped types never restart: the rest are no-ops
        count = int(counts_h[s])
        shape = shapes[s]
        if stats is not None:
            type_steps += int(stopped.logical_not().sum())
        shape_steps += 1
        kr = torch.where(shape > 0, torch.div(totals - reserved, shape.clamp(min=1),
                                              rounding_mode="floor"), INT32_MAX)
        k = kr.amin(dim=1).clamp_(0, count).masked_fill_(stopped, 0)
        failure = (k < count).masked_fill_(stopped, False)
        reserved += k[:, None] * shape
        full = (reserved + smallest_fits >= totals).logical_and_(has_total).any(dim=1)
        npacked += k
        stopped |= (npacked == 0).logical_or_(full).logical_and_(failure)
        k_all[s] = k
    if stats is not None:
        stats["shape_steps"] = stats.get("shape_steps", 0) + shape_steps
        stats["type_steps"] = stats.get("type_steps", 0) + type_steps
    return npacked, k_all
