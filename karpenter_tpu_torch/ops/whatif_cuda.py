"""The batched what-if first fit: a hand-written CUDA kernel and its plain twin.

``whatif_scan`` answers a consolidation window (ops/whatif.encode_window's
padded int32 tensors): for each candidate, the first fit of its pods, in
order, into every bin but its own. On a CUDA tensor it launches
``csrc/whatif.cu`` (built with nvcc into a shared library at first use,
bound with ctypes) or raises; on a CPU tensor it runs
``whatif_scan_plain``, the eager torch version of the same function. Both
compute what the JAX package's ``solver/whatif._whatif_jit`` computes, bit
for bit, slots included: the scan goes on past a pod that fits nowhere.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from karpenter_tpu_torch.ops import pack_cuda
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "whatif.cu"
# shared memory a block can opt in to on sm_90 (232,448 bytes), less a
# margin for the kernel's static shared memory
SHARED_OPTIN_BYTES = 227 * 1024
SHARED_MARGIN_BYTES = 1024
MAX_THREADS = 512  # csrc/whatif.cu MAX_THREADS

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0
# seconds the last nvcc build took and what ptxas said (registers, spills)
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Path:
    """Compile csrc/whatif.cu into the build directory and return the
    library's path."""
    global BUILD_SECONDS, BUILD_LOG
    path, seconds, log = pack_cuda.nvcc_build(SOURCE, "kt_whatif")
    if seconds is not None:
        BUILD_SECONDS, BUILD_LOG = seconds, log
    return path


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.kt_whatif.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
            lib.kt_whatif.restype = i32
            lib.kt_whatif_error_string.argtypes = [i32]
            lib.kt_whatif_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def launch_threads(BB: int) -> int:
    """Threads a block launches with for BB bins: one per bin in whole
    warps, 32 to 512 (csrc/whatif.cu checks the count it is given)."""
    return min(MAX_THREADS, max(32, -(-BB // 32) * 32))


def free_rows_in_shared(BB: int) -> bool:
    """Whether a candidate's BB free rows (BB·R int32) fit the block's
    shared memory; else they live in a global scratch."""
    return BB * NUM_RESOURCES * 4 <= SHARED_OPTIN_BYTES - SHARED_MARGIN_BYTES


def _check(name: str, t: torch.Tensor, dtypes: tuple, shape: tuple,
           device: torch.device) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"whatif_scan: {name} must be a contiguous {'/'.join(map(str, dtypes))} "
            f"tensor of shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})")


def whatif_scan(pods: torch.Tensor, valid: torch.Tensor, compat: torch.Tensor,
                free0: torch.Tensor, cand_bin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feasible (NB,) bool, slots (NB, KB) int32) for a window:
    ``pods`` (NB, KB, R) int32, ``valid`` (NB, KB) and ``compat``
    (NB, KB, BB) bool or uint8, ``free0`` (BB, R) int32 and ``cand_bin``
    (NB,) int32 (a position among the bins, or -1). CPU tensors run the
    plain version; CUDA tensors launch the kernel, which keeps each
    candidate's free rows in shared memory when they fit
    (:func:`free_rows_in_shared`) and in a global scratch otherwise."""
    global LAUNCHES
    dev = pods.device
    if dev.type == "cpu":
        return whatif_scan_plain(pods, valid, compat, free0, cand_bin)
    if dev.type != "cuda":
        raise ValueError(f"whatif_scan: unsupported device {dev}")
    NB, KB, R = pods.shape
    BB = free0.shape[0]
    byte = (torch.bool, torch.uint8)
    _check("pods", pods, (torch.int32,), (NB, KB, NUM_RESOURCES), dev)
    _check("valid", valid, byte, (NB, KB), dev)
    _check("compat", compat, byte, (NB, KB, BB), dev)
    _check("free0", free0, (torch.int32,), (BB, NUM_RESOURCES), dev)
    _check("cand_bin", cand_bin, (torch.int32,), (NB,), dev)
    feasible = torch.empty((NB,), dtype=torch.bool, device=dev)
    slots = torch.empty((NB, KB), dtype=torch.int32, device=dev)
    use_smem = free_rows_in_shared(BB)
    scratch = None if use_smem else torch.empty(
        (NB, NUM_RESOURCES, BB), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kt_whatif(
            pods.data_ptr(), valid.data_ptr(), compat.data_ptr(), free0.data_ptr(),
            cand_bin.data_ptr(), feasible.data_ptr(), slots.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            NB, KB, BB, launch_threads(BB), int(use_smem), stream)
    if err != 0:
        raise RuntimeError(
            f"whatif_scan launch failed: {lib.kt_whatif_error_string(err).decode()}")
    LAUNCHES += 1
    return feasible, slots


def whatif_scan_plain(pods: torch.Tensor, valid: torch.Tensor, compat: torch.Tensor,
                      free0: torch.Tensor, cand_bin: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`whatif_scan`: every candidate at
    once, a Python loop over the pod axis. Each step tests every bin of
    every candidate's own copy of the free rows, takes the lowest bin that
    fits, and debits it only when the pod is valid and placed."""
    NB, KB, _ = pods.shape
    BB = free0.shape[0]
    dev = pods.device
    free = free0.unsqueeze(0).expand(NB, BB, free0.shape[1]).clone()
    bin_ok = torch.arange(BB, dtype=torch.int32, device=dev)[None, :] != cand_bin[:, None]
    valid = valid.bool()
    compat = compat.bool()
    rows = torch.arange(NB, device=dev)
    feasible = torch.ones((NB,), dtype=torch.bool, device=dev)
    slots = torch.full((NB, KB), -1, dtype=torch.int32, device=dev)
    for k in range(KB):
        vec = pods[:, k]
        fits = (free >= vec[:, None, :]).all(-1) & compat[:, k] & bin_ok
        can = fits.any(1)
        b = fits.int().argmax(1)  # torch.argmax rejects bool
        placed = can & valid[:, k]
        free[rows, b] -= torch.where(placed[:, None], vec, torch.zeros_like(vec))
        slots[:, k] = torch.where(placed, b.to(torch.int32), torch.full_like(slots[:, k], -1))
        feasible &= can | ~valid[:, k]
    return feasible, slots
