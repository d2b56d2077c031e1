"""The batched what-if first fit: a hand-written CUDA kernel and its plain twin.

``whatif_scan`` answers a consolidation window (ops/whatif.encode_window's
padded int32 tensors): for each candidate, the first fit of its pods, in
order, into every bin but its own. On a CUDA tensor it launches
``csrc/whatif.cu`` (built with nvcc into a shared library at first use,
bound with ctypes; :func:`launch_geometry` says which of its two kernels
a bin count takes) or raises; on a CPU tensor it runs
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
# margin for the kernel's static shared memory (csrc/whatif.cu SHARED_OPTIN,
# STATIC_MARGIN)
SHARED_OPTIN_BYTES = 227 * 1024
SHARED_MARGIN_BYTES = 1024
# the staged kernel (csrc/whatif.cu): 5 warps a candidate, pods staged in
# chunks of 32 through 2 buffers, bins in groups of 1024 (a column word a
# lane) and blocks of 128 (four a lane)
STAGED_THREADS = 160
CHUNK, NBUF = 32, 2
GROUP, BLOCK = 1024, 128
MAX_THREADS = 512  # the global kernel's most threads (csrc/whatif.cu MAX_THREADS)

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0
# seconds the last nvcc build took and what ptxas said (registers, spills)
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""

_LIB = None
_LIB_LOCK = threading.Lock()
# devices whose staged kernel has opted in to its shared memory
_READY: set = set()


def build() -> Path:
    """Compile csrc/whatif.cu into the build directory and return the
    library's path."""
    global BUILD_SECONDS, BUILD_LOG
    path, seconds, log = pack_cuda.nvcc_build(SOURCE, "kt_whatif")
    if seconds is not None:
        BUILD_SECONDS, BUILD_LOG = seconds, log
    return path


def _init(lib, index: int) -> None:
    """The staged kernel's shared-memory opt-in on device ``index``, once."""
    if index in _READY:
        return
    with torch.cuda.device(index):
        err = lib.kt_whatif_init()
    if err != 0:
        raise RuntimeError(
            f"whatif_scan init failed: {lib.kt_whatif_error_string(err).decode()}")
    _READY.add(index)


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.kt_whatif.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
            lib.kt_whatif.restype = i32
            lib.kt_whatif_init.argtypes = []
            lib.kt_whatif_init.restype = i32
            lib.kt_whatif_error_string.argtypes = [i32]
            lib.kt_whatif_error_string.restype = ctypes.c_char_p
            _init(lib, torch.cuda.current_device())
            _LIB = lib
        return _LIB


def staged_shared_bytes(BB: int) -> int:
    """Dynamic shared memory of the staged kernel for BB bins (csrc/whatif.cu
    Layout): free rows for all R dimensions over BB rounded up to blocks of
    128 bins, a byte a bin of its negative dimensions, a static-mask word a
    lane and group of 1024 bins, and two chunk buffers of column words (32
    pods x groups x 32 lanes), their ORs (32 x groups), pod vectors (32 x
    R) and a valid mask."""
    groups = -(-BB // GROUP)
    bbr = -(-BB // BLOCK) * BLOCK
    words = (NUM_RESOURCES * bbr + bbr // 4 + 32 * groups
             + NBUF * (CHUNK * groups * 32 + CHUNK * groups + CHUNK * NUM_RESOURCES + 1))
    return 4 * words


def free_rows_in_shared(BB: int) -> bool:
    """Whether a candidate's free rows, with the staged kernel's other
    buffers, fit a block's shared memory: the staged kernel then answers
    the window, else the global kernel with the free rows in a global
    scratch."""
    return staged_shared_bytes(BB) <= SHARED_OPTIN_BYTES - SHARED_MARGIN_BYTES


def launch_threads(BB: int) -> int:
    """Threads a block of the global kernel launches with for BB bins: one
    per bin in whole warps, 32 to 512 (csrc/whatif.cu checks the count it
    is given)."""
    return min(MAX_THREADS, max(32, -(-BB // 32) * 32))


def launch_geometry(BB: int) -> dict:
    """The kernel a window of BB bins takes and its block: ``kernel``
    ("staged" or "global"), ``threads``, dynamic ``shared_bytes``, and for
    the staged kernel its ``groups`` of 1024 bins (the column words a pod
    and lane) and ``blocks`` of 128 (four bins a lane)."""
    if free_rows_in_shared(BB):
        return {"kernel": "staged", "threads": STAGED_THREADS,
                "shared_bytes": staged_shared_bytes(BB), "groups": -(-BB // GROUP),
                "blocks": -(-BB // BLOCK)}
    return {"kernel": "global", "threads": launch_threads(BB), "shared_bytes": 0}


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
    plain version; CUDA tensors launch the kernel: the staged one when a
    candidate's free rows fit shared memory (:func:`free_rows_in_shared`),
    else the global one with the free rows in a global scratch."""
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
    feasible = pods.new_empty((NB,), dtype=torch.bool)
    slots = pods.new_empty((NB, KB))
    staged = free_rows_in_shared(BB)
    scratch = None if staged else pods.new_empty((NB, NUM_RESOURCES, BB))
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _init(lib, index)
    with torch.cuda.device(index):
        # the raw handle of the current stream (torch.cuda.current_stream
        # builds a Stream object: microseconds between a window's events)
        err = lib.kt_whatif(
            pods.data_ptr(), valid.data_ptr(), compat.data_ptr(), free0.data_ptr(),
            cand_bin.data_ptr(), feasible.data_ptr(), slots.data_ptr(),
            None if scratch is None else scratch.data_ptr(), NB, KB, BB,
            STAGED_THREADS if staged else launch_threads(BB), int(staged),
            torch._C._cuda_getCurrentRawStream(index))
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
