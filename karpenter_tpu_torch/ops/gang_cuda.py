"""The gang co-pack first fit (B10): a hand-written CUDA kernel and its plain twin.

``gang_scan`` answers a padded gang window (ops/gang.encode_gang_window's
int32 tensors): for each gang, the first fit of its members, in order,
into its own copy of the window's pool. On a CUDA tensor it launches
``csrc/gang.cu`` (built with nvcc into a shared library at first use,
bound with ctypes; :func:`launch_geometry` says where a window's gang
state lives) or raises; on a CPU tensor it runs ``gang_scan_plain``, the
eager torch version of the same function. Both compute what the JAX
package's ``solver/gang._gang_jit`` computes, bit for bit, slots
included: the scan goes on past a member that fits nowhere. Both read one
(GB, BB) compat row a gang; neither builds a (GB, KB, BB) tensor.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from karpenter_tpu_torch.ops import pack_cuda
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gang.cu"
# csrc/gang.cu: a warp a gang, WARPS gangs a block; the gangs' state in
# shared memory while WARPS gangs' state fits SHARED_LIMIT_BYTES; a spilled
# debit entry is a bin and R free values
WARPS = 4
SHARED_LIMIT_BYTES = 48 * 1024
ENTRY_WORDS = NUM_RESOURCES + 1

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0
# seconds the last nvcc build took and what ptxas said (registers, spills)
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Path:
    """Compile csrc/gang.cu into the build directory and return the
    library's path."""
    global BUILD_SECONDS, BUILD_LOG
    path, seconds, log = pack_cuda.nvcc_build(SOURCE, "kt_gang")
    if seconds is not None:
        BUILD_SECONDS, BUILD_LOG = seconds, log
    return path


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.kt_gang.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
            lib.kt_gang.restype = i32
            lib.kt_gang_error_string.argtypes = [i32]
            lib.kt_gang_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def state_words(KB: int, BB: int) -> int:
    """int32 words of one gang's state in the kernel (csrc/gang.cu
    state_words): a column word per 32 bins, and the debit entries past the
    32 the lanes hold in registers (a gang takes at most min(KB, BB)
    bins)."""
    cap = min(KB, BB)
    return -(-BB // 32) + max(0, cap - 32) * ENTRY_WORDS


def launch_geometry(KB: int, BB: int) -> dict:
    """Where a window's gang state lives: ``"shared"`` while WARPS gangs'
    state fits SHARED_LIMIT_BYTES (``shared_bytes`` of dynamic shared memory
    a block), else ``"global"`` (a scratch of ``scratch_words`` int32 a
    gang that the wrapper allocates). The kernel is the same."""
    words = state_words(KB, BB)
    shared = WARPS * words * 4
    if shared <= SHARED_LIMIT_BYTES:
        return {"state": "shared", "shared_bytes": shared, "scratch_words": 0,
                "warps_per_block": WARPS}
    return {"state": "global", "shared_bytes": 0, "scratch_words": words,
            "warps_per_block": WARPS}


def gang_scan(pods: torch.Tensor, valid: torch.Tensor, compat: torch.Tensor,
              free0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feasible (GB,) bool, slots (GB, KB) int32) for a padded gang window:
    ``pods`` (GB, KB, R) int32, ``valid`` (GB, KB) and ``compat`` (GB, BB)
    bool, ``free0`` (BB, R) int32. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    global LAUNCHES
    dev = pods.device
    if dev.type == "cpu":
        return gang_scan_plain(pods, valid, compat, free0)
    if dev.type != "cuda":
        raise ValueError(f"gang_scan: unsupported device {dev}")
    GB, KB, _ = pods.shape
    BB = free0.shape[0]
    for name, t, dtype, shape in (("pods", pods, torch.int32, (GB, KB, NUM_RESOURCES)),
                                  ("valid", valid, torch.bool, (GB, KB)),
                                  ("compat", compat, torch.bool, (GB, BB)),
                                  ("free0", free0, torch.int32, (BB, NUM_RESOURCES))):
        pack_cuda._check(name, t, dtype, shape, dev, "gang_scan")
    feasible = pods.new_empty((GB,), dtype=torch.bool)
    slots = pods.new_empty((GB, KB))
    geometry = launch_geometry(KB, BB)
    scratch = None
    if geometry["state"] == "global":
        scratch = pods.new_empty((GB, geometry["scratch_words"]))
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        err = lib.kt_gang(
            pods.data_ptr(), valid.data_ptr(), compat.data_ptr(), free0.data_ptr(),
            feasible.data_ptr(), slots.data_ptr(),
            None if scratch is None else scratch.data_ptr(), GB, KB, BB,
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(
            f"gang_scan launch failed (GB={GB}, KB={KB}, BB={BB}): "
            f"{lib.kt_gang_error_string(err).decode()}")
    LAUNCHES += 1
    return feasible, slots


def gang_scan_plain(pods: torch.Tensor, valid: torch.Tensor, compat: torch.Tensor,
                    free0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`gang_scan`: every gang at once, a
    Python loop over the member axis. Each step tests every bin of every
    gang's own copy of the free rows against the gang's one compat row,
    takes the lowest bin that fits, and debits it only when the member is
    valid and placed."""
    GB, KB, _ = pods.shape
    BB = free0.shape[0]
    dev = pods.device
    free = free0.unsqueeze(0).expand(GB, BB, free0.shape[1]).clone()
    valid = valid.bool()
    compat = compat.bool()
    rows = torch.arange(GB, device=dev)
    feasible = torch.ones((GB,), dtype=torch.bool, device=dev)
    slots = torch.full((GB, KB), -1, dtype=torch.int32, device=dev)
    for k in range(KB):
        vec = pods[:, k]
        fits = (free >= vec[:, None, :]).all(-1) & compat
        can = fits.any(1)
        b = fits.int().argmax(1)  # torch.argmax rejects bool
        placed = can & valid[:, k]
        free[rows, b] -= torch.where(placed[:, None], vec, torch.zeros_like(vec))
        slots[:, k] = torch.where(placed, b.to(torch.int32), torch.full_like(slots[:, k], -1))
        feasible &= can | ~valid[:, k]
    return feasible, slots
