"""One node decision over a type shard: a CUDA kernel and its plain twin.

``shard_candidate`` runs one node decision's work on one shard of the
instance-type axis (parallel/type_sharded.py calls it once a shard and
decision): the shape walk of the shard's types, the walk of the globally
last valid type from its row (the max-pods probe), and the shard's
candidate, the least key price * 2^32 + global index over its ties with
that type's fill column. It returns them as one int32 row
(:func:`out_words`: the key's low and high words, max_pods, the chosen
index, the column). On a CUDA tensor it launches ``csrc/type_shard.cu``
(built with nvcc into a shared library at first use, bound with ctypes)
or raises; on a CPU tensor it runs ``shard_candidate_plain``, the eager
torch version of the same function, built on ``type_fill_plain``, the
walk. They compute what the JAX package's ``_local_pack`` computes on a
shard (karpenter_tpu/parallel/type_sharded.py:94-182) before its
reductions across shards, bit for bit.
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
INT64_MAX = 2**63 - 1
# the row's header (csrc/type_shard.cu HEADER): key low word, key high
# word, max_pods, chosen; the column follows
HEADER = 4
# the probe row: the last valid type's totals, reserved0 and valid flag
PROBE_WORDS = 2 * NUM_RESOURCES + 1

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
            lib.kt_shard_candidate.argtypes = [ptr] * 7 + [i32] * 4 + [ptr] * 4
            lib.kt_shard_candidate.restype = i32
            lib.kt_shard_candidate_error_string.argtypes = [i32]
            lib.kt_shard_candidate_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def out_words(S: int) -> int:
    """int32 words of a candidate row for S shapes: the header and the
    column, rounded up to even so that a stack of rows views its keys as
    int64."""
    return HEADER + S + (S & 1)


def probe_row(totals: torch.Tensor, reserved0: torch.Tensor, valid: torch.Tensor,
              last_valid: int) -> torch.Tensor:
    """The (PROBE_WORDS,) int32 row of type ``last_valid`` (its totals,
    reserved0 and valid flag) on the device of ``totals``; zeros, with the
    flag off, for an index outside the type axis (then max_pods is 0, as
    when no shard owns it)."""
    T = totals.shape[0]
    if not 0 <= last_valid < T:
        return torch.zeros(PROBE_WORDS, dtype=torch.int32, device=totals.device)
    return torch.cat([totals[last_valid], reserved0[last_valid],
                      valid[last_valid:last_valid + 1].to(torch.int32)]).to(torch.int32)


def new_workspace(device: torch.device) -> torch.Tensor:
    """A shard's (2,) int64 work words as the kernel wants them between
    launches: the running minimum key INT64_MAX and the block ticket 0.
    The kernel's last block restores them, so one serves every launch of a
    shard on one stream."""
    return torch.tensor([INT64_MAX, 0], dtype=torch.int64, device=device)


def row_key(row: torch.Tensor) -> torch.Tensor:
    """The int64 key of a candidate row, or of each row of a stack of them
    (a view: the rows' even length keeps the key words aligned)."""
    return row[..., :2].view(torch.int64)[..., 0]


def shard_candidate(shapes: torch.Tensor, counts: torch.Tensor, totals: torch.Tensor,
                    reserved0: torch.Tensor, valid: torch.Tensor,
                    prices: Optional[torch.Tensor], probe: torch.Tensor, offset: int,
                    pods_unit: int, workspace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One node decision over a shard of T types → its candidate row
    (:func:`out_words` int32). ``shapes`` (S, 8) and ``counts`` (S,) are the
    problem's (descending, as ops.encode makes them), ``totals`` and
    ``reserved0`` (T, 8) int32 and ``valid`` (T,) bool the shard's types,
    ``prices`` (T,) int32 with the cost tie-break (None without), ``probe``
    the :func:`probe_row` of the globally last valid type, ``offset`` the
    shard's first global type index. ``workspace`` (:func:`new_workspace`,
    one a shard, on its device) saves a copy a call. On a CPU tensor it
    runs :func:`shard_candidate_plain`; on a CUDA tensor it launches the
    kernel."""
    global LAUNCHES
    if shapes.device.type == "cpu":
        return shard_candidate_plain(shapes, counts, totals, reserved0, valid, prices, probe,
                                     offset, pods_unit)
    if shapes.device.type != "cuda":
        raise ValueError(f"shard_candidate: unsupported device {shapes.device}")
    dev = shapes.device
    S, T = shapes.shape[0], totals.shape[0]
    checks = [("shapes", shapes, torch.int32, (S, NUM_RESOURCES)),
              ("counts", counts, torch.int32, (S,)),
              ("totals", totals, torch.int32, (T, NUM_RESOURCES)),
              ("reserved0", reserved0, torch.int32, (T, NUM_RESOURCES)),
              ("valid", valid, torch.bool, (T,)),
              ("probe", probe, torch.int32, (PROBE_WORDS,))]
    if prices is not None:
        checks.append(("prices", prices, torch.int32, (T,)))
    if workspace is None:
        workspace = new_workspace(dev)
    checks.append(("workspace", workspace, torch.int64, (2,)))
    for name, t, dtype, shape in checks:
        pack_cuda._check(name, t, dtype, shape, dev, "shard_candidate")
    k = torch.empty((S, T), dtype=torch.int32, device=dev)
    out = torch.empty(out_words(S), dtype=torch.int32, device=dev)
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        rc = lib.kt_shard_candidate(
            shapes.data_ptr(), counts.data_ptr(), totals.data_ptr(), reserved0.data_ptr(),
            valid.data_ptr(), None if prices is None else prices.data_ptr(), probe.data_ptr(),
            S, T, int(offset), int(pods_unit), k.data_ptr(), workspace.data_ptr(),
            out.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"shard_candidate kernel launch failed (S={S}, T={T}): "
                           f"{lib.kt_shard_candidate_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out


def shard_candidate_plain(shapes: torch.Tensor, counts: torch.Tensor, totals: torch.Tensor,
                          reserved0: torch.Tensor, valid: torch.Tensor,
                          prices: Optional[torch.Tensor], probe: torch.Tensor, offset: int,
                          pods_unit: int, stats: Optional[dict] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`shard_candidate`, on any device:
    :func:`type_fill_plain` over the shard and over the probe row, then the
    ties, the least key and its column in torch. ``stats`` accumulates both
    walks' steps (:func:`type_fill_plain`)."""
    dev = shapes.device
    S, T = shapes.shape[0], totals.shape[0]
    R = NUM_RESOURCES
    npacked, k = type_fill_plain(shapes, counts, totals, reserved0, valid, pods_unit, stats)
    probe = probe.to(dev)
    probed, _ = type_fill_plain(shapes, counts, probe[None, :R], probe[None, R:2 * R],
                                probe[2 * R:] != 0, pods_unit, stats)
    max_pods = probed[0]
    ties = valid & (npacked == max_pods)
    price = prices.to(torch.int64) if prices is not None else torch.zeros(T, dtype=torch.int64,
                                                                           device=dev)
    index = torch.arange(offset, offset + T, dtype=torch.int64, device=dev)
    keys = torch.where(ties, price * 2**32 + index, INT64_MAX)
    key = keys.amin()
    out = torch.zeros(out_words(S), dtype=torch.int32, device=dev)
    out[:2] = key.reshape(1).view(torch.int32)
    out[2] = max_pods
    out[3] = INT32_MAX
    if int(key) != INT64_MAX:
        chosen = int(key) & 0xFFFFFFFF  # the low word: the global index
        out[3] = chosen
        out[HEADER:HEADER + S] = k[:, chosen - offset]
    return out


def type_fill_plain(shapes: torch.Tensor, counts: torch.Tensor, totals: torch.Tensor,
                    reserved0: torch.Tensor, valid: torch.Tensor, pods_unit: int,
                    stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One node decision's walk over T types → ``(npacked (T,), k (S,
    T))``, int32, on any device: vectorized over the types, sequential over
    the live shapes. The live shapes (count > 0) are walked from the
    largest to the smallest; a type stops at a failure when it is full or
    has packed nothing, and an invalid type starts stopped. ``stats``,
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
