"""Shared pieces of the FFD pack: the fast-forward bound and the flat layout.

``compute_maxfit`` is the per-shape upper bound on any valid type's capacity
fit from the initial reservation — the bound that makes the fast-forward
exact (docs/solver.md §4). It depends only on (shapes, totals, reserved0,
valid), so a solve computes it once, on the device, and passes it to every
chunk. It is plain torch ops, unrolled over R so peak memory is (S, T),
never (S, T, R).

The flat buffer is the one layout every pack implementation returns:
``[counts S | dropped S | done 1 | chosen L | q L | packed L·S]``, int32,
so a chunk costs one device→host copy.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1
# the largest (B, S, T) intermediate compute_maxfit builds in one pass (64 MB)
_BATCHED_ELEMENTS = 1 << 24


def compute_maxfit(shapes: torch.Tensor, totals: torch.Tensor,
                   reserved0: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(S,) int32: max over valid types of min over resources r with
    shape[r] > 0 of floor((total - reserved0) / shape), INT32_MAX where a
    shape requests nothing, -1 where no type is valid.

    With a leading batch axis ((B, S, R) shapes, (B, T, R) totals and
    reserved0, (B, T) valid) it returns (B, S): one (B, S, T) pass while
    that holds at most ``_BATCHED_ELEMENTS`` int32, else problem by
    problem, so peak memory stays bounded at the large shape buckets."""
    if shapes.dim() == 3:
        B, S, _ = shapes.shape
        if B * S * totals.shape[1] > _BATCHED_ELEMENTS:
            return torch.stack([compute_maxfit(shapes[b], totals[b], reserved0[b], valid[b])
                                for b in range(B)])
        avail0 = totals - reserved0  # (B, T, R)
        kfit0 = torch.full((B, S, totals.shape[1]), INT32_MAX, dtype=torch.int32,
                           device=shapes.device)
        for r in range(shapes.shape[2]):
            col = shapes[:, :, r:r + 1]  # (B, S, 1)
            kr = torch.div(avail0[:, None, :, r], col.clamp(min=1), rounding_mode="floor")
            kfit0 = torch.minimum(kfit0, torch.where(col > 0, kr, INT32_MAX))
        return torch.where(valid[:, None, :], kfit0, -1).amax(dim=2).to(torch.int32)
    S, R = shapes.shape
    T = totals.shape[0]
    avail0 = totals - reserved0  # (T, R)
    kfit0 = torch.full((S, T), INT32_MAX, dtype=torch.int32, device=shapes.device)
    for r in range(R):
        col = shapes[:, r:r + 1]  # (S, 1)
        kr = torch.div(avail0[None, :, r], col.clamp(min=1), rounding_mode="floor")
        kfit0 = torch.minimum(kfit0, torch.where(col > 0, kr, INT32_MAX))
    neg = torch.full_like(kfit0, -1)
    return torch.where(valid[None, :], kfit0, neg).amax(dim=1).to(torch.int32)


def flat_size(S: int, L: int) -> int:
    return 2 * S + 1 + 2 * L + L * S


def flatten_chunk_outputs(counts, dropped, done, chosen, q, packed) -> torch.Tensor:
    """THE flat buffer layout (decoded by :func:`unpack_flat`)."""
    done_t = torch.as_tensor([int(bool(done))], dtype=torch.int32, device=counts.device)
    return torch.cat([
        counts.to(torch.int32), dropped.to(torch.int32), done_t,
        chosen.to(torch.int32), q.to(torch.int32), packed.reshape(-1).to(torch.int32),
    ])


def unpack_flat(buf: np.ndarray, S: int, L: int):
    """Split a flat buffer (host numpy) back into its components. Raises on
    the CUDA kernel's error word (done == -1: a fill log outgrew its bound,
    or no valid type tied at last_valid)."""
    counts_f = buf[:S]
    dropped_f = buf[S:2 * S]
    if buf[2 * S] not in (0, 1):
        raise RuntimeError(
            f"pack chunk failed (done word {int(buf[2 * S])}): a type's fill "
            "log outgrew its bound, or no valid type tied at last_valid")
    done = bool(buf[2 * S])
    o = 2 * S + 1
    chosen = buf[o:o + L]
    q = buf[o + L:o + 2 * L]
    packed = buf[o + 2 * L:o + 2 * L + L * S].reshape(L, S)
    return counts_f, dropped_f, done, chosen, q, packed
