"""Active-shape compaction: re-bucket the alive shapes between chunks.

FFD consumes shapes in descending order, so after the first committed nodes
most of a high-cardinality problem's shape rows have ``counts == 0`` — and
a ``count == 0`` shape is a provable no-op in the pack step (``active`` is
False, so ``k == 0`` and the reservation/stop/npacked state is untouched).
Gathering the alive shapes into a dense prefix therefore cannot change any
packing decision; it only lets the next chunk run on a smaller shape
bucket. The gather is a stable ascending-index take (``np.flatnonzero``),
which preserves the descending FFD visit order. ``maxfit`` depends only on
(shapes, totals, reserved0, valid), so the compacted problem's bound is
exactly ``maxfit_full[perm]``.

The permutation ``perm`` maps compacted row → ORIGINAL (padded) shape
index; the chunk loop uses it to decode ``packed`` record rows and
``dropped`` deltas back to the original index space.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from karpenter_tpu_torch.ops.encode import SHAPE_BUCKETS, bucket


class Compaction(NamedTuple):
    perm: np.ndarray      # (n_alive,) int64: compacted row → original index
    shapes: np.ndarray    # (S_new, R) int32, alive prefix + zero padding
    counts: np.ndarray    # (S_new,) int32
    maxfit: np.ndarray    # (S_new,) int32 (padding rows irrelevant: k==0)
    num_shapes: int       # S_new (the new, smaller bucket)


def compact_alive(
    counts_now: np.ndarray,        # (S_cur,) current chunk-boundary counts
    perm: Optional[np.ndarray],    # current compaction, None = identity
    shapes_full: np.ndarray,       # (S_orig, R) the ORIGINAL padded shapes
    maxfit_full: np.ndarray,       # (S_orig,) the once-per-solve bound
) -> Optional[Compaction]:
    """Decide whether re-bucketing the alive shapes pays off; None when the
    alive set still needs the current bucket (or no shapes remain alive)."""
    S_cur = counts_now.shape[0]
    alive = np.flatnonzero(counts_now > 0)  # ascending: stable, order-safe
    if alive.size == 0:
        return None
    S_new = bucket(int(alive.size), SHAPE_BUCKETS)
    if S_new is None or S_new >= S_cur:
        return None
    new_perm = alive if perm is None else perm[alive]
    R = shapes_full.shape[1]
    shapes_c = np.zeros((S_new, R), np.int32)
    shapes_c[:alive.size] = shapes_full[new_perm]
    counts_c = np.zeros((S_new,), np.int32)
    counts_c[:alive.size] = counts_now[alive]
    maxfit_c = np.zeros((S_new,), np.int32)
    maxfit_c[:alive.size] = maxfit_full[new_perm]
    return Compaction(new_perm, shapes_c, counts_c, maxfit_c, S_new)


def sparse_record(packed_row: np.ndarray, perm: np.ndarray):
    """A compacted ``packed`` record row → the sparse [(original_shape,
    count), ...] form models/ffd._decode accepts. Padding rows past
    len(perm) are structurally zero, so the slice is exact."""
    row = np.asarray(packed_row[:perm.size])
    return [(int(perm[s]), int(row[s])) for s in np.flatnonzero(row)]


def scatter_dropped(dropped_full: np.ndarray, dropped_delta: np.ndarray,
                    perm: Optional[np.ndarray]) -> None:
    """Accumulate a chunk's ``dropped`` delta (in the chunk's compacted
    index space) into the original-index accumulator, in place."""
    if perm is None:
        dropped_full[:dropped_delta.shape[0]] += dropped_delta
    else:
        np.add.at(dropped_full, perm, dropped_delta[:perm.size])
