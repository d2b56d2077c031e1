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

from typing import Optional

import numpy as np


def sparse_record(packed_row: np.ndarray, perm: np.ndarray):
    """A compacted ``packed`` record row → the sparse [(original_shape,
    count), ...] form models/ffd._decode accepts. Padding rows past
    len(perm) are structurally zero, so the slice is exact."""
    row = np.asarray(packed_row[:perm.size])
    return [(int(perm[s]), int(row[s])) for s in np.flatnonzero(row)]


def compact_rows(counts_rows: np.ndarray, perms: list,
                 shapes_full_rows: np.ndarray, maxfit_full_rows: np.ndarray,
                 S_new: int):
    """Compact every problem row of a device run (models/ffd.DeviceRun) to
    the SAME target bucket ``S_new`` (the batch tensors stay uniform; the
    caller picks the bucket of the LARGEST alive set). ``perms`` holds one
    permutation per problem (None = identity); ``shapes_full_rows`` (B,
    S_orig, R) and ``maxfit_full_rows`` (B, S_orig) are the ORIGINAL host
    rows. Returns ``(perms, shapes, counts,
    maxfit)``: the updated permutations and the (B, S_new, ·) rows; a row
    with nothing alive compacts to zeros."""
    B, R = counts_rows.shape[0], shapes_full_rows.shape[2]
    shapes_c = np.zeros((B, S_new, R), np.int32)
    counts_c = np.zeros((B, S_new), np.int32)
    maxfit_c = np.zeros((B, S_new), np.int32)
    new_perms = list(perms)
    for b in range(len(perms)):
        alive = np.flatnonzero(counts_rows[b] > 0)
        perm_b = alive if perms[b] is None else perms[b][alive]
        new_perms[b] = perm_b
        shapes_c[b, :alive.size] = shapes_full_rows[b][perm_b]
        counts_c[b, :alive.size] = counts_rows[b][alive]
        maxfit_c[b, :alive.size] = maxfit_full_rows[b][perm_b]
    return new_perms, shapes_c, counts_c, maxfit_c


def scatter_dropped(dropped_full: np.ndarray, dropped_delta: np.ndarray,
                    perm: Optional[np.ndarray]) -> None:
    """Accumulate a chunk's ``dropped`` delta (in the chunk's compacted
    index space) into the original-index accumulator, in place."""
    if perm is None:
        dropped_full[:dropped_delta.shape[0]] += dropped_delta
    else:
        np.add.at(dropped_full, perm, dropped_delta[:perm.size])
