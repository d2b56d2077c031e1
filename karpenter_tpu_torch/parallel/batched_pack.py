"""Batched packing: many schedules solved in one launch a shard.

The provisioning window yields a batch of independent packing problems (one
per isomorphic-constraint schedule). The JAX package solves them as the
Pallas kernel under ``jax.vmap`` within a chip and ``shard_map`` across a
mesh (karpenter_tpu/parallel/sharded_pack.py). Here the batch is padded to
a multiple of the solver mesh's size (parallel/mesh.py) and cut into one
contiguous range of rows a shard; within a shard the rows are the CUDA
grid, a cluster of CTAs per problem (``ops/pack_cuda.pack_batch``), and
the shard's output is one (rows, 2S+1+2L+L·S) int32 buffer, so a chunk
costs one device→host copy a shard. The problems are independent: no
collective joins the shards.

- :func:`pad_problems` stacks encoded problems into one (S, T) bucket and
  pads the batch to a multiple of the mesh size;
- :func:`karpenter_tpu_torch.ops.pack_cuda.pack_batch` is the plain flat
  call (the JAX package's ``pack_batch_sharded_flat`` on one device);
- :func:`pack_batch_ring` is the chunk-resume call of every device solve
  (models/ffd.DeviceRun), one problem or many, one call a shard on the
  shard's device and its current stream: it returns ``(flat,
  counts_next, dropped_next)``, the next chunk's counts already on the
  device and zeroed dropped rows, so a resume that compacts nothing copies
  nothing from host to device. torch has no buffer donation; the two are
  fresh tensors, and the inputs stay valid;
- :func:`unpack_batch_flat` splits a host copy of the buffer.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from karpenter_tpu_torch.ops import pack_cuda
from karpenter_tpu_torch.ops.pack import unpack_flat
from karpenter_tpu_torch.ops.pack_cuda import pack_batch


def pack_batch_ring(shapes, counts, dropped, totals, reserved0, valid,
                    last_valid, pods_unit, num_iters: int, prices=None,
                    maxfit=None, **kw):
    """:func:`karpenter_tpu_torch.ops.pack_cuda.pack_batch` (the other
    keyword arguments go to it) plus the chunk-resume contract of the JAX
    package's donating ring call: ``counts_next`` is ``flat[:, :S]`` made
    contiguous on the device and ``dropped_next`` is zeros (the host
    accumulates each chunk's dropped delta from ``flat``). A batch of one,
    solve()'s or a shard's of one row, launches through ``pack_chunk``, the
    one-problem entry: the same kernel and the same row. The launch runs
    on the tensors' device and its current stream."""
    if shapes.shape[0] == 1:
        one = lambda t: None if t is None else t[0]  # noqa: E731
        flat = pack_cuda.pack_chunk(
            shapes[0], counts[0], dropped[0], totals[0], reserved0[0], valid[0],
            last_valid, pods_unit, num_iters, prices=one(prices), maxfit=one(maxfit),
            **kw)[None]
    else:
        flat = pack_batch(shapes, counts, dropped, totals, reserved0, valid,
                          last_valid, pods_unit, num_iters, prices=prices,
                          maxfit=maxfit, **kw)
    S = counts.shape[1]
    return flat, flat[:, :S].contiguous(), torch.zeros_like(dropped)


def unpack_batch_flat(buf: np.ndarray, S: int, L: int):
    """A host copy of a (B, ·) batch buffer → batched per-problem
    ``(counts, dropped, done, chosen, q, packed)`` via
    :func:`karpenter_tpu_torch.ops.pack.unpack_flat`, which raises on a
    row's error word."""
    rows = [unpack_flat(row, S, L) for row in buf]
    counts_f, dropped_f, done, chosen, q, packed = (
        np.stack([r[i] for r in rows]) for i in range(6))
    return counts_f, dropped_f, done.astype(bool), chosen, q, packed


def pad_problems(problems: Sequence, mesh_size: int = 1):
    """Stack encoded problems (``ops.encode.EncodedProblem``, padded) into
    numpy batch arrays, every problem padded to the largest S and T bucket
    of the batch and the batch to a multiple of ``mesh_size``: ``(shapes,
    counts, dropped, totals, reserved0, valid, last_valid, pods_unit, B)``
    with B the number of real problems. Padding shapes have count 0 (a
    no-op) and padding types are not valid; a padding problem has count 0
    everywhere, no valid type and ``pods_unit`` 1 (the JAX package's
    ``sharded_pack.pad_problems``), which the kernel finishes at once."""
    S = max(p.shapes.shape[0] for p in problems)
    T = max(p.totals.shape[0] for p in problems)
    R = problems[0].shapes.shape[1]
    B = len(problems)
    Bpad = -(-B // mesh_size) * mesh_size
    shapes = np.zeros((Bpad, S, R), np.int32)
    counts = np.zeros((Bpad, S), np.int32)
    totals = np.zeros((Bpad, T, R), np.int32)
    reserved0 = np.zeros((Bpad, T, R), np.int32)
    valid = np.zeros((Bpad, T), bool)
    last_valid = np.zeros((Bpad,), np.int32)
    pods_unit = np.ones((Bpad,), np.int32)
    for b, p in enumerate(problems):
        s, t = p.shapes.shape[0], p.totals.shape[0]
        shapes[b, :s] = p.shapes
        counts[b, :s] = p.counts
        totals[b, :t] = p.totals
        reserved0[b, :t] = p.reserved0
        valid[b, :t] = p.valid
        last_valid[b] = p.last_valid
        pods_unit[b] = p.pods_unit
    dropped = np.zeros_like(counts)
    return shapes, counts, dropped, totals, reserved0, valid, last_valid, pods_unit, B
