"""Type-axis SPMD packing: one problem's FFD chunk with the type axis split
over a mesh (B12).

The port of karpenter_tpu/parallel/type_sharded.py. Each shard of the
mesh (parallel/mesh.py) holds T / n of the instance types. Every node
decision is one launch a shard of the hand kernel
(``ops/type_shard_cuda.shard_candidate``, csrc/type_shard.cu), which walks
the shard's types and the globally last valid type (its row replicated
once a chunk, so each shard knows max_pods, the packer's upper bound,
packer.go:167-170, without a collective) and returns the shard's
candidate: the least key price * 2^32 + global index over its ties (price
0 unless the cost tie-break is on) with that type's fill column. Two
collectives remain:

- ``pmax`` of each shard's ``maxfit``: the fast-forward bound, once a
  chunk;
- ``least_key`` of the shards' candidates, once a decision: the first
  (cheapest, then lowest-index) type that reaches the bound
  (packer.go:174-183) and its pack vector.

The collectives are written once, over a list of per-shard tensors: each
gathers the parts on the mesh's first device by device-to-device copies
and reduces there (``pmax`` sends the result back to every shard). A
repeated device makes those copies no-ops, so a virtual mesh on one card
and a mesh over several cards run the same code. The decision's tail (q,
the drop, the record) runs once on the first device, which broadcasts the
new counts.

The decision loop stops at ``done`` (the JAX ``while_loop``), reading it
back to the host once a decision (``DONE_READS``); rows past ``done`` keep
their initial values (chosen -1, q 0, packed 0). The result is the flat
buffer of ``ops/pack.flatten_chunk_outputs`` on the first device, bit for
bit the JAX package's, and bit for bit ``pack_chunk`` on the rows with
q > 0. Nothing is donated.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from karpenter_tpu_torch.ops.pack import INT32_MAX, compute_maxfit, flatten_chunk_outputs
from karpenter_tpu_torch.ops.type_shard_cuda import (
    HEADER, new_workspace, probe_row, row_key, shard_candidate,
)
from karpenter_tpu_torch.parallel.mesh import Mesh

# node decisions taken, and reads of ``done`` back to the host, since the
# counts were last set to 0
DECISIONS = 0
DONE_READS = 0

IntOrTensor = Union[int, torch.Tensor]


def _gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    return torch.stack([p.to(mesh[0]) for p in parts])


def _send_back(value: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    return [value.to(d) for d in mesh]


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The elementwise maximum of the shards' parts, on every shard."""
    return _send_back(_gather(parts, mesh).amax(0), mesh)


def least_key(rows: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' candidate rows (``shard_candidate``) gathered on the
    first device, and the one with the least key there."""
    stacked = _gather(rows, mesh)
    return stacked[row_key(stacked).argmin()]


def pack_chunk_type_sharded(
    shapes: torch.Tensor, counts: torch.Tensor, dropped: torch.Tensor,
    totals: torch.Tensor, reserved0: torch.Tensor, valid: torch.Tensor,
    last_valid: IntOrTensor, pods_unit: IntOrTensor,
    *,
    num_iters: int,
    mesh: Mesh,
    prices: Optional[torch.Tensor] = None,
    cost_tiebreak: bool = False,
) -> torch.Tensor:
    """Up to ``num_iters`` node decisions of one problem with its T types
    split over ``mesh`` → the flat int32 buffer of
    ``ops/pack.flatten_chunk_outputs`` on ``mesh[0]``. The arguments are
    ``pack_chunk``'s (``prices`` (T,) int32 micro-$, read with
    ``cost_tiebreak``: the cheapest max-pods type wins). T must be a
    multiple of the mesh's size (AssertionError otherwise): the type
    buckets are powers of two, so any power-of-two mesh divides them."""
    global DECISIONS, DONE_READS
    T, n = totals.shape[0], len(mesh)
    if T % n:
        raise AssertionError(f"type axis {T} not divisible by mesh size {n}")
    T_l, dev0 = T // n, mesh[0]
    S, L = shapes.shape[0], int(num_iters)
    last_valid, pods_unit = int(last_valid), int(pods_unit)
    i32 = torch.int32
    if cost_tiebreak and prices is None:
        prices = torch.zeros(T, dtype=i32, device=totals.device)

    # the type-axis tensors split once a chunk, each shard on its device;
    # the shapes replicated
    def split(t):
        return [t[j * T_l:(j + 1) * T_l].to(d).contiguous() for j, d in enumerate(mesh)]

    tot, res0, val = split(totals), split(reserved0), split(valid)
    pri = split(prices) if cost_tiebreak else [None] * n
    shp = [shapes.to(d) for d in mesh]
    # the globally last valid type's row, replicated: each shard walks it
    probe = probe_row(totals, reserved0, valid, last_valid)
    probes = [probe.to(d) for d in mesh]
    work = [new_workspace(d) for d in mesh]

    # fast-forward bound: each shard's maxfit, pmax over the mesh, once a chunk
    maxfit = pmax([compute_maxfit(shp[j], tot[j], res0[j], val[j]) for j in range(n)],
                  mesh)[0]

    counts_c = counts.to(dev0, i32)
    dropped_c = dropped.to(dev0, i32)
    chosen_buf = torch.full((L,), -1, dtype=i32, device=dev0)
    q_buf = torch.zeros(L, dtype=i32, device=dev0)
    packed_buf = torch.zeros((L, S), dtype=i32, device=dev0)
    positions = torch.arange(S, device=dev0)
    done = not bool((counts_c > 0).any())
    DONE_READS += 1
    i = 0
    while i < L and not done:
        cs = _send_back(counts_c, mesh)
        # the decision: the least (price, index) key over every shard's ties,
        # its row holding max_pods, the chosen index and the pack vector
        row = least_key([shard_candidate(shp[j], cs[j], tot[j], res0[j], val[j], pri[j],
                                         probes[j], j * T_l, pods_unit, work[j])
                         for j in range(n)], mesh)
        max_pods, chosen, packedv = row[2], row[3], row[HEADER:HEADER + S]

        # the decision's tail, once, on the first device
        nothing = max_pods == 0
        terms = torch.where(packedv > 0, torch.div(counts_c - maxfit - 1, packedv.clamp(min=1),
                                                   rounding_mode="floor"), INT32_MAX)
        q = torch.where(nothing, 0, (1 + terms.amin()).clamp(min=1)).to(i32)
        largest = torch.argmax((counts_c > 0).to(i32))
        drop_vec = torch.where((positions == largest) & nothing, counts_c, 0)
        counts_c = (counts_c - q * packedv - drop_vec).to(i32)
        dropped_c = (dropped_c + drop_vec).to(i32)
        chosen_buf[i] = torch.where(q > 0, chosen, -1)
        q_buf[i] = q
        packed_buf[i] = packedv
        i += 1
        DECISIONS += 1
        done = not bool((counts_c > 0).any())
        DONE_READS += 1
    return flatten_chunk_outputs(counts_c, dropped_c, done, chosen_buf, q_buf, packed_buf)

