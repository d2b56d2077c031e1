"""Type-axis SPMD packing: one problem's FFD chunk with the type axis split
over a mesh (B12).

The port of karpenter_tpu/parallel/type_sharded.py. Each shard of the
mesh (parallel/mesh.py) holds T / n of the instance types; every node
decision walks each shard's types locally (the hand kernel
``ops/type_shard_cuda.type_fill``, csrc/type_shard.cu) and reaches the
decision through three collectives:

- ``pmax`` of each shard's ``maxfit``: the fast-forward bound, once a
  chunk;
- ``psum`` of the probe of the globally last valid type (its owner
  contributes, every other shard zero): ``max_pods``, the packer's upper
  bound (packer.go:167-170); and ``psum`` of the chosen type's fill column
  from its owner: the decision's pack vector;
- ``pmin`` of each shard's first tie's global index: the first type that
  reaches the bound (packer.go:174-183); in cost mode first a ``pmin`` of
  each shard's lowest price among its ties.

The collectives are written once, over a list of per-shard tensors: each
gathers the parts on the mesh's first device by device-to-device copies,
reduces there and sends the result back to every shard. A repeated device
makes those copies no-ops, so a virtual mesh on one card and a mesh over
several cards run the same code. The decision's tail (q, the drop, the
record) runs once on the first device, which broadcasts the new counts.

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
from karpenter_tpu_torch.ops.type_shard_cuda import type_fill
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


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The sum of the shards' parts, on every shard (int32 stays int32)."""
    return _send_back(_gather(parts, mesh).sum(0, dtype=parts[0].dtype), mesh)


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The elementwise maximum of the shards' parts, on every shard."""
    return _send_back(_gather(parts, mesh).amax(0), mesh)


def pmin(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The elementwise minimum of the shards' parts, on every shard."""
    return _send_back(_gather(parts, mesh).amin(0), mesh)


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
    pri = split(prices) if cost_tiebreak else None
    shp = [shapes.to(d) for d in mesh]
    offsets = [j * T_l for j in range(n)]
    iota = [torch.arange(o, o + T_l, dtype=i32, device=d) for o, d in zip(offsets, mesh)]
    owner, owner_local = divmod(last_valid, T_l)

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
        fills = [type_fill(shp[j], cs[j], tot[j], res0[j], val[j], pods_unit)
                 for j in range(n)]
        # max_pods: the globally last valid type's pods, from its owner
        probes = [npk[owner_local:owner_local + 1] if j == owner
                  else torch.zeros(1, dtype=i32, device=mesh[j])
                  for j, (npk, _) in enumerate(fills)]
        max_pods = psum(probes, mesh)
        ties = [val[j] & (fills[j][0] == max_pods[j]) for j in range(n)]
        if cost_tiebreak:
            best = pmin([torch.where(ties[j], pri[j], INT32_MAX).amin().reshape(1)
                         for j in range(n)], mesh)
            ties = [ties[j] & (pri[j] == best[j]) for j in range(n)]
        # the first tie's global index, INT32_MAX where a shard has none
        chosen = pmin([torch.where(ties[j], iota[j], INT32_MAX).amin().reshape(1)
                       for j in range(n)], mesh)
        cols = []
        for j in range(n):
            local = chosen[j] - offsets[j]
            mine = (local >= 0) & (local < T_l)
            col = fills[j][1].index_select(1, local.clamp(0, T_l - 1)).reshape(S)
            cols.append(torch.where(mine, col, 0))
        packedv = psum(cols, mesh)[0]

        # the decision's tail, once, on the first device
        nothing = max_pods[0][0] == 0
        terms = torch.where(packedv > 0, torch.div(counts_c - maxfit - 1, packedv.clamp(min=1),
                                                   rounding_mode="floor"), INT32_MAX)
        q = torch.where(nothing, 0, (1 + terms.amin()).clamp(min=1)).to(i32)
        largest = torch.argmax((counts_c > 0).to(i32))
        drop_vec = torch.where((positions == largest) & nothing, counts_c, 0)
        counts_c = (counts_c - q * packedv - drop_vec).to(i32)
        dropped_c = (dropped_c + drop_vec).to(i32)
        chosen_buf[i] = torch.where(q > 0, chosen[0][0], -1)
        q_buf[i] = q
        packed_buf[i] = packedv
        i += 1
        DECISIONS += 1
        done = not bool((counts_c > 0).any())
        DONE_READS += 1
    return flatten_chunk_outputs(counts_c, dropped_c, done, chosen_buf, q_buf, packed_buf)

