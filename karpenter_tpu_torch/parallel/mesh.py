"""The device mesh of the type-axis solve: an ordered tuple of devices.

The JAX package's mesh (karpenter_tpu/parallel/mesh.py) is a
``jax.sharding.Mesh`` with named axes, from which every sharded entry point
derives its ``NamedSharding``s. The port has one sharded path, the
type-axis SPMD chunk (parallel/type_sharded.py), and its mesh is the
ordered tuple of devices its shards live on, one shard a device, on the
axis ``AXIS``. A device may repeat: ``type_mesh(["cuda:0"] * 8)`` is a
virtual mesh of eight shards on one card, and ``type_mesh(["cpu"] * n)``
the CPU tests' mesh, as the JAX tests force eight virtual CPU devices.
Every shard runs the same collective code whether its devices are distinct
or not.

The JAX ``batch_sharding`` and ``replicated`` have no counterpart: the
port's batched window runs on one card (parallel/batched_pack.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

AXIS = "types"

Mesh = Tuple[torch.device, ...]


def type_mesh(devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """The mesh over ``devices`` in order (repeats allowed), or over every
    CUDA device; raises ``RuntimeError`` when there is none and none were
    named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("type_mesh: no CUDA device (torch.cuda.is_available() is "
                               "False); name the devices to build a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("type_mesh: a mesh needs at least one device")
    return mesh


def device_count() -> int:
    """The CUDA devices of this process (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def device_bytes_in_use(devices: Optional[Sequence[Union[str, torch.device]]] = None) -> dict:
    """Bytes the CUDA caching allocator holds in tensors, by device index
    (``torch.cuda.memory_allocated``), over ``devices`` (a repeated device
    counts once) or every CUDA device; CPU devices are left out, so it is
    {} without a card."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(device_count())]
    out: dict = {}
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            index = d.index if d.index is not None else torch.cuda.current_device()
            out[index] = int(torch.cuda.memory_allocated(index))
    return out
