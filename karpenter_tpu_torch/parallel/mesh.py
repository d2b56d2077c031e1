"""Device meshes: ordered tuples of devices, for the solver's batch axis and
for the type-axis solve.

The JAX package's mesh (karpenter_tpu/parallel/mesh.py) is a
``jax.sharding.Mesh`` with named axes, from which every sharded entry point
derives its ``NamedSharding``s. The port's mesh is the ordered tuple of
devices its shards live on, one shard a device. A device may repeat:
``solver_mesh(["cuda:0"] * 4)`` is a virtual mesh of four shards on one
card, and ``solver_mesh(["cpu"] * n)`` the CPU tests' mesh, as the JAX
tests force eight virtual CPU devices. Every shard runs the same code
whether its devices are distinct or not.

- **The solver mesh** (:func:`solver_mesh`, the batch axis): every
  device window (the provisioning window's batch, its fused mask, the
  global relaxation, what-if candidates and gangs) splits its rows over it.
  The problems of a window are independent, so no collective is needed:
  :func:`batch_sharding` gives each shard a contiguous range of rows, the
  shard's tensors go to its device, each shard has its own launches and
  its own device→host copy, and the host gathers the results in batch
  order. :func:`replicated` is one copy of a tensor per distinct device;
  the windows replicate what every shard reads by the copies they already
  make (the catalog planes through ``ops/device_filter.resident_planes``,
  cached per device; ``free0`` inside each shard's host→device copy).
  :func:`resolve_mesh` maps an entry point's ``device`` argument onto a
  mesh.
- **The type mesh** (:func:`type_mesh`, axis ``AXIS``): the type-axis SPMD
  chunk (parallel/type_sharded.py) splits one problem's types over it. It
  is a solver mesh: ``solve()`` hands its own mesh to the route.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

AXIS = "types"

Mesh = Tuple[torch.device, ...]
MeshLike = Union[None, str, torch.device, Sequence[Union[str, torch.device]]]

_LOCK = threading.Lock()
_CACHED: Optional[Mesh] = None


def _no_card(what: str) -> RuntimeError:
    return RuntimeError(f"{what}: no CUDA device (torch.cuda.is_available() is False); "
                        "name the devices to build a mesh on the CPU")


def _device(d: Union[str, torch.device]) -> torch.device:
    """``d`` as a device with its index: a bare ``cuda`` is the current CUDA
    device, so that every shard names the card it lives on."""
    d = torch.device(d)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d!s}: expected 'cuda' or 'cpu'")
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise _no_card("solver_mesh")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def solver_mesh(devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """The process-wide solver mesh over every CUDA device of the process
    (``CUDA_VISIBLE_DEVICES`` restricts it), cached; raises
    ``RuntimeError`` when there is none. An explicit ``devices`` sequence
    (repeats allowed) bypasses the cache."""
    global _CACHED
    if devices is not None:
        mesh = tuple(_device(d) for d in devices)
        if not mesh:
            raise ValueError("solver_mesh: a mesh needs at least one device")
        return mesh
    with _LOCK:
        if _CACHED is None:
            if not torch.cuda.is_available():
                raise _no_card("solver_mesh")
            _CACHED = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        return _CACHED


def resolve_mesh(device: MeshLike = None) -> Mesh:
    """An entry point's ``device`` argument as a mesh: None or a bare
    ``cuda`` is the solver mesh of every visible card; one named device
    (``"cpu"``, ``"cuda:1"``) a one-device mesh; a sequence of devices the
    mesh over them in order."""
    if device is None:
        return solver_mesh()
    if isinstance(device, (str, torch.device)):
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            return solver_mesh()
        return (_device(d),)
    return solver_mesh(device)


class Shard(NamedTuple):
    """One shard of a batch: its index on the mesh, its device and its
    contiguous rows ``[start, stop)``."""

    index: int
    device: torch.device
    start: int
    stop: int

    @property
    def rows(self) -> slice:
        return slice(self.start, self.stop)


def batch_sharding(rows: int, mesh: Mesh) -> Tuple[Shard, ...]:
    """The JAX ``batch_sharding``'s counterpart: ``rows`` (a multiple of the
    mesh size) cut into contiguous equal ranges, one a shard, in mesh
    order."""
    n = len(mesh)
    if rows % n:
        raise ValueError(f"batch_sharding: {rows} rows do not divide over {n} shards")
    per = rows // n
    return tuple(Shard(k, d, k * per, (k + 1) * per) for k, d in enumerate(mesh))


def row_sharding(rows: int, mesh: Mesh) -> Tuple[Shard, ...]:
    """:func:`batch_sharding` when ``rows`` divides over the mesh, else one
    shard of every row on the mesh's first device (the JAX package's
    ``batch_sharding(mesh) if n % size == 0 else replicated(mesh)``, whose
    replicated program every device runs whole)."""
    if rows % len(mesh) == 0:
        return batch_sharding(rows, mesh)
    return (Shard(0, mesh[0], 0, rows),)


def distinct(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The mesh's devices, each once, in mesh order."""
    return tuple(dict.fromkeys(mesh))


def replicated(tensor: torch.Tensor, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """The JAX ``replicated``'s counterpart: one copy of ``tensor`` per
    distinct device of the mesh (the tensor itself where it already lies)."""
    return {d: tensor if tensor.device == d else tensor.to(d) for d in distinct(mesh)}


# the type-axis SPMD route's mesh is a solver mesh, under its old name
type_mesh = solver_mesh


def device_count() -> int:
    """The size of the solver mesh: the CUDA devices of this process (0
    without a card)."""
    return len(solver_mesh()) if torch.cuda.is_available() else 0


def device_bytes_in_use(devices: Optional[Sequence[Union[str, torch.device]]] = None) -> dict:
    """Bytes the CUDA caching allocator holds in tensors, by device index
    (``torch.cuda.memory_allocated``), over ``devices`` (a repeated device
    counts once) or the solver mesh; CPU devices are left out, so it is {}
    without a card."""
    if devices is None:
        devices = solver_mesh() if torch.cuda.is_available() else ()
    out: dict = {}
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            index = d.index if d.index is not None else torch.cuda.current_device()
            out[index] = int(torch.cuda.memory_allocated(index))
    return out
