"""The cloud provider SPI: the catalog types the solver reads and the
provider contract the provisioning controller launches nodes through.

A trimmed copy of the JAX package's provider SPI
(pkg/cloudprovider/types.go:29-76) plus the fake provider's
``make_instance_type`` constructor (fake.NewInstanceType defaults). Create
is callback-based, so a provider may batch node launches. Providers that
can enumerate their capacity implement ``list_instances`` and
``delete_instance``, the garbage collector's and startup recovery's input
(:class:`CapacityRecord`).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Node
from karpenter_tpu_torch.api.gang import instance_slice_shape
from karpenter_tpu_torch.utils.resources import Quantity, ResourceList, parse_resource_list


@dataclass(frozen=True)
class Offering:
    """A (capacity type, zone) pair an instance type is available in
    (types.go:73-76). ``interruption_rate`` is advisory pricing input;
    feasibility never consults it."""

    capacity_type: str  # "spot" | "on-demand"
    zone: str
    interruption_rate: float = 0.0


@dataclass(frozen=True)
class CapacityRecord:
    """Provider-side view of one unit of live capacity, as enumerated by
    :meth:`CloudProvider.list_instances`.

    The garbage collector (controllers/gc.py) cross-references these
    records against Node objects to find capacity the control plane paid
    for but lost track of (a crash between create and the Node write) and
    Nodes whose capacity was terminated out of band; startup recovery
    (controllers/recovery.py) attributes them to journaled launches.

    ``instance_id`` must appear verbatim as a path segment of the
    providerID the provider stamps on its Nodes (``fake:///<id>/<zone>``):
    that containment is the ownership test. ``launch_nonce`` is stamped at
    launch time, before any Node exists, so an orphan is attributable to
    the launch that leaked it."""

    instance_id: str
    provisioner_name: str = ""
    launch_nonce: str = ""
    created_unix: float = 0.0
    zone: str = ""
    instance_type: str = ""
    # capacity type the launch drew from ("spot" | "on-demand")
    capacity_type: str = ""


@dataclass
class InstanceType:
    """Concrete instance type description (types.go:55-69). ``price`` is the
    on-demand $/h the cost model orders options by."""

    name: str
    offerings: List[Offering] = field(default_factory=list)
    architecture: str = "amd64"
    operating_systems: frozenset = frozenset({"linux"})
    cpu: Quantity = field(default_factory=lambda: Quantity(0))
    memory: Quantity = field(default_factory=lambda: Quantity(0))
    pods: Quantity = field(default_factory=lambda: Quantity(0))
    nvidia_gpus: Quantity = field(default_factory=lambda: Quantity(0))
    amd_gpus: Quantity = field(default_factory=lambda: Quantity(0))
    aws_neurons: Quantity = field(default_factory=lambda: Quantity(0))
    aws_pod_eni: Quantity = field(default_factory=lambda: Quantity(0))
    overhead: ResourceList = field(default_factory=dict)
    price: float = 0.0
    # TPU slice topology this type advertises ("v5e-4x4"; "" = none). Gangs
    # carrying a pod-group-slice label only land on types whose topology
    # contains the requested shape (api/gang.py, ops/feasibility.py).
    tpu_topology: str = ""

    def grid_dims(self) -> Optional[Tuple[int, ...]]:
        """Chip-grid dimensions of the advertised TPU topology (the torus
        ops/topology.py models occupancy over), or None when the type
        hosts no slices. Parsed once and cached on the instance."""
        cached = self.__dict__.get("_grid_dims", False)
        if cached is not False:
            return cached
        shape = instance_slice_shape(self)
        dims = shape.dims if shape is not None else None
        self.__dict__["_grid_dims"] = dims
        return dims


_DEFAULT_OFFERINGS = [
    Offering("spot", "test-zone-1"),
    Offering("spot", "test-zone-2"),
    Offering("on-demand", "test-zone-1"),
    Offering("on-demand", "test-zone-2"),
    Offering("on-demand", "test-zone-3"),
]


def make_instance_type(
    name: str,
    offerings: Optional[List[Offering]] = None,
    architecture: str = "amd64",
    operating_systems: frozenset = frozenset({"linux", "windows", "darwin"}),
    cpu: str = "4",
    memory: str = "4Gi",
    pods: str = "5",
    nvidia_gpus: str = "0",
    amd_gpus: str = "0",
    aws_neurons: str = "0",
    aws_pod_eni: str = "0",
    price: float = 0.0,
    tpu_topology: str = "",
) -> InstanceType:
    """fake.NewInstanceType defaults (instancetype.go:27-52)."""
    return InstanceType(
        name=name,
        offerings=list(offerings) if offerings else list(_DEFAULT_OFFERINGS),
        architecture=architecture,
        operating_systems=operating_systems,
        cpu=Quantity.parse(cpu),
        memory=Quantity.parse(memory),
        pods=Quantity.parse(pods),
        nvidia_gpus=Quantity.parse(nvidia_gpus),
        amd_gpus=Quantity.parse(amd_gpus),
        aws_neurons=Quantity.parse(aws_neurons),
        aws_pod_eni=Quantity.parse(aws_pod_eni),
        overhead=parse_resource_list({"cpu": "100m", "memory": "10Mi"}),
        price=price,
        tpu_topology=tpu_topology,
    )


BindCallback = Callable[[Node], Optional[str]]


class CloudProvider(abc.ABC):
    """Provider contract (types.go:29-46)."""

    @abc.abstractmethod
    def create(self, constraints: Constraints, instance_types: Sequence[InstanceType],
               quantity: int, bind: BindCallback) -> List[Optional[str]]:
        """Launch ``quantity`` nodes drawn from ``instance_types`` and invoke
        ``bind`` for each created node. Returns per-node errors (None=ok)."""

    @abc.abstractmethod
    def delete(self, node: Node) -> Optional[str]:
        """Terminate the capacity backing ``node``."""

    @abc.abstractmethod
    def get_instance_types(self, constraints: Constraints) -> List[InstanceType]:
        """The catalog viable for these constraints."""

    def list_instances(self) -> List[CapacityRecord]:
        """Enumerate the provider-side capacity this control plane launched.
        The default returns nothing, which makes the garbage collector a
        no-op for providers that cannot enumerate; it must never return a
        partial view, because records missing here read as out-of-band
        terminations and get their Nodes reaped."""
        return []

    def delete_instance(self, instance_id: str) -> Optional[str]:
        """Terminate capacity by provider instance id, for orphans that
        never got a Node object. Not-found is success (the capacity is gone
        either way). None means terminated."""
        return f"provider {self.name()} cannot terminate by instance id"

    @abc.abstractmethod
    def name(self) -> str:
        ...
