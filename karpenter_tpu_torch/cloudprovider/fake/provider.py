"""Fake cloud provider: in-memory capacity for the port's controllers.

Reference: pkg/cloudprovider/fake/{cloudprovider.go,instancetype.go}. A
trimmed copy of the JAX package's fake: nodes are fabricated as API objects
honoring zone/capacity-type requirements; the synthetic catalog matches the
reference fixture exactly (i-th type = (i+1) vCPU, 2(i+1) Gi, 10(i+1)
pods). Left out: fault injection (insufficient capacity, the chaos plan)
and the provider-side capacity ledger (the garbage collector's input),
which no port controller reads yet.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Node, NodeCondition, NodeSpec, NodeStatus, ObjectMeta
from karpenter_tpu_torch.cloudprovider.spi import CloudProvider, InstanceType, make_instance_type
from karpenter_tpu_torch.utils.resources import parse_resource_list

__all__ = ["FakeCloudProvider", "default_catalog", "instance_types", "make_instance_type",
           "tpu_catalog"]

_name_counter = itertools.count()


def instance_types(total: int) -> List[InstanceType]:
    """Synthetic incrementing catalog (instancetype.go:73-84): i-th type =
    (i+1) vCPU, 2(i+1) Gi, 10(i+1) pods."""
    return [
        make_instance_type(
            name=f"fake-it-{i}",
            cpu=str(i + 1),
            memory=f"{(i + 1) * 2}Gi",
            pods=str((i + 1) * 10),
        )
        for i in range(total)
    ]


def tpu_catalog() -> List[InstanceType]:
    """Multi-host TPU catalog for slice-carve runs: two 2-D torus hosts
    (v5e 4x4 and 4x8 chip grids, priced per size), one 3-D torus host
    (v4 2x2x4, 16 chips on an x·y·z grid) and a plain CPU type, so
    non-slice pods never land on TPU capacity by accident."""
    return [
        make_instance_type("tpu-v5e-4x4", cpu="32", memory="64Gi",
                           pods="32", price=4.0, tpu_topology="v5e-4x4"),
        make_instance_type("tpu-v5e-4x8", cpu="64", memory="128Gi",
                           pods="64", price=8.0, tpu_topology="v5e-4x8"),
        make_instance_type("tpu-v4-2x2x4", cpu="64", memory="128Gi",
                           pods="64", price=6.0, tpu_topology="v4-2x2x4"),
        make_instance_type("cpu-standard", cpu="16", memory="64Gi",
                           pods="64", price=1.0),
    ]


def default_catalog() -> List[InstanceType]:
    """The 7-type default catalog (fake/cloudprovider.go:85-115)."""
    return [
        make_instance_type("default-instance-type"),
        make_instance_type("pod-eni-instance-type", aws_pod_eni="1"),
        make_instance_type("small-instance-type", cpu="2", memory="2Gi"),
        make_instance_type("nvidia-gpu-instance-type", nvidia_gpus="2"),
        make_instance_type("amd-gpu-instance-type", amd_gpus="2"),
        make_instance_type("aws-neuron-instance-type", aws_neurons="2"),
        make_instance_type("arm-instance-type", architecture="arm64"),
    ]


class FakeCloudProvider(CloudProvider):
    """In-memory provider fabricating Node objects (fake/cloudprovider.go:37-79)."""

    def __init__(self, catalog: Optional[Sequence[InstanceType]] = None,
                 nodes_become_ready: bool = True):
        self.catalog = list(catalog) if catalog is not None else None
        self.nodes_become_ready = nodes_become_ready
        self.created: List[Node] = []
        self.deleted: List[str] = []
        self._lock = threading.Lock()

    def create(self, constraints, instance_types_, quantity, bind):
        errs: List[Optional[str]] = []
        for _ in range(quantity):
            name = f"fake-node-{next(_name_counter)}"
            instance = instance_types_[0]
            zone = capacity_type = ""
            cts = constraints.requirements.capacity_types() or frozenset()
            zones = constraints.requirements.zones() or frozenset()
            for o in instance.offerings:
                if o.capacity_type in cts and o.zone in zones:
                    zone, capacity_type = o.zone, o.capacity_type
                    break
            resources = {"pods": str(instance.pods), "cpu": str(instance.cpu),
                         "memory": str(instance.memory)}
            node = Node(
                metadata=ObjectMeta(
                    name=name,
                    namespace="",
                    labels={
                        wellknown.LABEL_TOPOLOGY_ZONE: zone,
                        wellknown.LABEL_INSTANCE_TYPE: instance.name,
                        wellknown.LABEL_CAPACITY_TYPE: capacity_type,
                    },
                ),
                spec=NodeSpec(provider_id=f"fake:///{name}/{zone}"),
                status=NodeStatus(
                    capacity=parse_resource_list(resources),
                    allocatable=parse_resource_list(resources),
                    # fake capacity "boots" instantly: the Ready condition
                    # the kubelet would eventually report is present from
                    # birth
                    conditions=(
                        [NodeCondition(type="Ready", status="True", reason="KubeletReady")]
                        if self.nodes_become_ready else []),
                ),
            )
            with self._lock:
                self.created.append(node)
            errs.append(bind(node))
        return errs

    def delete(self, node: Node) -> Optional[str]:
        with self._lock:
            self.deleted.append(node.metadata.name)
        return None

    def get_instance_types(self, constraints: Constraints) -> List[InstanceType]:
        if self.catalog is not None:
            return list(self.catalog)
        return default_catalog()

    def name(self) -> str:
        return "fake"
