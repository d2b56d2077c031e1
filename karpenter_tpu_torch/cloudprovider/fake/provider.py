"""Fake cloud provider: in-memory capacity for the port's controllers.

Reference: pkg/cloudprovider/fake/{cloudprovider.go,instancetype.go}. A
trimmed copy of the JAX package's fake: nodes are fabricated as API objects
honoring zone/capacity-type requirements; the synthetic catalog matches the
reference fixture exactly (i-th type = (i+1) vCPU, 2(i+1) Gi, 10(i+1)
pods). Every launch is registered in a provider-side capacity ledger
(:class:`~karpenter_tpu_torch.cloudprovider.spi.CapacityRecord`) before its
bind runs, with one launch nonce per ``create`` (the journal's pre-assigned
nonce when the caller journaled the launch), so a crash between the launch
and the Node write leaves an enumerable, attributable orphan for the
garbage collector and startup recovery. Faults: ``insufficient_capacity``
pools and the chaos plan's ``provider``/``create`` kinds (``ice``,
``crash-before-bind``, ``spot-interruption``).
"""

from __future__ import annotations

import itertools
import threading
import uuid
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Node, NodeCondition, NodeSpec, NodeStatus, ObjectMeta
from karpenter_tpu_torch.chaos import inject
from karpenter_tpu_torch.cloudprovider import spi
from karpenter_tpu_torch.cloudprovider.spi import (
    CapacityRecord, CloudProvider, InstanceType, make_instance_type,
)
from karpenter_tpu_torch.runtime import journal
from karpenter_tpu_torch.utils import clock
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
        # zero-capacity (name, zone, capacity_type) triples, the AWS fake's
        # InsufficientCapacityPools
        self.insufficient_capacity: set = set()
        # provider-side capacity ledger: instance id (= node name) → record,
        # registered BEFORE bind runs, as CreateFleet's tags are
        self._capacity: Dict[str, CapacityRecord] = {}
        self._lock = threading.Lock()

    def create(self, constraints, instance_types_, quantity, bind):
        errs: List[Optional[str]] = []
        provisioner_name = constraints.labels.get(wellknown.PROVISIONER_NAME_LABEL, "default")
        # one nonce per create call, shared by every unit it launches; a
        # journaled launch's pre-stamped nonce wins, so crashed launches stay
        # attributable across a restart
        launch_nonce = journal.current_preassigned_nonce() or uuid.uuid4().hex
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
            # one fault draw per unit: ice refuses the launch,
            # crash-before-bind leaks it, spot-interruption reclaims the
            # oldest running spot instance while this launch proceeds
            fault = inject.active_fault("provider", "create")
            if fault == "spot-interruption":
                self.reclaim_spot(1)
            if (instance.name, zone, capacity_type) in self.insufficient_capacity \
                    or fault == "ice":
                errs.append(f"insufficient capacity for {instance.name} in {zone}")
                continue
            # the capacity exists from here on
            with self._lock:
                self._capacity[name] = CapacityRecord(
                    instance_id=name, provisioner_name=provisioner_name,
                    launch_nonce=launch_nonce, created_unix=clock.now(), zone=zone,
                    instance_type=instance.name, capacity_type=capacity_type)
            if fault == "crash-before-bind":
                # the controller dies between the launch and the Node write:
                # the instance is leaked until GC or recovery reaps it
                errs.append(f"injected crash before bind of {name}")
                continue
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
            # fake providerID is fake:///<instance-id>/<zone>; the instance
            # id doubles as the node name
            parts = (node.spec.provider_id or "").split("/")
            instance_id = parts[3] if len(parts) > 3 else node.metadata.name
            self._capacity.pop(instance_id, None)
        return None

    def list_instances(self) -> List[CapacityRecord]:
        with self._lock:
            return list(self._capacity.values())

    def delete_instance(self, instance_id: str) -> Optional[str]:
        with self._lock:
            if self._capacity.pop(instance_id, None) is not None:
                self.deleted.append(instance_id)
        return None  # not-found is success: the capacity is gone either way

    def reclaim_spot(self, limit: int = 1) -> List[str]:
        """Out-of-band termination of up to ``limit`` spot instances, the
        fake's spot interruption: the ledger entry vanishes while any Node
        object survives as a ghost for GC to reap. Oldest launches first."""
        with self._lock:
            spot = sorted((r for r in self._capacity.values()
                           if r.capacity_type == wellknown.CAPACITY_TYPE_SPOT),
                          key=lambda r: (r.created_unix, r.instance_id))
            victims = [r.instance_id for r in spot[:max(0, limit)]]
            for iid in victims:
                self._capacity.pop(iid, None)
                self.deleted.append(iid)
        return victims

    def get_instance_types(self, constraints: Constraints) -> List[InstanceType]:
        if self.catalog is not None:
            return list(self.catalog)
        return default_catalog()

    def name(self) -> str:
        return "fake"


spi.register("fake", FakeCloudProvider)
