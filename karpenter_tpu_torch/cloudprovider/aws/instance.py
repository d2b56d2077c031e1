"""Instance provider: EC2 Fleet launches and terminations.

A copy of the JAX package's module (reference:
pkg/cloudprovider/aws/instance.go). Launches capacity via
CreateFleet type=instant with launch-template configs whose overrides are the
cross-product of (instance type × subnet-in-zone), spot-prioritized; feeds
insufficient-capacity errors back into the offering cache; converts described
instances into Node objects.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import List, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Node, NodeSpec, NodeStatus, ObjectMeta
from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.cloudprovider.aws.discovery import SubnetProvider
from karpenter_tpu_torch.cloudprovider.aws.instancetypes import InstanceTypeProvider
from karpenter_tpu_torch.cloudprovider.aws.launchtemplate import LaunchTemplateProvider
from karpenter_tpu_torch.cloudprovider.aws.vendor import (
    AWSProvider,
    CAPACITY_TYPE_ON_DEMAND,
    CAPACITY_TYPE_SPOT,
    merge_tags,
)
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.runtime import journal
from karpenter_tpu_torch.utils.ratelimit import TokenBucket

log = logging.getLogger("karpenter.aws.instance")

NODE_NAME_CONVENTION_IP_NAME = "ip-name"
NODE_NAME_CONVENTION_RESOURCE_NAME = "resource-name"


class InstanceProvider:
    def __init__(
        self,
        ec2api: sdk.EC2API,
        instance_type_provider: InstanceTypeProvider,
        subnet_provider: SubnetProvider,
        launch_template_provider: LaunchTemplateProvider,
        cluster_name: str,
        node_name_convention: str = NODE_NAME_CONVENTION_IP_NAME,
        describe_retry_delay: float = 1.0,
        fleet_limiter=None,
    ):
        self.ec2api = ec2api
        self.instance_type_provider = instance_type_provider
        self.subnet_provider = subnet_provider
        self.launch_template_provider = launch_template_provider
        self.cluster_name = cluster_name
        self.node_name_convention = node_name_convention
        self.describe_retry_delay = describe_retry_delay
        # CreateFleet budget 2 QPS / 100 burst (cloudprovider.go:41-46)
        self.fleet_limiter = fleet_limiter or TokenBucket(2, 100)
        # describes that came back short or failed and were tried again
        # after describe_retry_delay
        self.describe_retries = 0

    # -- create (instance.go:51-90) -----------------------------------------
    def create(
        self,
        constraints: Constraints,
        provider: AWSProvider,
        instance_types: Sequence[InstanceType],
        quantity: int,
        provisioner_name: str = "default",
    ) -> List[Node]:
        """instance_types must arrive sorted by priority for spot (the packer
        emits them smallest-first, which is what the spot
        capacity-optimized-prioritized strategy wants)."""
        ids = self._launch_instances(
            constraints, provider, instance_types, quantity, provisioner_name)
        instances = self._get_instances_with_retry(ids)
        nodes = []
        for instance in instances:
            log.info(
                "Launched instance: %s, hostname: %s, type: %s, zone: %s, capacityType: %s",
                instance.instance_id, instance.private_dns_name,
                instance.instance_type, instance.availability_zone,
                _capacity_type_of(instance))
            node = self._instance_to_node(instance, instance_types)
            if node is None:
                log.error("creating Node from an EC2 Instance: unrecognized "
                          "instance type %s", instance.instance_type)
                continue
            nodes.append(node)
        if not nodes:
            raise RuntimeError("zero nodes were created")
        return nodes

    def terminate(self, node: Node) -> None:
        """Terminate by providerID; NotFound is success (instance.go:92-106)."""
        self.terminate_by_id(get_instance_id(node))

    def terminate_by_id(self, instance_id: str) -> None:
        """Terminate raw capacity with no Node to parse — the GC orphan
        path. NotFound is success (already gone)."""
        try:
            self.ec2api.terminate_instances([instance_id])
        except sdk.EC2Error as e:
            if not e.is_not_found:
                raise

    # -- enumerate (upstream instance garbage collection) --------------------
    LIVE_STATES = ("pending", "running")

    def list_cluster_instances(self) -> List[sdk.Instance]:
        """All live instances this cluster's launches created, enumerated by
        the cluster ownership tag (DescribeInstances by tag filter, paged by
        the client, retried by the shared Retryer). Terminated/shutting-down
        instances are dropped here: they linger in DescribeInstances for up
        to an hour and must not read as leaked capacity."""
        described = self.ec2api.describe_instances_by_tags(
            {f"kubernetes.io/cluster/{self.cluster_name}": "owned"})
        return [i for i in described if i.state in self.LIVE_STATES]

    # -- launch (instance.go:108-149) ---------------------------------------
    def _launch_instances(
        self,
        constraints: Constraints,
        provider: AWSProvider,
        instance_types: Sequence[InstanceType],
        quantity: int,
        provisioner_name: str,
    ) -> List[str]:
        capacity_type = self._get_capacity_type(constraints, instance_types)
        configs = self._launch_template_configs(
            constraints, provider, instance_types, capacity_type)
        # the nonce tag rides the CreateFleet TagSpecification, so it is on
        # the instances from birth — a crash anywhere after this call
        # leaves capacity that list_instances() can enumerate and attribute.
        # A journaled launch pre-stamps the nonce (runtime/journal.py) so
        # the write-ahead record and the cloud tags agree across a restart.
        nonce = journal.current_preassigned_nonce() or uuid.uuid4().hex
        request = sdk.CreateFleetRequest(
            launch_template_configs=configs,
            total_target_capacity=quantity,
            default_target_capacity_type=capacity_type,
            allocation_strategy=(
                "capacity-optimized-prioritized"
                if capacity_type == CAPACITY_TYPE_SPOT else "lowest-price"),
            tags=merge_tags(
                provisioner_name, provider.tags,
                {f"kubernetes.io/cluster/{self.cluster_name}": "owned",
                 wellknown.LAUNCH_NONCE_TAG: nonce}),
        )
        self.fleet_limiter.acquire()
        response = self.ec2api.create_fleet(request)
        self._update_unavailable_offerings(response.errors, capacity_type)
        if not response.instance_ids:
            raise RuntimeError("with fleet error(s), " + "; ".join(sorted({
                f"{e.error_code}: {e.error_message}" for e in response.errors})))
        if len(response.instance_ids) != quantity:
            log.error(
                "Failed to launch %d EC2 instances out of the %d EC2 instances requested",
                quantity - len(response.instance_ids), quantity)
        return list(response.instance_ids)

    def _launch_template_configs(
        self,
        constraints: Constraints,
        provider: AWSProvider,
        instance_types: Sequence[InstanceType],
        capacity_type: str,
    ) -> List[sdk.FleetLaunchTemplateConfig]:
        subnets = self.subnet_provider.get(provider)
        launch_templates = self.launch_template_provider.get(
            constraints, provider, list(instance_types),
            {wellknown.LABEL_CAPACITY_TYPE: capacity_type})
        configs = []
        for name, its in launch_templates.items():
            overrides = self._overrides(
                its, subnets, constraints.requirements.zones() or frozenset(),
                capacity_type)
            if overrides:
                configs.append(sdk.FleetLaunchTemplateConfig(
                    launch_template_name=name, overrides=overrides))
        if not configs:
            raise RuntimeError(
                "no capacity offerings are currently available given the constraints")
        return configs

    @staticmethod
    def _overrides(
        instance_types: Sequence[InstanceType],
        subnets: Sequence[sdk.Subnet],
        zones: frozenset,
        capacity_type: str,
    ) -> List[sdk.FleetOverride]:
        """Cross product of instance type × first-subnet-in-zone, constrained
        by zones/offerings; spot priority = catalog index, so the
        smallest-first ordering biases capacity-optimized-prioritized away
        from excessively large types (instance.go:183-216)."""
        overrides = []
        for i, it in enumerate(instance_types):
            for offering in it.offerings:
                if offering.capacity_type != capacity_type:
                    continue
                if offering.zone not in zones:
                    continue
                for subnet in subnets:
                    if subnet.availability_zone != offering.zone:
                        continue
                    overrides.append(sdk.FleetOverride(
                        instance_type=it.name,
                        subnet_id=subnet.subnet_id,
                        availability_zone=subnet.availability_zone,
                        priority=float(i) if capacity_type == CAPACITY_TYPE_SPOT else None,
                    ))
                    break  # Fleet can't span subnets from the same AZ
        return overrides

    # -- describe (instance.go:218-243) -------------------------------------
    def _get_instances_with_retry(self, ids: List[str]) -> List[sdk.Instance]:
        """3 × 1 s retry: EC2 is eventually consistent after CreateFleet."""
        last_error: Optional[Exception] = None
        for attempt in range(3):
            if attempt:
                self.describe_retries += 1
                time.sleep(self.describe_retry_delay)
            try:
                instances = self._get_instances(ids)
            except Exception as e:  # noqa: BLE001 — retried, re-raised below
                last_error = e
                continue
            return instances
        if last_error is not None:
            raise last_error
        return []

    def _get_instances(self, ids: List[str]) -> List[sdk.Instance]:
        described = self.ec2api.describe_instances(ids)
        if len(described) != len(ids):
            raise RuntimeError(
                f"expected {len(ids)} instance(s), but got {len(described)}")
        if self.node_name_convention == NODE_NAME_CONVENTION_RESOURCE_NAME:
            return described
        with_dns = [i for i in described if i.private_dns_name]
        if len(with_dns) != len(described):
            raise RuntimeError("instance(s) missing PrivateDnsName")
        return with_dns

    def _instance_to_node(
        self, instance: sdk.Instance, instance_types: Sequence[InstanceType],
    ) -> Optional[Node]:
        """EC2 instance → Node object with zone/type/capacity labels and
        providerID (instance.go:245-285)."""
        for it in instance_types:
            if it.name != instance.instance_type:
                continue
            if self.node_name_convention == NODE_NAME_CONVENTION_RESOURCE_NAME:
                node_name = instance.instance_id
            else:
                node_name = instance.private_dns_name.lower()
            resources = {
                "pods": it.pods, "cpu": it.cpu, "memory": it.memory}
            return Node(
                metadata=ObjectMeta(
                    name=node_name,
                    namespace="",
                    labels={
                        wellknown.LABEL_TOPOLOGY_ZONE: instance.availability_zone,
                        wellknown.LABEL_INSTANCE_TYPE: instance.instance_type,
                        wellknown.LABEL_CAPACITY_TYPE: _capacity_type_of(instance),
                    },
                ),
                spec=NodeSpec(provider_id=(
                    f"aws:///{instance.availability_zone}/{instance.instance_id}")),
                status=NodeStatus(capacity=dict(resources), allocatable=dict(resources)),
            )
        return None

    def _update_unavailable_offerings(
        self, errors: List[sdk.CreateFleetError], capacity_type: str) -> None:
        """ICE errors poison the offering cache (instance.go:287-293)."""
        for err in errors:
            if err.error_code == sdk.INSUFFICIENT_CAPACITY_ERROR_CODE:
                self.instance_type_provider.cache_unavailable(
                    err.instance_type, err.availability_zone, capacity_type)

    @staticmethod
    def _get_capacity_type(
        constraints: Constraints, instance_types: Sequence[InstanceType]) -> str:
        """Spot iff the constraints allow spot AND a spot offering exists in
        an allowed zone; else on-demand (instance.go:296-309)."""
        capacity_types = constraints.requirements.capacity_types() or frozenset()
        zones = constraints.requirements.zones() or frozenset()
        if CAPACITY_TYPE_SPOT in capacity_types:
            for it in instance_types:
                for offering in it.offerings:
                    if offering.zone in zones and offering.capacity_type == CAPACITY_TYPE_SPOT:
                        return CAPACITY_TYPE_SPOT
        return CAPACITY_TYPE_ON_DEMAND


def get_instance_id(node: Node) -> str:
    """Parse the instance id out of aws:///<zone>/<id> (instance.go:331-337)."""
    parts = node.spec.provider_id.split("/")
    if len(parts) < 5:
        raise ValueError(f"parsing instance id {node.spec.provider_id}")
    return parts[4]


def _capacity_type_of(instance: sdk.Instance) -> str:
    return (CAPACITY_TYPE_SPOT if instance.spot_instance_request_id
            else CAPACITY_TYPE_ON_DEMAND)
