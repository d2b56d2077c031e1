"""EC2/SSM API surface: the seam the AWS provider is tested at.

A copy of the JAX package's module. The reference programs against
``ec2iface.EC2API``/``ssmiface.SSMAPI`` and fakes exactly that surface in
tests (pkg/cloudprovider/aws/fake/ec2api.go). The port keeps the same seam:
typed request/response shapes (plain dataclasses), an abstract client, a
programmable fake (``cloudprovider/aws/fake``) and the stdlib HTTP clients
of ``awsclient.py``. No SDK is imported.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional

INSUFFICIENT_CAPACITY_ERROR_CODE = "InsufficientInstanceCapacity"


class EC2Error(Exception):
    """An EC2 API error with a machine-readable code."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code

    @property
    def is_not_found(self) -> bool:
        return self.code.endswith(".NotFound")


# ---------------------------------------------------------------------------
# Shapes (the subset of ec2.* structs the provider reads)
# ---------------------------------------------------------------------------


@dataclass
class GPUInfo:
    manufacturer: str = ""
    count: int = 0


@dataclass
class InstanceTypeInfo:
    """ec2.InstanceTypeInfo subset consumed by the adapter
    (aws/instancetype.go)."""

    instance_type: str = ""
    supported_architectures: List[str] = field(default_factory=lambda: ["x86_64"])
    supported_usage_classes: List[str] = field(default_factory=lambda: ["on-demand", "spot"])
    supported_virtualization_types: List[str] = field(default_factory=lambda: ["hvm"])
    vcpus: int = 0
    memory_mib: int = 0
    gpus: List[GPUInfo] = field(default_factory=list)
    inference_accelerator_count: int = 0
    maximum_network_interfaces: int = 0
    ipv4_addresses_per_interface: int = 0
    bare_metal: bool = False
    fpga: bool = False
    # vpc-resource-controller trunking data (aws/instancetype.go:82-89)
    pod_eni_trunking_compatible: bool = False
    pod_eni_branch_interfaces: int = 0
    # extension for the cost-minimizing solver objective: on-demand $/h
    price_per_hour: float = 0.0


@dataclass
class InstanceTypeOffering:
    instance_type: str = ""
    location: str = ""  # availability zone


@dataclass
class Subnet:
    subnet_id: str = ""
    availability_zone: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SecurityGroup:
    group_id: str = ""
    group_name: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class LaunchTemplate:
    launch_template_name: str = ""
    launch_template_id: str = ""
    user_data: str = ""
    image_id: str = ""
    instance_profile: str = ""
    security_group_ids: List[str] = field(default_factory=list)
    metadata_options: Dict[str, object] = field(default_factory=dict)
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class FleetOverride:
    """ec2.FleetLaunchTemplateOverridesRequest subset (aws/instance.go:185-205)."""

    instance_type: str = ""
    subnet_id: str = ""
    availability_zone: str = ""
    priority: Optional[float] = None


@dataclass
class FleetLaunchTemplateConfig:
    launch_template_name: str = ""
    version: str = "$Default"
    overrides: List[FleetOverride] = field(default_factory=list)


@dataclass
class CreateFleetRequest:
    launch_template_configs: List[FleetLaunchTemplateConfig] = field(default_factory=list)
    total_target_capacity: int = 0
    default_target_capacity_type: str = "on-demand"
    fleet_type: str = "instant"
    allocation_strategy: str = ""
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class CreateFleetError:
    error_code: str = ""
    error_message: str = ""
    # override that failed — zone kept redundantly so ICE errors are
    # attributable without extra lookups (aws/instance.go:196-199)
    instance_type: str = ""
    availability_zone: str = ""


@dataclass
class CreateFleetResponse:
    instance_ids: List[str] = field(default_factory=list)
    errors: List[CreateFleetError] = field(default_factory=list)


@dataclass
class Instance:
    instance_id: str = ""
    instance_type: str = ""
    availability_zone: str = ""
    private_dns_name: str = ""
    image_id: str = ""
    architecture: str = "x86_64"
    spot_instance_request_id: Optional[str] = None
    # garbage-collection fields: the tags CreateFleet stamped at launch
    # (provisioner name + launch nonce), the launch time the grace window
    # is measured against, and the lifecycle state (terminated instances
    # still appear in DescribeInstances for ~an hour and must not read as
    # live capacity)
    tags: Dict[str, str] = field(default_factory=dict)
    launch_time: float = 0.0
    state: str = "running"  # pending | running | shutting-down | terminated


# ---------------------------------------------------------------------------
# Client interfaces
# ---------------------------------------------------------------------------


class EC2API(abc.ABC):
    """The EC2 operations Karpenter performs (ec2iface subset)."""

    @abc.abstractmethod
    def describe_instance_types(self) -> List[InstanceTypeInfo]:
        ...

    @abc.abstractmethod
    def describe_instance_type_offerings(self) -> List[InstanceTypeOffering]:
        ...

    @abc.abstractmethod
    def describe_subnets(self, tag_filters: Dict[str, str]) -> List[Subnet]:
        """``filters[key] == "*"`` means tag-key wildcard (aws/subnets.go:63-76)."""

    @abc.abstractmethod
    def describe_security_groups(self, tag_filters: Dict[str, str]) -> List[SecurityGroup]:
        ...

    @abc.abstractmethod
    def describe_launch_templates(self, names: List[str]) -> List[LaunchTemplate]:
        ...

    @abc.abstractmethod
    def create_launch_template(self, template: LaunchTemplate) -> LaunchTemplate:
        ...

    @abc.abstractmethod
    def create_fleet(self, request: CreateFleetRequest) -> CreateFleetResponse:
        ...

    @abc.abstractmethod
    def describe_instances(self, instance_ids: List[str]) -> List[Instance]:
        ...

    @abc.abstractmethod
    def describe_instances_by_tags(
            self, tag_filters: Dict[str, str]) -> List[Instance]:
        """DescribeInstances with tag filters instead of ids — the
        garbage-collection enumeration path (upstream's ListByTags). Same
        '*'-means-tag-key-wildcard convention as describe_subnets. Paged to
        exhaustion by implementations; includes non-running instances (the
        caller filters by state)."""

    @abc.abstractmethod
    def terminate_instances(self, instance_ids: List[str]) -> None:
        ...


class SSMAPI(abc.ABC):
    @abc.abstractmethod
    def get_parameter(self, name: str) -> str:
        ...


def default_clients(region: Optional[str] = None):
    """Construct the real AWS clients (no SDK dependency): hand-rolled
    SigV4 + IMDSv2 + retryer on stdlib HTTP — see awsclient.py. Region
    resolves env → IMDS exactly like the reference's session
    (aws/cloudprovider.go:68-103)."""
    from karpenter_tpu_torch.cloudprovider.aws import awsclient

    return awsclient.default_clients(region=region)
