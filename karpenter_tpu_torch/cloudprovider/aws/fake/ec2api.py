"""Programmable fake EC2 API.

A copy of the JAX package's fake (reference:
pkg/cloudprovider/aws/fake/ec2api.go): canned Describe outputs,
call-capture lists, InsufficientCapacityPools to simulate ICE on CreateFleet,
and Reset() between tests. The AWS provider suite keeps the real provider
code and fakes only this surface.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.utils import clock

_counter = itertools.count(1)


@dataclass(frozen=True)
class CapacityPool:
    """An (instance type, zone, capacity type) pool to fail with ICE
    (ec2api.go:54, CapacityPool)."""

    instance_type: str
    zone: str
    capacity_type: str


def default_instance_type_infos() -> List[sdk.InstanceTypeInfo]:
    """Hardcoded catalog mirroring the reference fake's families
    (ec2api.go:214-388): burstable/standard/GPU/ARM/inferentia, plus a
    bare-metal and an FPGA type that the provider filter must drop."""
    return [
        sdk.InstanceTypeInfo(
            instance_type="t3.large", vcpus=2, memory_mib=8 * 1024,
            maximum_network_interfaces=3, ipv4_addresses_per_interface=12,
            price_per_hour=0.0832),
        sdk.InstanceTypeInfo(
            instance_type="m5.large", vcpus=2, memory_mib=8 * 1024,
            maximum_network_interfaces=3, ipv4_addresses_per_interface=30,
            pod_eni_trunking_compatible=True, pod_eni_branch_interfaces=9,
            price_per_hour=0.096),
        sdk.InstanceTypeInfo(
            instance_type="m5.xlarge", vcpus=4, memory_mib=16 * 1024,
            maximum_network_interfaces=4, ipv4_addresses_per_interface=60,
            pod_eni_trunking_compatible=True, pod_eni_branch_interfaces=18,
            price_per_hour=0.192),
        sdk.InstanceTypeInfo(
            instance_type="p3.8xlarge", vcpus=32, memory_mib=249856,
            gpus=[sdk.GPUInfo(manufacturer="NVIDIA", count=4)],
            maximum_network_interfaces=4, ipv4_addresses_per_interface=60,
            price_per_hour=12.24),
        sdk.InstanceTypeInfo(
            instance_type="c6g.large", vcpus=2, memory_mib=2 * 1024,
            supported_architectures=["arm64"],
            maximum_network_interfaces=4, ipv4_addresses_per_interface=60,
            price_per_hour=0.068),
        sdk.InstanceTypeInfo(
            instance_type="inf1.2xlarge", vcpus=8, memory_mib=16384,
            inference_accelerator_count=1,
            maximum_network_interfaces=4, ipv4_addresses_per_interface=60,
            price_per_hour=0.362),
        sdk.InstanceTypeInfo(
            instance_type="inf1.6xlarge", vcpus=24, memory_mib=49152,
            inference_accelerator_count=4,
            maximum_network_interfaces=8, ipv4_addresses_per_interface=30,
            price_per_hour=1.18),
        # dropped by the filter:
        sdk.InstanceTypeInfo(
            instance_type="m5.metal", vcpus=96, memory_mib=384 * 1024,
            bare_metal=True,
            maximum_network_interfaces=15, ipv4_addresses_per_interface=50),
        sdk.InstanceTypeInfo(
            instance_type="f1.2xlarge", vcpus=8, memory_mib=122 * 1024,
            fpga=True,
            maximum_network_interfaces=4, ipv4_addresses_per_interface=15),
        sdk.InstanceTypeInfo(  # non-allowlisted family
            instance_type="x1.16xlarge", vcpus=64, memory_mib=999424,
            maximum_network_interfaces=8, ipv4_addresses_per_interface=30),
    ]


DEFAULT_ZONES = ["test-zone-1a", "test-zone-1b", "test-zone-1c"]


def default_subnets() -> List[sdk.Subnet]:
    return [
        sdk.Subnet(subnet_id="test-subnet-1", availability_zone="test-zone-1a",
                   tags={"Name": "test-subnet-1"}),
        sdk.Subnet(subnet_id="test-subnet-2", availability_zone="test-zone-1b",
                   tags={"Name": "test-subnet-2"}),
        sdk.Subnet(subnet_id="test-subnet-3", availability_zone="test-zone-1c",
                   tags={"Name": "test-subnet-3", "TestTag": ""}),
    ]


def default_security_groups() -> List[sdk.SecurityGroup]:
    return [
        sdk.SecurityGroup(group_id="test-security-group-1", tags={"Name": "test-security-group-1"}),
        sdk.SecurityGroup(group_id="test-security-group-2", tags={"Name": "test-security-group-2"}),
        sdk.SecurityGroup(group_id="test-security-group-3",
                          tags={"Name": "test-security-group-3", "TestTag": ""}),
    ]


@dataclass
class EC2Behavior:
    """Canned outputs; None falls through to defaults (ec2api.go:42-56)."""

    describe_instance_types_output: Optional[List[sdk.InstanceTypeInfo]] = None
    describe_instance_type_offerings_output: Optional[List[sdk.InstanceTypeOffering]] = None
    describe_subnets_output: Optional[List[sdk.Subnet]] = None
    describe_security_groups_output: Optional[List[sdk.SecurityGroup]] = None
    describe_instances_output: Optional[List[sdk.Instance]] = None
    insufficient_capacity_pools: List[CapacityPool] = field(default_factory=list)
    create_fleet_error: Optional[Exception] = None


class FakeEC2API(sdk.EC2API):
    def __init__(self, behavior: Optional[EC2Behavior] = None):
        self.behavior = behavior or EC2Behavior()
        self.calls: Dict[str, List[object]] = {}
        self._launch_templates: Dict[str, sdk.LaunchTemplate] = {}
        self._instances: Dict[str, sdk.Instance] = {}
        self.terminated: List[str] = []

    def reset(self) -> None:
        """Clear state between tests (ec2api.go:67-75)."""
        self.behavior = EC2Behavior()
        self.calls.clear()
        self._launch_templates.clear()
        self._instances.clear()
        self.terminated.clear()

    def _record(self, method: str, payload) -> None:
        self.calls.setdefault(method, []).append(payload)

    # -- describes -----------------------------------------------------------
    def describe_instance_types(self) -> List[sdk.InstanceTypeInfo]:
        self._record("describe_instance_types", None)
        if self.behavior.describe_instance_types_output is not None:
            return list(self.behavior.describe_instance_types_output)
        return default_instance_type_infos()

    def describe_instance_type_offerings(self) -> List[sdk.InstanceTypeOffering]:
        self._record("describe_instance_type_offerings", None)
        if self.behavior.describe_instance_type_offerings_output is not None:
            return list(self.behavior.describe_instance_type_offerings_output)
        infos = (self.behavior.describe_instance_types_output
                 if self.behavior.describe_instance_types_output is not None
                 else default_instance_type_infos())
        return [
            sdk.InstanceTypeOffering(instance_type=info.instance_type, location=zone)
            for info in infos
            for zone in DEFAULT_ZONES
        ]

    def describe_subnets(self, tag_filters: Dict[str, str]) -> List[sdk.Subnet]:
        self._record("describe_subnets", dict(tag_filters))
        subnets = (self.behavior.describe_subnets_output
                   if self.behavior.describe_subnets_output is not None
                   else default_subnets())
        return [s for s in subnets if _matches(s.tags, tag_filters)]

    def describe_security_groups(self, tag_filters: Dict[str, str]) -> List[sdk.SecurityGroup]:
        self._record("describe_security_groups", dict(tag_filters))
        groups = (self.behavior.describe_security_groups_output
                  if self.behavior.describe_security_groups_output is not None
                  else default_security_groups())
        return [g for g in groups if _matches(g.tags, tag_filters)]

    # -- launch templates ----------------------------------------------------
    def describe_launch_templates(self, names: List[str]) -> List[sdk.LaunchTemplate]:
        self._record("describe_launch_templates", list(names))
        return [self._launch_templates[n] for n in names if n in self._launch_templates]

    def create_launch_template(self, template: sdk.LaunchTemplate) -> sdk.LaunchTemplate:
        self._record("create_launch_template", template)
        template.launch_template_id = f"lt-{next(_counter):08d}"
        self._launch_templates[template.launch_template_name] = template
        return template

    # -- fleet (ec2api.go:77-137) -------------------------------------------
    def create_fleet(self, request: sdk.CreateFleetRequest) -> sdk.CreateFleetResponse:
        self._record("create_fleet", request)
        if self.behavior.create_fleet_error is not None:
            raise self.behavior.create_fleet_error
        if not request.launch_template_configs:
            raise sdk.EC2Error("MissingParameter", "missing launch template configs")
        for config in request.launch_template_configs:
            if not config.launch_template_name:
                raise sdk.EC2Error("MissingParameter", "missing launch template name")

        capacity_type = request.default_target_capacity_type
        response = sdk.CreateFleetResponse()
        iced: set = set()
        # fulfill each unit of capacity from the first non-ICE'd override,
        # honoring spot priority when present
        overrides = [
            o for config in request.launch_template_configs
            for o in sorted(config.overrides,
                            key=lambda o: o.priority if o.priority is not None else 0.0)
        ]
        for _ in range(request.total_target_capacity):
            launched = False
            for override in overrides:
                pool = CapacityPool(
                    override.instance_type, override.availability_zone, capacity_type)
                if pool in self.behavior.insufficient_capacity_pools:
                    iced.add(pool)
                    continue
                instance = sdk.Instance(
                    instance_id=f"i-{next(_counter):016x}",
                    instance_type=override.instance_type,
                    availability_zone=override.availability_zone,
                    private_dns_name=f"ip-192-168-1-{next(_counter)}.ec2.internal",
                    spot_instance_request_id=(
                        f"sir-{next(_counter):06d}"
                        if capacity_type == "spot" else None),
                    # fleet TagSpecifications land on the instances (real
                    # CreateFleet semantics) — the GC enumeration keys off
                    # these; launch time reads the injectable clock so
                    # grace-window tests can time-travel
                    tags=dict(request.tags),
                    launch_time=clock.now(),
                )
                self._instances[instance.instance_id] = instance
                response.instance_ids.append(instance.instance_id)
                launched = True
                break
            if not launched:
                break
        for pool in sorted(iced, key=lambda p: (p.instance_type, p.zone)):
            response.errors.append(sdk.CreateFleetError(
                error_code=sdk.INSUFFICIENT_CAPACITY_ERROR_CODE,
                error_message="there is no capacity available",
                instance_type=pool.instance_type,
                availability_zone=pool.zone,
            ))
        return response

    # -- instances -----------------------------------------------------------
    def describe_instances(self, instance_ids: List[str]) -> List[sdk.Instance]:
        self._record("describe_instances", list(instance_ids))
        if self.behavior.describe_instances_output is not None:
            return list(self.behavior.describe_instances_output)
        return [self._instances[i] for i in instance_ids if i in self._instances]

    def describe_instances_by_tags(
            self, tag_filters: Dict[str, str]) -> List[sdk.Instance]:
        self._record("describe_instances_by_tags", dict(tag_filters))
        return [i for i in self._instances.values()
                if _matches(i.tags, tag_filters)]

    def terminate_instances(self, instance_ids: List[str]) -> None:
        self._record("terminate_instances", list(instance_ids))
        for instance_id in instance_ids:
            if instance_id not in self._instances:
                raise sdk.EC2Error(
                    "InvalidInstanceID.NotFound", f"{instance_id} does not exist")
            del self._instances[instance_id]
            self.terminated.append(instance_id)


def _matches(tags: Dict[str, str], tag_filters: Dict[str, str]) -> bool:
    """Tag selector semantics: "*" (and the ""→wildcard convention from
    subnets.go:63-67) match on key presence; otherwise exact value."""
    for key, value in tag_filters.items():
        if key not in tags:
            return False
        if value not in ("*", "") and tags[key] != value:
            return False
    return True
