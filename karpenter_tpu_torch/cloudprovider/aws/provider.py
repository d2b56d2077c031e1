"""The AWS CloudProvider: SPI implementation wiring the sub-providers.

A copy of the JAX package's module (reference:
pkg/cloudprovider/aws/cloudprovider.go). Construction takes the EC2/SSM
seam (sdk.EC2API/sdk.SSMAPI), so tests keep the real provider logic and
fake only the AWS surface, as the reference suite does. Importing it
registers "aws" in the SPI registry and the EBS CSI zone alias in
``wellknown.NORMALIZED_LABELS``.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Node
from karpenter_tpu_torch.cloudprovider import spi
from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.cloudprovider.aws.discovery import (
    AMIProvider,
    SecurityGroupProvider,
    SubnetProvider,
)
from karpenter_tpu_torch.cloudprovider.aws.instance import InstanceProvider
from karpenter_tpu_torch.cloudprovider.aws.instancetypes import InstanceTypeProvider
from karpenter_tpu_torch.cloudprovider.aws.launchtemplate import LaunchTemplateProvider
from karpenter_tpu_torch.cloudprovider.aws.vendor import AWSProvider, default_constraints
from karpenter_tpu_torch.cloudprovider.spi import BindCallback, CloudProvider, InstanceType

log = logging.getLogger("karpenter.aws")

# EC2 CreateFleet budget (cloudprovider.go:41-46) — enforced by the caller's
# workqueue in the reference; recorded here for the control plane's limiter.
CREATE_FLEET_QPS = 2
CREATE_FLEET_BURST = 100

# The EBS CSI zone label aliases the standard zone label
# (cloudprovider.go:58-60); registered at import so Requirements.normalize
# folds it in.
wellknown.NORMALIZED_LABELS.setdefault(
    "topology.ebs.csi.aws.com/zone", wellknown.LABEL_TOPOLOGY_ZONE)


class AWSCloudProvider(CloudProvider):
    def __init__(
        self,
        ec2api: sdk.EC2API,
        ssmapi: sdk.SSMAPI,
        cluster_name: str,
        cluster_endpoint: str,
        kube_version: Callable[[], str] = lambda: "1.21",
        ca_bundle: Optional[Callable[[], Optional[str]]] = None,
        eni_limited_pod_density: bool = True,
        node_name_convention: str = "ip-name",
        describe_retry_delay: float = 1.0,
    ):
        self.subnet_provider = SubnetProvider(ec2api)
        self.instance_type_provider = InstanceTypeProvider(
            ec2api, self.subnet_provider,
            eni_limited_pod_density=eni_limited_pod_density)
        self.launch_template_provider = LaunchTemplateProvider(
            ec2api,
            AMIProvider(ssmapi, kube_version),
            SecurityGroupProvider(ec2api),
            cluster_name=cluster_name,
            cluster_endpoint=cluster_endpoint,
            ca_bundle=ca_bundle,
            eni_limited_pod_density=eni_limited_pod_density,
        )
        self.instance_provider = InstanceProvider(
            ec2api,
            self.instance_type_provider,
            self.subnet_provider,
            self.launch_template_provider,
            cluster_name=cluster_name,
            node_name_convention=node_name_convention,
            describe_retry_delay=describe_retry_delay,
        )

    # -- SPI (cloudprovider.go:113-152) -------------------------------------
    def create(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        quantity: int,
        bind: BindCallback,
    ) -> List[Optional[str]]:
        provider = AWSProvider.deserialize(constraints)
        provisioner_name = constraints.labels.get(
            wellknown.PROVISIONER_NAME_LABEL, "default")
        try:
            nodes = self.instance_provider.create(
                constraints, provider, instance_types, quantity,
                provisioner_name=provisioner_name)
        except Exception as e:  # noqa: BLE001 — surfaced per SPI contract
            return [f"launching instances, {e}"] * quantity
        errs = [bind(node) for node in nodes]
        # partial fulfillment: unlaunched capacity reported as errors
        errs.extend(["instance not launched"] * (quantity - len(nodes)))
        return errs

    def delete(self, node: Node) -> Optional[str]:
        try:
            self.instance_provider.terminate(node)
        except Exception as e:  # noqa: BLE001
            return f"terminating instance {node.metadata.name}, {e}"
        return None

    def list_instances(self) -> List[spi.CapacityRecord]:
        """Provider-side capacity enumeration for the GC controller:
        DescribeInstances by the cluster ownership tag, converted to
        CapacityRecords carrying the attribution tags stamped at launch."""
        records = []
        for inst in self.instance_provider.list_cluster_instances():
            records.append(spi.CapacityRecord(
                instance_id=inst.instance_id,
                provisioner_name=inst.tags.get(
                    wellknown.PROVISIONER_NAME_LABEL, ""),
                launch_nonce=inst.tags.get(wellknown.LAUNCH_NONCE_TAG, ""),
                created_unix=inst.launch_time,
                zone=inst.availability_zone,
                instance_type=inst.instance_type,
            ))
        return records

    def delete_instance(self, instance_id: str) -> Optional[str]:
        try:
            self.instance_provider.terminate_by_id(instance_id)
        except Exception as e:  # noqa: BLE001
            return f"terminating instance {instance_id}, {e}"
        return None

    def get_instance_types(self, constraints: Constraints) -> List[InstanceType]:
        """Full viable catalog; Requirements filtering happens in the solver's
        feasibility mask, not here (cloudprovider.go:133-140)."""
        provider = AWSProvider.deserialize(constraints)
        return self.instance_type_provider.get(provider)

    def default(self, constraints: Constraints) -> None:
        """Webhook defaulting hook (cloudprovider.go:154-161): arch amd64 +
        capacity-type on-demand, plus an empty provider block if missing so
        deserialize() holds its invariant."""
        if constraints.provider is None:
            constraints.provider = {}
        default_constraints(constraints)

    def validate(self, constraints: Constraints) -> Optional[str]:
        try:
            provider = AWSProvider.deserialize(constraints)
        except ValueError as e:
            return str(e)
        errs = provider.validate()
        return "; ".join(errs) if errs else None

    def name(self) -> str:
        return "aws"


spi.register("aws", AWSCloudProvider)
