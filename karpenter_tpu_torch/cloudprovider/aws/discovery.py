"""Tag-selector discovery providers: subnets, security groups, AMIs.

A copy of the JAX package's module.
Reference: pkg/cloudprovider/aws/{subnets.go,securitygroups.go,ami.go}. All
three follow the same shape — selector → cached Describe/GetParameter — so
they live in one module here.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.cloudprovider.aws.vendor import AWSProvider
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.utils.cache import TTLCache

log = logging.getLogger("karpenter.aws.discovery")

CACHE_TTL = 60.0  # aws/cloudprovider.go:47-55


def _selector_key(selector: Dict[str, str]) -> str:
    return "|".join(f"{k}={v}" for k, v in sorted(selector.items()))


class SubnetProvider:
    """Subnets by tag selector, 60-s cached (subnets.go:37-76)."""

    def __init__(self, ec2api: sdk.EC2API):
        self.ec2api = ec2api
        self._cache = TTLCache(CACHE_TTL)

    def get(self, provider: AWSProvider) -> List[sdk.Subnet]:
        key = _selector_key(provider.subnet_selector)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        subnets = self.ec2api.describe_subnets(provider.subnet_selector)
        if not subnets:
            raise ValueError(
                f"no subnets matched selector {provider.subnet_selector}")
        self._cache.set(key, subnets)
        log.debug("Discovered subnets: %s",
                  [f"{s.subnet_id} ({s.availability_zone})" for s in subnets])
        return subnets


class SecurityGroupProvider:
    """Security group IDs by tag selector, 60-s cached
    (securitygroups.go:40-76)."""

    def __init__(self, ec2api: sdk.EC2API):
        self.ec2api = ec2api
        self._cache = TTLCache(CACHE_TTL)

    def get(self, provider: AWSProvider) -> List[str]:
        key = _selector_key(provider.security_group_selector)
        cached = self._cache.get(key)
        if cached is None:
            cached = self.ec2api.describe_security_groups(
                provider.security_group_selector)
            self._cache.set(key, cached)
            log.debug("Discovered security groups: %s",
                      [g.group_id for g in cached])
        if not cached:
            raise ValueError("no security groups exist given constraints")
        return [g.group_id for g in cached]


class AMIProvider:
    """EKS-optimized AMI lookup via SSM, keyed by instance-type class
    (ami.go:40-106).

    ``kube_version`` is a callable so the kube discovery round-trip stays
    behind the same cache as the reference's clientSet.Discovery() call.
    """

    def __init__(self, ssm: sdk.SSMAPI, kube_version: Callable[[], str]):
        self.ssm = ssm
        self.kube_version = kube_version
        self._cache = TTLCache(CACHE_TTL)

    def get(self, instance_types: List[InstanceType]) -> Dict[str, List[InstanceType]]:
        """AMI id → instance types sharing it (ami.go:48-70)."""
        version = self._kube_server_version()
        queries: Dict[str, List[InstanceType]] = {}
        for it in instance_types:
            queries.setdefault(self._ssm_query(it, version), []).append(it)
        ami_ids: Dict[str, List[InstanceType]] = {}
        for query, its in queries.items():
            ami_ids.setdefault(self._ami_id(query), []).extend(its)
        return ami_ids

    def _ami_id(self, query: str) -> str:
        cached = self._cache.get(query)
        if cached is not None:
            return cached
        ami = self.ssm.get_parameter(query)
        self._cache.set(query, ami)
        log.debug("Discovered ami %s for query %s", ami, query)
        return ami

    @staticmethod
    def _ssm_query(instance_type: InstanceType, version: str) -> str:
        """GPU/Neuron → -gpu image; arm64 → -arm64 image (ami.go:87-95)."""
        suffix = ""
        if not instance_type.nvidia_gpus.is_zero() or not instance_type.aws_neurons.is_zero():
            suffix = "-gpu"
        elif instance_type.architecture == wellknown.ARCHITECTURE_ARM64:
            suffix = "-arm64"
        return (f"/aws/service/eks/optimized-ami/{version}/"
                f"amazon-linux-2{suffix}/recommended/image_id")

    def _kube_server_version(self) -> str:
        cached = self._cache.get("kubernetesVersion")
        if cached is not None:
            return cached
        version = self.kube_version().rstrip("+")
        self._cache.set("kubernetesVersion", version)
        log.debug("Discovered kubernetes version %s", version)
        return version
