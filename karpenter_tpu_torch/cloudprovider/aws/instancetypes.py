"""Instance-type catalog provider: discovery, caching, offering synthesis.

A copy of the JAX package's module (reference:
pkg/cloudprovider/aws/instancetypes.go). The catalog it produces is the
static side of the solver's input: adapt()-ed types feed the capacity and
price tensors of solver/adapter.py, so this provider is the boundary where
eventually-consistent cloud state becomes the pack kernel's type axis.
Interning is load-bearing: the versioned catalog encoding
(ops/encode._catalog_encoding), build_packables_versioned and the
DeviceRing's token reuse all key on the identity of these objects.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Set

from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.cloudprovider.aws.discovery import SubnetProvider
from karpenter_tpu_torch.cloudprovider.aws.instancetype import adapt
from karpenter_tpu_torch.cloudprovider.aws.vendor import AWSProvider
from karpenter_tpu_torch.cloudprovider.spi import InstanceType, Offering
from karpenter_tpu_torch.utils.cache import TTLCache

log = logging.getLogger("karpenter.aws.instancetypes")

INSTANCE_TYPES_AND_ZONES_CACHE_TTL = 5 * 60.0  # instancetypes.go:38
INSUFFICIENT_CAPACITY_ERROR_CACHE_TTL = 45.0   # instancetypes.go:39

# Prefix allowlist of useful-for-Kubernetes families (instancetypes.go:163-172)
_FAMILY_PREFIXES = (
    "m", "c", "r", "a",  # standard
    "i3",                # storage-optimized
    "t3", "t4",          # burstable
    "p", "inf", "g",     # accelerators
)


def _unavailable_key(capacity_type: str, instance_type: str, zone: str) -> str:
    """<capacityType>:<instanceType>:<zone> (instancetypes.go:198-200)."""
    return f"{capacity_type}:{instance_type}:{zone}"


class InstanceTypeProvider:
    """Catalog + offerings with the 5-min discovery cache and the 45-s
    insufficient-capacity avoidance cache (instancetypes.go:43-60)."""

    def __init__(self, ec2api: sdk.EC2API, subnet_provider: SubnetProvider,
                 eni_limited_pod_density: bool = True):
        self.ec2api = ec2api
        self.subnet_provider = subnet_provider
        self.eni_limited_pod_density = eni_limited_pod_density
        # values cached BEFORE subtracting unavailable offerings, so ICE
        # expiry restores an offering without re-discovery
        self._cache = TTLCache(INSTANCE_TYPES_AND_ZONES_CACHE_TTL)
        self._unavailable = TTLCache(INSUFFICIENT_CAPACITY_ERROR_CACHE_TTL)
        # Interned adapted objects: the same (discovery generation, name,
        # offerings) must yield the SAME InstanceType object call over call,
        # so the solver's identity-keyed packables memo (solver/adapter.py)
        # hits between catalog refreshes. An ICE poisoning or discovery
        # refresh changes the key → fresh object → the memo recomputes,
        # never stale.
        self._interned: Dict[tuple, InstanceType] = {}
        self._types_generation = 0

    def get(self, provider: AWSProvider) -> List[InstanceType]:
        """All viable instance types for the provider's subnets
        (instancetypes.go:63-95). Requirements are NOT applied here — the
        solver's feasibility mask handles them."""
        infos = self._get_instance_types()
        subnet_zones = {s.availability_zone for s in self.subnet_provider.get(provider)}
        type_zones = self._get_instance_type_zones()
        result = []
        interned: Dict[tuple, InstanceType] = {}
        max_pods = None if self.eni_limited_pod_density else 110
        for info in infos.values():
            offerings = self._create_offerings(
                info, subnet_zones, type_zones.get(info.instance_type, set()))
            if not offerings:
                continue
            key = (self._types_generation, info.instance_type,
                   tuple(offerings), max_pods)
            it = self._interned.get(key)
            if it is None:
                it = adapt(info, offerings, max_pods=max_pods)
            interned[key] = it
            result.append(it)
        # keep only live keys: expired infos/offering sets age out with them
        self._interned = interned
        return result

    def _create_offerings(self, info: sdk.InstanceTypeInfo, subnet_zones: Set[str],
                          available_zones: Set[str]) -> List[Offering]:
        """zones ∩ subnets × usage classes, minus recently-ICE'd offerings
        (instancetypes.go:97-109)."""
        offerings = []
        for zone in sorted(subnet_zones & available_zones):
            for capacity_type in sorted(set(info.supported_usage_classes)):
                if self._unavailable.get(
                        _unavailable_key(capacity_type, info.instance_type, zone)) is None:
                    offerings.append(Offering(capacity_type=capacity_type, zone=zone))
        return offerings

    def _get_instance_type_zones(self) -> Dict[str, Set[str]]:
        cached = self._cache.get("zones")
        if cached is not None:
            return cached
        zones: Dict[str, Set[str]] = {}
        for offering in self.ec2api.describe_instance_type_offerings():
            zones.setdefault(offering.instance_type, set()).add(offering.location)
        log.debug("Discovered EC2 instance types zonal offerings")
        self._cache.set("zones", zones)
        return zones

    def _get_instance_types(self) -> Dict[str, sdk.InstanceTypeInfo]:
        cached = self._cache.get("types")
        if cached is not None:
            return cached
        types = {
            info.instance_type: info
            for info in self.ec2api.describe_instance_types()
            if self._filter(info)
        }
        log.debug("Discovered %d EC2 instance types", len(types))
        self._cache.set("types", types)
        self._types_generation += 1  # fresh infos → fresh interned objects
        return types

    @staticmethod
    def _filter(info: sdk.InstanceTypeInfo) -> bool:
        """HVM, non-FPGA, non-metal, allowlisted family
        (instancetypes.go:139-176)."""
        if info.fpga or info.bare_metal:
            return False
        if "hvm" not in info.supported_virtualization_types:
            return False
        return info.instance_type.startswith(_FAMILY_PREFIXES)

    def cache_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> None:
        """Poison an offering for 45 s after an insufficient-capacity error;
        repeat errors extend the window (instancetypes.go:180-196)."""
        log.debug(
            "%s for offering { instanceType: %s, zone: %s, capacityType: %s }, "
            "avoiding for %ss", sdk.INSUFFICIENT_CAPACITY_ERROR_CODE,
            instance_type, zone, capacity_type, INSUFFICIENT_CAPACITY_ERROR_CACHE_TTL)
        self._unavailable.set(
            _unavailable_key(capacity_type, instance_type, zone), True)
