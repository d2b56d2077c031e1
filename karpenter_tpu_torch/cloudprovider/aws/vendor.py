"""AWS vendor extension block: the ``spec.provider`` payload.

A copy of the JAX package's module. Reference: pkg/cloudprovider/aws/apis/v1alpha1/{provider.go,provider_defaults.go,
provider_validation.go,tags.go}. The core treats ``Constraints.provider`` as an
opaque dict; this module is the codec + defaulting + validation for the AWS
shape of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import NodeSelectorRequirement

CAPACITY_TYPE_SPOT = wellknown.CAPACITY_TYPE_SPOT
CAPACITY_TYPE_ON_DEMAND = wellknown.CAPACITY_TYPE_ON_DEMAND

# ec2.LaunchTemplateHttpTokensState* / metadata defaults (provider.go:25-32)
DEFAULT_METADATA_OPTIONS = {
    "httpEndpoint": "enabled",
    "httpProtocolIPv6": "disabled",
    "httpPutResponseHopLimit": 2,
    "httpTokens": "required",
}
_METADATA_ENUMS = {
    "httpEndpoint": {"enabled", "disabled"},
    "httpProtocolIPv6": {"enabled", "disabled"},
    "httpTokens": {"optional", "required"},
}

AWS_TO_KUBE_ARCHITECTURES = {
    "x86_64": wellknown.ARCHITECTURE_AMD64,
    "arm64": wellknown.ARCHITECTURE_ARM64,
}


@dataclass
class AWSProvider:
    """The AWS block inside spec.provider (provider.go:42-121)."""

    instance_profile: str = ""
    launch_template: Optional[str] = None
    subnet_selector: Dict[str, str] = field(default_factory=dict)
    security_group_selector: Dict[str, str] = field(default_factory=dict)
    tags: Dict[str, str] = field(default_factory=dict)
    metadata_options: Optional[Dict[str, object]] = None

    # -- codec (provider.go:123-148) ---------------------------------------
    @classmethod
    def deserialize(cls, constraints: Constraints) -> "AWSProvider":
        if constraints.provider is None:
            raise ValueError(
                "invariant violated: spec.provider is not defined. "
                "Is the defaulting webhook installed?")
        p = constraints.provider
        return cls(
            instance_profile=p.get("instanceProfile", ""),
            launch_template=p.get("launchTemplate"),
            subnet_selector=dict(p.get("subnetSelector") or {}),
            security_group_selector=dict(p.get("securityGroupSelector") or {}),
            tags=dict(p.get("tags") or {}),
            metadata_options=p.get("metadataOptions"),
        )

    def serialize(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "instanceProfile": self.instance_profile,
            "subnetSelector": dict(self.subnet_selector),
            "securityGroupSelector": dict(self.security_group_selector),
            "tags": dict(self.tags),
        }
        if self.launch_template is not None:
            out["launchTemplate"] = self.launch_template
        if self.metadata_options is not None:
            out["metadataOptions"] = dict(self.metadata_options)
        return out

    def get_metadata_options(self) -> Dict[str, object]:
        """Effective IMDS options (provider.go:150-160)."""
        if self.metadata_options is None:
            return dict(DEFAULT_METADATA_OPTIONS)
        return dict(self.metadata_options)

    # -- validation (provider_validation.go) --------------------------------
    def validate(self) -> List[str]:
        errs: List[str] = []
        if not self.instance_profile:
            errs.append("provider.instanceProfile: missing field")
        if not self.subnet_selector:
            errs.append("provider.subnetSelector: missing field")
        for key, value in self.subnet_selector.items():
            if key == "" or value == "":
                errs.append(f"provider.subnetSelector[{key!r}]: invalid empty value")
        if not self.security_group_selector:
            errs.append("provider.securityGroupSelector: missing field")
        for key, value in self.security_group_selector.items():
            if key == "" or value == "":
                errs.append(f"provider.securityGroupSelector[{key!r}]: invalid empty value")
        for key in self.tags:
            if key == "":
                errs.append("provider.tags: empty tag keys aren't supported")
        errs.extend(self._validate_metadata_options())
        return errs

    def _validate_metadata_options(self) -> List[str]:
        if self.metadata_options is None:
            return []
        errs = []
        for fld, allowed in _METADATA_ENUMS.items():
            v = self.metadata_options.get(fld)
            if v is not None and v not in allowed:
                errs.append(
                    f"provider.metadataOptions.{fld}: invalid value {v!r} "
                    f"(expected one of {sorted(allowed)})")
        hops = self.metadata_options.get("httpPutResponseHopLimit")
        if hops is not None and not (1 <= int(hops) <= 64):
            errs.append(
                f"provider.metadataOptions.httpPutResponseHopLimit: {hops} "
                "out of bounds [1, 64]")
        return errs


def default_constraints(constraints: Constraints) -> None:
    """Defaulting hook: architecture amd64 + capacity type on-demand unless
    already labeled/required (provider_defaults.go:26-57). Mutates in place,
    matching webhook defaulting semantics."""
    for key, default_value in (
        (wellknown.LABEL_ARCH, wellknown.ARCHITECTURE_AMD64),
        (wellknown.LABEL_CAPACITY_TYPE, CAPACITY_TYPE_ON_DEMAND),
    ):
        if key in constraints.labels:
            continue
        if key in constraints.requirements.keys():
            continue
        constraints.requirements = constraints.requirements.add(
            NodeSelectorRequirement(key=key, operator="In", values=[default_value]))


def merge_tags(provisioner_name: str, *custom: Dict[str, str]) -> Dict[str, str]:
    """Union custom tags with the discovery tags Karpenter always applies
    (tags.go:28-37); later maps win, Karpenter's own keys last."""
    merged: Dict[str, str] = {}
    for m in custom:
        merged.update(m or {})
    merged[wellknown.PROVISIONER_NAME_LABEL] = provisioner_name
    merged["Name"] = f"{wellknown.PROVISIONER_NAME_LABEL}/{provisioner_name}"
    return merged
