"""Admission plane: Provisioner defaulting and validation.

A copy of the JAX package's module. Reference:
pkg/apis/provisioning/v1alpha5/{provisioner_validation.go,
provisioner_defaults.go} and cmd/webhook/main.go. The reference runs these
as knative admission webhooks in a second binary; here they are plain
functions that the webhook server (webhooks/server.py) exposes. Cloud
providers hook in through spi.CloudProvider.default/validate.
"""

from __future__ import annotations

import re
from typing import List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider.spi import CloudProvider

SUPPORTED_NODE_SELECTOR_OPS = ("In", "NotIn")
SUPPORTED_TAINT_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute", "")

_QUALIFIED_NAME_RE = re.compile(
    r"^([A-Za-z0-9][-A-Za-z0-9_.]{0,251}[A-Za-z0-9]/)?"
    r"[A-Za-z0-9]([-A-Za-z0-9_.]{0,61}[A-Za-z0-9])?$")
_LABEL_VALUE_RE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]{0,61}[A-Za-z0-9])?)?$")


def is_qualified_name(name: str) -> bool:
    return bool(_QUALIFIED_NAME_RE.match(name))


def is_valid_label_value(value: str) -> bool:
    return bool(_LABEL_VALUE_RE.match(value))


def is_restricted_label_domain(key: str) -> bool:
    """provisioner_validation.go IsRestrictedLabelDomain."""
    domain = key.split("/", 1)[0] if "/" in key else ""
    if domain in wellknown.ALLOWED_LABEL_DOMAINS:
        return False
    return any(domain.endswith(restricted)
               for restricted in wellknown.RESTRICTED_LABEL_DOMAINS)


def default_provisioner(provisioner: Provisioner,
                        cloud_provider: Optional[CloudProvider] = None) -> None:
    """SetDefaults: delegate to the provider hook (provisioner_defaults.go)."""
    if cloud_provider is not None:
        cloud_provider.default(provisioner.spec.constraints)


def validate_provisioner(provisioner: Provisioner,
                         cloud_provider: Optional[CloudProvider] = None) -> List[str]:
    """Validate: metadata + spec + constraints + provider hook
    (provisioner_validation.go:33-140). Returns a list of errors."""
    errs: List[str] = []
    if not provisioner.metadata.name:
        errs.append("metadata.name: required")
    spec = provisioner.spec
    if spec.ttl_seconds_until_expired is not None and spec.ttl_seconds_until_expired < 0:
        errs.append("spec.ttlSecondsUntilExpired: cannot be negative")
    if spec.ttl_seconds_after_empty is not None and spec.ttl_seconds_after_empty < 0:
        errs.append("spec.ttlSecondsAfterEmpty: cannot be negative")
    errs.extend(validate_constraints(spec.constraints))
    if cloud_provider is not None:
        err = cloud_provider.validate(spec.constraints)
        if err is not None:
            errs.append(err)
    return errs


def validate_constraints(c: Constraints) -> List[str]:
    errs: List[str] = []
    # labels (validateLabels)
    for key, value in c.labels.items():
        if not is_qualified_name(key):
            errs.append(f"labels[{key}]: invalid key name")
        if not is_valid_label_value(value):
            errs.append(f"labels[{key}]: invalid value {value!r}")
        if key in wellknown.RESTRICTED_LABELS:
            errs.append(f"labels[{key}]: label is restricted")
        if key not in wellknown.WELL_KNOWN_LABELS and is_restricted_label_domain(key):
            errs.append(f"labels[{key}]: label domain not allowed")
    # taints (validateTaints)
    for i, taint in enumerate(c.taints):
        if not taint.key:
            errs.append(f"taints[{i}]: key required")
        elif not is_qualified_name(taint.key):
            errs.append(f"taints[{i}]: invalid key")
        if taint.value and not is_qualified_name(taint.value):
            errs.append(f"taints[{i}]: invalid value")
        if taint.effect not in SUPPORTED_TAINT_EFFECTS:
            errs.append(f"taints[{i}]: invalid effect {taint.effect}")
    # requirements (validateRequirements)
    for i, r in enumerate(c.requirements.items):
        if r.key in wellknown.RESTRICTED_LABELS:
            errs.append(f"requirements[{i}]: {r.key} is restricted")
        if r.operator not in SUPPORTED_NODE_SELECTOR_OPS:
            errs.append(
                f"requirements[{i}]: operator {r.operator} not in "
                f"{SUPPORTED_NODE_SELECTOR_OPS}")
    return errs
