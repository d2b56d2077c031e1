"""The Provisioner custom resource.

Reference: pkg/apis/provisioning/v1alpha5/{provisioner.go,provisioner_status.go}.
A copy of the JAX package's module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_tpu_torch.api.constraints import Constraints, Limits
from karpenter_tpu_torch.api.core import ObjectMeta
from karpenter_tpu_torch.utils.resources import ResourceList


@dataclass
class ProvisionerSpec:
    constraints: Constraints = field(default_factory=Constraints)
    # Seconds after a node is empty (only daemonset/static pods) before it is
    # deleted; None disables emptiness deprovisioning (provisioner.go:36-41).
    ttl_seconds_after_empty: Optional[int] = None
    # Seconds after creation before a node is expired and recycled; None
    # disables expiry (provisioner.go:43-50).
    ttl_seconds_until_expired: Optional[int] = None
    limits: Limits = field(default_factory=Limits)
    # Actively drain under-utilized nodes whose pods fit elsewhere
    # (controllers/consolidation.py). Off by default: it evicts running pods.
    consolidation_enabled: bool = False


@dataclass
class Condition:
    """Status condition (provisioner_status.go:25-36)."""

    type: str = ""
    status: str = "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: Optional[float] = None


def set_condition(conditions: List[Condition], type: str, status: str,
                  reason: str = "", message: str = "",
                  now: Optional[float] = None) -> bool:
    """Upsert a condition in place; returns True when anything (other than
    the transition timestamp) changed — callers skip the status write when
    nothing did, so a condition refresh can't create a watch-event loop."""
    for c in conditions:
        if c.type == type:
            if (c.status, c.reason, c.message) == (status, reason, message):
                return False
            if c.status != status:
                c.last_transition_time = now
            c.status, c.reason, c.message = status, reason, message
            return True
    conditions.append(Condition(type=type, status=status, reason=reason,
                                message=message, last_transition_time=now))
    return True


def get_condition(conditions: List[Condition], type: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == type:
            return c
    return None


@dataclass
class ProvisionerStatus:
    last_scale_time: Optional[float] = None
    conditions: List[Condition] = field(default_factory=list)
    # Aggregated capacity of this provisioner's nodes, consumed by the
    # limits check before each launch.
    resources: ResourceList = field(default_factory=dict)


@dataclass
class Provisioner:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ProvisionerSpec = field(default_factory=ProvisionerSpec)
    status: ProvisionerStatus = field(default_factory=ProvisionerStatus)
    kind: str = "Provisioner"
