"""Constraints, Taints and Limits — the Provisioner's scheduling algebra.

Reference: pkg/apis/provisioning/v1alpha5/{constraints.go,taints.go,limits.go}.
A trimmed copy of the JAX package's module: the solver reads the
requirements (the viability validators); the scheduler and the selection
controller validate and tighten pods against them; the provisioning
controller checks the limits before a launch; the Provisioner codec
(api/codec.py) and the admission webhook carry the kubelet configuration
and the provider block.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.api.requirements import IN, NOT_IN, Requirements, pod_requirements
from karpenter_tpu_torch.utils.resources import ResourceList


class Taints(list):
    """Decorated list of Taint (taints.go:24-78)."""

    def tolerates(self, pod: Pod) -> List[str]:
        """Errors for every taint the pod does not tolerate (taints.go:66-78).
        Empty list means tolerated."""
        errs = []
        for taint in self:
            if not any(t.tolerates_taint(taint) for t in pod.spec.tolerations):
                errs.append(f"did not tolerate {taint.key}={taint.value}:{taint.effect}")
        return errs


@dataclass
class Limits:
    """Resource ceilings per Provisioner (limits.go:23-41)."""

    resources: Optional[ResourceList] = None

    def exceeded_by(self, usage: ResourceList) -> Optional[str]:
        if not self.resources:
            return None
        for name, used in usage.items():
            limit = self.resources.get(name)
            if limit is not None and used.cmp(limit) >= 0:
                return f"{name} resource usage of {used} exceeds limit of {limit}"
        return None


@dataclass
class KubeletConfiguration:
    cluster_dns: List[str] = field(default_factory=list)


@dataclass
class Constraints:
    """Node constraints applied by a Provisioner (constraints.go:24-43)."""

    labels: Dict[str, str] = field(default_factory=dict)
    taints: Taints = field(default_factory=Taints)
    requirements: Requirements = field(default_factory=Requirements)
    kubelet_configuration: KubeletConfiguration = field(default_factory=KubeletConfiguration)
    # the cloud provider's block (spec.provider), opaque to the core
    provider: Optional[Dict[str, Any]] = None

    def validate_pod(self, pod: Pod) -> Optional[str]:
        """Error if pod requirements are unmet (constraints.go:46-66)."""
        errs = self.taints.tolerates(pod)
        if errs:
            return errs[0]
        podreqs = pod_requirements(pod)
        keys = podreqs.keys()
        owns = [self.requirements.requirement(key) for key in keys]
        for key, own in zip(keys, owns):
            if own is None or len(own) == 0:
                return (f"invalid nodeSelector {key!r}, "
                        f"{sorted(podreqs.requirement(key) or [])} not in {sorted(own or [])}")
        # own holds an In for every key, so the provisioner's requirements
        # with the pod's added evaluate, per key, to own narrowed by the
        # pod's In and NotIn sets (pod_requirements normalized the keys);
        # Requirements.requirement reads no other operator
        for key, own in zip(keys, owns):
            mine = [r for r in podreqs.items if r.key == key]
            if len(mine) == 1 and mine[0].operator == IN:
                allowed = not own.isdisjoint(mine[0].values)
            else:
                narrowed = set(own)
                for r in mine:
                    if r.operator == IN:
                        narrowed.intersection_update(r.values)
                    elif r.operator == NOT_IN:
                        narrowed.difference_update(r.values)
                allowed = bool(narrowed)
            if not allowed:
                return (f"invalid nodeSelector {key!r}, "
                        f"{sorted(podreqs.requirement(key) or [])} not in {sorted(own)}")
        return None

    def tighten(self, pod: Pod) -> "Constraints":
        """Constraints ∧ pod requirements, consolidated, well-known-only
        (constraints.go:68-76)."""
        return Constraints(
            labels=self.labels,
            taints=self.taints,
            requirements=self.requirements.add(
                *pod_requirements(pod).items).consolidate().well_known(),
            kubelet_configuration=self.kubelet_configuration,
            provider=self.provider,
        )

    def deepcopy(self) -> "Constraints":
        return copy.deepcopy(self)
