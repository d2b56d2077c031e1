"""Requirements: the node-selector constraint algebra.

Host implementation of the set semantics in
pkg/apis/provisioning/v1alpha5/requirements.go. A requirement list evaluates,
per key, to ``(∩ of all In sets) ∖ (∪ of all NotIn sets)``; ``None`` means
"unconstrained". A trimmed copy of the JAX package's module: the evaluation
the solver's viability validators read, and the consolidation and pod
extraction the scheduler's tighten() runs.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import NodeSelectorRequirement, Pod

IN = "In"
NOT_IN = "NotIn"


class Requirements:
    """Decorated list of NodeSelectorRequirements (requirements.go:73-74)."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[Iterable[NodeSelectorRequirement]] = None):
        self.items: List[NodeSelectorRequirement] = list(items or [])

    def add(self, *reqs: NodeSelectorRequirement) -> "Requirements":
        """Append normalized requirements, returning a new list
        (requirements.go:96-98): aliased label keys become well-known ones
        (requirements.go:101-111)."""
        normalized = [
            NodeSelectorRequirement(key=wellknown.NORMALIZED_LABELS.get(r.key, r.key),
                                    operator=r.operator, values=list(r.values))
            for r in reqs
        ]
        return Requirements(self.items + normalized)

    def consolidate(self) -> "Requirements":
        """Collapse to one In requirement per key (requirements.go:119-128).
        A NotIn with no In collapses to [] permanently — quirk preserved."""
        out = Requirements()
        for key in self.keys():
            out = out.add(NodeSelectorRequirement(
                key=key, operator=IN, values=sorted(self.requirement(key) or set())))
        return out

    def well_known(self) -> "Requirements":
        """Keep only well-known keys (requirements.go:157-164)."""
        return Requirements(r for r in self.items if r.key in wellknown.WELL_KNOWN_LABELS)

    def keys(self) -> List[str]:
        seen = []
        for r in self.items:
            if r.key not in seen:
                seen.append(r.key)
        return seen

    def requirement(self, key: str) -> Optional[FrozenSet[str]]:
        """Allowed values for key: (∩ In) ∖ (∪ NotIn); None if unconstrained
        (requirements.go:176-195)."""
        ins = [r.values for r in self.items if r.key == key and r.operator == IN]
        outs = [r.values for r in self.items if r.key == key and r.operator == NOT_IN]
        if not outs:
            if not ins:
                return None
            if len(ins) == 1:
                return frozenset(ins[0])
        # Go quirk: nil.Difference(x) returns a non-nil empty set, so a NotIn
        # with no In collapses to "nothing allowed", not "unconstrained"
        # (requirements.go:189-194).
        result = set(ins[0]) if ins else set()
        for values in ins[1:]:
            result.intersection_update(values)
        for values in outs:
            result.difference_update(values)
        return frozenset(result)

    # -- well-known accessors (requirements.go:76-94) -----------------------
    def zones(self) -> Optional[FrozenSet[str]]:
        return self.requirement(wellknown.LABEL_TOPOLOGY_ZONE)

    def instance_types(self) -> Optional[FrozenSet[str]]:
        return self.requirement(wellknown.LABEL_INSTANCE_TYPE)

    def architectures(self) -> Optional[FrozenSet[str]]:
        return self.requirement(wellknown.LABEL_ARCH)

    def operating_systems(self) -> Optional[FrozenSet[str]]:
        return self.requirement(wellknown.LABEL_OS)

    def capacity_types(self) -> Optional[FrozenSet[str]]:
        return self.requirement(wellknown.LABEL_CAPACITY_TYPE)

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __repr__(self):
        return f"Requirements({[(r.key, r.operator, r.values) for r in self.items]})"


def pod_requirements(pod: Pod) -> Requirements:
    """Extract scheduling requirements from a pod (requirements.go:137-155):
    nodeSelector + heaviest preferred term + first required term."""
    r = Requirements().add(*(NodeSelectorRequirement(key=key, operator=IN, values=[value])
                             for key, value in pod.spec.node_selector.items()))
    affinity = pod.spec.affinity
    if affinity is None or affinity.node_affinity is None:
        return r
    na = affinity.node_affinity
    if na.preferred:
        heaviest = max(na.preferred, key=lambda t: t.weight)
        r = r.add(*heaviest.preference.match_expressions)
    if na.required:
        r = r.add(*na.required[0].match_expressions)
    return r
