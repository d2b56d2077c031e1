"""Requirements: the node-selector constraint algebra.

Host implementation of the set semantics in
pkg/apis/provisioning/v1alpha5/requirements.go. A requirement list evaluates,
per key, to ``(∩ of all In sets) ∖ (∪ of all NotIn sets)``; ``None`` means
"unconstrained". A trimmed copy of the JAX package's module: the evaluation
the solver's viability validators read.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import NodeSelectorRequirement

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

    def requirement(self, key: str) -> Optional[FrozenSet[str]]:
        """Allowed values for key: (∩ In) ∖ (∪ NotIn); None if unconstrained
        (requirements.go:176-195)."""
        result: Optional[set] = None
        for r in self.items:
            if r.key == key and r.operator == IN:
                vals = set(r.values)
                result = vals if result is None else (result & vals)
        for r in self.items:
            if r.key == key and r.operator == NOT_IN:
                # Go quirk: nil.Difference(x) returns a non-nil empty set, so
                # a NotIn with no In collapses to "nothing allowed", not
                # "unconstrained" (requirements.go:189-194).
                result = (result or set()) - set(r.values)
        return frozenset(result) if result is not None else None

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
