"""Topology spread: TopologySpreadConstraints as just-in-time NodeSelectors.

Reference: pkg/controllers/provisioning/scheduling/{topology.go,
topologygroup.go}. The trick (scheduler.go:69-72) carries over unchanged:
topology decisions are injected into pods as node selectors *before*
constraint grouping, keeping the solver oblivious to topology. A copy of
the JAX package's module: each pod's allowed domains come from the columnar
engine (``ops/feasibility.topology_allowed``) once per pod signature, with
the requirement algebra as the oracle it self-heals against. Left out: the
``KARPENTER_TOPOLOGY_COLUMNAR`` kill switch.
"""

from __future__ import annotations

import math
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import (
    NodeSelectorRequirement, Pod, TopologySpreadConstraint,
)
from karpenter_tpu_torch.api.requirements import pod_requirements
from karpenter_tpu_torch.ops import feasibility
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.utils import pod as podutil

_UNSET = object()  # cache sentinel: None is a real value (unconstrained)


@dataclass
class TopologyGroup:
    """Pods sharing one equivalent spread constraint (topologygroup.go:24-38)."""

    constraint: TopologySpreadConstraint
    pods: List[Pod] = field(default_factory=list)
    spread: Dict[str, int] = field(default_factory=dict)

    def register(self, *domains: str) -> None:
        for d in domains:
            self.spread.setdefault(d, 0)

    def increment(self, domain: str) -> None:
        if domain in self.spread:
            self.spread[domain] += 1

    def next_domain(self, requirement: Optional[frozenset]) -> str:
        """Min-count domain satisfying the requirement (topologygroup.go:54-68).
        Go iterates its map in random order with `<=`, so ties go to an
        arbitrary domain; any tie-break is parity-compatible. When no domain
        satisfies the requirement, Go increments a spurious "" entry; we
        return "" (the pod then fails validation, same outcome) without
        polluting the spread counts."""
        min_domain, min_count = "", None
        for domain, count in self.spread.items():
            if requirement is not None and domain not in requirement:
                continue
            if min_count is None or count <= min_count:
                min_domain, min_count = domain, count
        if min_count is None:
            return ""
        self.spread[min_domain] += 1
        return min_domain


def _group_key(namespace: str, c: TopologySpreadConstraint) -> tuple:
    sel = c.label_selector
    sel_key = None
    if sel is not None:
        sel_key = (
            tuple(sorted(sel.match_labels.items())),
            tuple((e.key, e.operator, tuple(e.values)) for e in sel.match_expressions),
        )
    return (namespace, c.max_skew, c.topology_key, c.when_unsatisfiable, sel_key)


def ignored_for_topology(p: Pod) -> bool:
    """topology.go:158-160."""
    return (not podutil.is_scheduled(p)) or podutil.is_terminal(p) or podutil.is_terminating(p)


class Topology:
    """topology.go:35-140."""

    def __init__(self, kube: KubeCore):
        self.kube = kube

    def inject(self, constraints: Constraints, pods: List[Pod]) -> None:
        """Inject each spread group's next domain into its pods as a node
        selector. The allowed-domain set is computed once per pod
        signature through the compiled bitset engine
        (``feasibility.topology_allowed``).

        Whenever the columnar set yields no satisfiable domain (next_domain
        would return ""), the scalar algebra recomputes the set once per
        signature; a disagreement is counted in ``karpenter_filter_fallback_total``
        (and ``feasibility.HEALS``) under
        ``topology-mismatch`` and the scalar answer wins, so a divergence
        can never strand a spreadable pod. Signature-less pods (unsupported
        operators) and compile failures take the scalar path outright.
        Pods left with no satisfiable domain are marked
        (``_topology_unsat``) so the scheduler's window summary can bucket
        them under reason=topology."""
        groups = self._get_topology_groups(pods)
        for group in groups:
            for pod in group.pods:
                pod.__dict__.pop("_topology_unsat", None)
        for group in groups:
            self._compute_current_topology(constraints, group)
            key = group.constraint.topology_key
            # hostname groups appended an In row above: the fingerprint
            # length moved, so this recompiles rather than serving stale
            cc = feasibility.compile_constraints(constraints)
            allowed_cache: Dict[tuple, Optional[frozenset]] = {}
            for pod in group.pods:
                sig = feasibility.pod_signature(pod) if cc is not None else None
                if sig is None:
                    allowed = self._scalar_allowed(constraints, pod, key)
                else:
                    allowed = allowed_cache.get(sig, _UNSET)
                    if allowed is _UNSET:
                        allowed = allowed_cache[sig] = feasibility.topology_allowed(
                            cc, sig, key)
                domain = group.next_domain(allowed)
                if domain == "" and sig is not None:
                    # self-heal: "" never mutates the spread counts, so a
                    # scalar recheck and retry is free of side effects
                    scalar = self._scalar_allowed(constraints, pod, key)
                    if scalar != allowed:
                        feasibility._count("topology-mismatch")
                        allowed_cache[sig] = scalar
                        domain = group.next_domain(scalar)
                if domain == "":
                    pod.__dict__["_topology_unsat"] = True
                pod.spec.node_selector = {
                    **pod.spec.node_selector,
                    key: domain,
                }

    @staticmethod
    def _scalar_allowed(constraints: Constraints, pod: Pod, key: str) -> Optional[frozenset]:
        """The per-pod scalar algebra: the oracle the columnar path heals
        against."""
        return constraints.requirements.add(*pod_requirements(pod).items).requirement(key)

    def _get_topology_groups(self, pods: List[Pod]) -> List[TopologyGroup]:
        groups: Dict[tuple, TopologyGroup] = {}
        for pod in pods:
            for constraint in pod.spec.topology_spread_constraints:
                key = _group_key(pod.metadata.namespace, constraint)
                if key in groups:
                    groups[key].pods.append(pod)
                else:
                    groups[key] = TopologyGroup(constraint=constraint, pods=[pod])
        return list(groups.values())

    def _compute_current_topology(self, constraints: Constraints, group: TopologyGroup) -> None:
        key = group.constraint.topology_key
        if key == wellknown.LABEL_HOSTNAME:
            self._compute_hostname_topology(group, constraints)
        elif key == wellknown.LABEL_TOPOLOGY_ZONE:
            self._compute_zonal_topology(constraints, group)

    def _compute_hostname_topology(self, group: TopologyGroup, constraints: Constraints) -> None:
        """topology.go:95-105: new hostnames always improve skew, so generate
        ceil(len(pods)/maxSkew) fresh domains and admit them as requirements."""
        n = math.ceil(len(group.pods) / max(1, group.constraint.max_skew))
        domains = [secrets.token_hex(4) for _ in range(n)]
        group.register(*domains)
        constraints.requirements.items.append(NodeSelectorRequirement(
            key=group.constraint.topology_key, operator="In", values=domains))

    def _compute_zonal_topology(self, constraints: Constraints, group: TopologyGroup) -> None:
        """topology.go:112-140: domains = viable zones; current counts from
        scheduled, non-terminal pods matching the constraint selector."""
        zones = constraints.requirements.zones() or frozenset()
        group.register(*zones)
        self._count_matching_pods(group)

    def _count_matching_pods(self, group: TopologyGroup) -> None:
        namespace = group.pods[0].metadata.namespace
        candidates = self.kube.list(
            "Pod", namespace=namespace, label_selector=group.constraint.label_selector)
        for p in candidates:
            if ignored_for_topology(p):
                continue
            try:
                node = self.kube.get("Node", p.spec.node_name, namespace="")
            except NotFound:
                continue
            domain = node.metadata.labels.get(group.constraint.topology_key)
            if domain is None:
                continue  # node without the domain label doesn't count
            group.increment(domain)
