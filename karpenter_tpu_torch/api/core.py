"""The Kubernetes object types the port's solver and controllers read.

A trimmed copy of the JAX package's object model: metadata (labels,
annotations, finalizers, owner references, deletion timestamp), the PodSpec
scheduling fields (node selector, tolerations, node and pod affinity,
topology spread, priority, volumes), containers with their resource
requirements, pod and node status, taints, the DaemonSet template, the
PodDisruptionBudget and the volume objects (PersistentVolumeClaim,
PersistentVolume, StorageClass) that volume topology reads. Everything is a plain dataclass; the in-memory API
server (runtime/kubecore.py) gives them create/patch/delete/watch,
finalizer and eviction semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.utils.resources import ResourceList, parse_resource_list


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List["OwnerReference"] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    creation_timestamp: Optional[float] = None
    resource_version: int = 0
    uid: str = ""


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    controller: bool = False
    api_version: str = ""
    uid: str = ""


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects

    def tolerates_taint(self, taint: "Taint") -> bool:
        """k8s core/v1 Toleration.ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            # k8s: Exists tolerations must not carry a value
            return self.value == ""
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        return False


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    match_fields: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    required: Optional[List[NodeSelectorTerm]] = None  # RequiredDuringScheduling terms
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    topology_key: str = ""
    label_selector: Optional["LabelSelector"] = None


@dataclass
class WeightedPodAffinityTerm:
    """PreferredDuringSchedulingIgnoredDuringExecution entry: a soft
    (anti-)affinity term scored with ``weight`` (kube range 1-100)."""

    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            val = labels.get(expr.key)
            if expr.operator == "In":
                if val not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if val in expr.values:
                    return False
            elif expr.operator == "Exists":
                if expr.key not in labels:
                    return False
            elif expr.operator == "DoesNotExist":
                if expr.key in labels:
                    return False
        return True


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"
    label_selector: Optional[LabelSelector] = None


@dataclass
class ResourceRequirements:
    requests: ResourceList = field(default_factory=dict)
    limits: ResourceList = field(default_factory=dict)

    @staticmethod
    def make(requests=None, limits=None) -> "ResourceRequirements":
        return ResourceRequirements(
            requests=parse_resource_list(requests), limits=parse_resource_list(limits)
        )


@dataclass
class Container:
    name: str = "app"
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""


@dataclass
class Volume:
    name: str = ""
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None


@dataclass
class PodSpec:
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    containers: List[Container] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    affinity: Optional[Affinity] = None
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    priority_class_name: str = ""
    priority: int = 0  # resolved priority value (admission stamps it from the class)
    preemption_policy: str = "PreemptLowerPriority"
    termination_grace_period_seconds: int = 30


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""  # True | False | Unknown
    reason: str = ""


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    provider_id: str = ""


@dataclass
class NodeCondition:
    type: str = ""
    status: str = "Unknown"
    reason: str = ""
    last_heartbeat_time: Optional[float] = None


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)
    kind: str = "Node"


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class DaemonSetSpec:
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    kind: str = "DaemonSet"


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: Optional[float] = None
    renew_time: Optional[float] = None


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease — leader election's backing object."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)
    kind: str = "Lease"


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    kind: str = "ConfigMap"


@dataclass
class Secret:
    """v1 Secret; ``data`` values are base64-encoded strings (wire form).
    Holds the admission webhook's CA and serving certificate
    (webhooks/certs.py)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    type: str = "Opaque"
    kind: str = "Secret"


@dataclass
class PersistentVolumeClaimSpec:
    storage_class_name: Optional[str] = None
    volume_name: str = ""


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    kind: str = "PersistentVolumeClaim"


@dataclass
class VolumeNodeAffinity:
    required: Optional[List[NodeSelectorTerm]] = None


@dataclass
class PersistentVolumeSpec:
    node_affinity: Optional[VolumeNodeAffinity] = None


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    kind: str = "PersistentVolume"


@dataclass
class TopologySelectorTerm:
    match_label_expressions: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    allowed_topologies: List[TopologySelectorTerm] = field(default_factory=list)
    kind: str = "StorageClass"


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    # IntOrString, like the real API: an integer count or a percentage
    # string ("50%") resolved against the PDB's expected pods at eviction
    # time (runtime/kubecore.py evict_pod). Setting both is the same
    # misconfiguration it is upstream and 500s the eviction.
    min_available: Optional[object] = None  # int | "N%"
    max_unavailable: Optional[object] = None  # int | "N%"
    kind: str = "PodDisruptionBudget"
