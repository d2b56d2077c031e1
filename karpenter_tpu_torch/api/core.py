"""The Kubernetes object types that ``solve()`` reads.

A trimmed copy of the JAX package's object model: pod metadata, the PodSpec
scheduling fields (node selector, tolerations), containers with their
resource requirements, and taints. Everything is a plain dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from karpenter_tpu_torch.utils.resources import ResourceList, parse_resource_list


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = ""


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects


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
class PodSpec:
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    containers: List[Container] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    kind: str = "Pod"
