"""Node predicates (reference: pkg/utils/node/predicates.go)."""

from __future__ import annotations

from karpenter_tpu_torch.api.core import Node, NodeCondition


def get_condition(node: Node, match: str) -> NodeCondition:
    for condition in node.status.conditions:
        if condition.type == match:
            return condition
    return NodeCondition()


def is_ready(node: Node) -> bool:
    return get_condition(node, "Ready").status == "True"
