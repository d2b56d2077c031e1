"""Pod predicates (reference: pkg/utils/pod/scheduling.go)."""

from __future__ import annotations

from karpenter_tpu_torch.api.core import Pod, Taint


def failed_to_schedule(pod: Pod) -> bool:
    return any(c.type == "PodScheduled" and c.reason == "Unschedulable"
               for c in pod.status.conditions)


def is_scheduled(pod: Pod) -> bool:
    return pod.spec.node_name != ""


def is_preempting(pod: Pod) -> bool:
    return pod.status.nominated_node_name != ""


def is_terminal(pod: Pod) -> bool:
    return pod.status.phase in ("Failed", "Succeeded")


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_owned_by_daemonset(pod: Pod) -> bool:
    return any(o.kind == "DaemonSet" for o in pod.metadata.owner_references)


def is_owned_by_node(pod: Pod) -> bool:
    """Static pods are owned by their Node."""
    return any(o.kind == "Node" for o in pod.metadata.owner_references)


def tolerates_unschedulable_taint(pod: Pod) -> bool:
    """True if the pod tolerates the node.kubernetes.io/unschedulable taint."""
    taint = Taint(key="node.kubernetes.io/unschedulable", effect="NoSchedule")
    return any(t.tolerates_taint(taint) for t in pod.spec.tolerations)
