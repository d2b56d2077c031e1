"""Metrics controllers: node resource gauges and pod state.

Reference: pkg/controllers/metrics/{node,pod}/controller.go. Node: six gauge
families (allocatable, total_pod_requests/limits, total_daemon_requests/
limits, system_overhead) labeled by resource/node/provisioner/zone/arch/
capacity-type/instance-type/phase, recomputed per reconcile with
stale-series cleanup. Pod: the karpenter_pods_state gauge. A copy of the
JAX package's ``controllers/metrics_controllers.py`` over the port's
``KubeCore``.
"""

from __future__ import annotations

from typing import Dict, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.metrics import registry
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.resources import (
    Quantity, limits_for_pods, requests_for_pods,
)

_GAUGES = {
    "allocatable": "nodes_allocatable",
    "pod_requests": "nodes_total_pod_requests",
    "pod_limits": "nodes_total_pod_limits",
    "daemon_requests": "nodes_total_daemon_requests",
    "daemon_limits": "nodes_total_daemon_limits",
    "overhead": "nodes_system_overhead",
}


def _node_labels(node) -> Dict[str, str]:
    labels = node.metadata.labels
    return {
        "node_name": node.metadata.name,
        "provisioner": labels.get(wellknown.PROVISIONER_NAME_LABEL, ""),
        "zone": labels.get(wellknown.LABEL_TOPOLOGY_ZONE, ""),
        "arch": labels.get(wellknown.LABEL_ARCH, ""),
        "capacity_type": labels.get(wellknown.LABEL_CAPACITY_TYPE, ""),
        "instance_type": labels.get(wellknown.LABEL_INSTANCE_TYPE, ""),
        "phase": "Ready" if any(
            c.type == "Ready" and c.status == "True"
            for c in node.status.conditions) else "NotReady",
    }


def _as_float(q: Quantity, resource_name: str) -> float:
    if resource_name == "cpu":
        return q.milli_value() / 1000.0
    return float(q.value())


class NodeMetricsController:
    """metrics/node/controller.go:144-302."""

    def __init__(self, kube: KubeCore, reg: Optional[registry.Registry] = None):
        self.kube = kube
        self.registry = reg or registry.DEFAULT

    def kind(self) -> str:
        return "Node"

    def mappings(self):
        """Pod events map to their node (metrics/node watches pods)."""
        def pod_to_node(pod):
            return [(pod.spec.node_name, "")] if pod.spec.node_name else []

        return [("Pod", pod_to_node)]

    def reconcile(self, name: str, namespace: str = "") -> Optional[float]:
        gauges = {k: self.registry.gauge(v) for k, v in _GAUGES.items()}
        try:
            node = self.kube.get("Node", name, namespace)
        except NotFound:
            for g in gauges.values():
                g.delete_matching(node_name=name)
            return None

        labels = _node_labels(node)
        for g in gauges.values():
            g.delete_matching(node_name=name)

        pods = self.kube.pods_on_node(name)
        daemons = [p for p in pods if podutil.is_owned_by_daemonset(p)]
        series = {
            "allocatable": node.status.allocatable,
            "pod_requests": requests_for_pods(*pods),
            "pod_limits": limits_for_pods(*pods),
            "daemon_requests": requests_for_pods(*daemons),
            "daemon_limits": limits_for_pods(*daemons),
            "overhead": _overhead(node),
        }
        for kind, resource_list in series.items():
            for resource_name, q in resource_list.items():
                gauges[kind].set(_as_float(q, resource_name),
                                 resource_type=resource_name, **labels)
        return None


def _overhead(node):
    """capacity - allocatable (system/kubelet reservation)."""
    out = {}
    for name, cap in node.status.capacity.items():
        alloc = node.status.allocatable.get(name, Quantity(0))
        out[name] = cap.sub(alloc)
    return out


class PodMetricsController:
    """metrics/pod/controller.go: karpenter_pods_state gauge."""

    def __init__(self, kube: KubeCore, reg: Optional[registry.Registry] = None):
        self.kube = kube
        self.registry = reg or registry.DEFAULT

    def kind(self) -> str:
        return "Pod"

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        gauge = self.registry.gauge("pods_state")
        try:
            pod = self.kube.get("Pod", name, namespace)
        except NotFound:
            gauge.delete_matching(name=name, namespace=namespace)
            return None
        gauge.delete_matching(name=name, namespace=namespace)
        node_labels: Dict[str, str] = {}
        if pod.spec.node_name:
            try:
                node = self.kube.get("Node", pod.spec.node_name, "")
                node_labels = node.metadata.labels
            except NotFound:
                pass
        gauge.set(1.0,
                  name=name, namespace=namespace, node=pod.spec.node_name,
                  provisioner=node_labels.get(wellknown.PROVISIONER_NAME_LABEL, ""),
                  zone=node_labels.get(wellknown.LABEL_TOPOLOGY_ZONE, ""),
                  arch=node_labels.get(wellknown.LABEL_ARCH, ""),
                  capacity_type=node_labels.get(wellknown.LABEL_CAPACITY_TYPE, ""),
                  instance_type=node_labels.get(wellknown.LABEL_INSTANCE_TYPE, ""),
                  phase=pod.status.phase)
        return None
