"""Counter controller: aggregate node capacity into Provisioner status.

Reference: pkg/controllers/counter/controller.go:51-87, and the JAX
package's ``controllers/counter.py``. The result feeds the limits check in
the provisioning worker's ``_launch`` and ``_launch_gang``
(provisioner.go:139-144): without it a provisioner's limits never bind.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import LabelSelector
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.utils.resources import Quantity


class CounterController:
    def __init__(self, kube: KubeCore):
        self.kube = kube

    def kind(self) -> str:
        return "Provisioner"

    def mappings(self):
        """Node events map to their provisioner (counter/controller.go:90-112)."""
        def node_to_provisioner(node):
            name = node.metadata.labels.get(wellknown.PROVISIONER_NAME_LABEL)
            return [(name, "default")] if name else []

        return [("Node", node_to_provisioner)]

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        try:
            self.kube.get("Provisioner", name, namespace)
        except NotFound:
            return None
        nodes = self.kube.list(
            "Node",
            label_selector=LabelSelector(
                match_labels={wellknown.PROVISIONER_NAME_LABEL: name}))
        cpu, memory = Quantity(0), Quantity(0)
        for node in nodes:
            cpu = cpu.add(node.status.capacity.get("cpu", Quantity(0)))
            memory = memory.add(node.status.capacity.get("memory", Quantity(0)))

        def apply(p):
            p.status.resources = {"cpu": cpu, "memory": memory}
        try:
            self.kube.patch("Provisioner", name, namespace, apply)
        except NotFound:
            pass
        return None
