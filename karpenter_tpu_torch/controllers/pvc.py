"""PVC controller: stamp selected-node so volumes provision in-zone.

Reference: pkg/controllers/persistentvolumeclaim/controller.go:63-94, and
the JAX package's ``controllers/pvc.py``. Once a pod that mounts a claim is
bound, the claim is annotated with the pod's node, so the volume provisions
in the node's zone.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.utils import pod as podutil

SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"


class PVCController:
    def __init__(self, kube: KubeCore):
        self.kube = kube

    def kind(self) -> str:
        return "PersistentVolumeClaim"

    def mappings(self):
        """Pod events map to their PVCs (pvc controller Watches(Pod))."""
        def pod_to_pvcs(pod):
            return [
                (v.persistent_volume_claim.claim_name, pod.metadata.namespace)
                for v in pod.spec.volumes
                if v.persistent_volume_claim is not None
            ]

        return [("Pod", pod_to_pvcs)]

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        try:
            pvc = self.kube.get("PersistentVolumeClaim", name, namespace)
        except NotFound:
            return None
        pod = self._pod_for_pvc(pvc)
        if pod is None:
            return None
        if pvc.metadata.annotations.get(SELECTED_NODE_ANNOTATION) == pod.spec.node_name:
            return None
        if not self._is_bindable(pod):
            return None

        def apply(live):
            live.metadata.annotations[SELECTED_NODE_ANNOTATION] = pod.spec.node_name
        self.kube.patch("PersistentVolumeClaim", name, namespace, apply)
        return None

    def _pod_for_pvc(self, pvc):
        for pod in self.kube.list("Pod", namespace=pvc.metadata.namespace):
            for volume in pod.spec.volumes:
                if (volume.persistent_volume_claim is not None
                        and volume.persistent_volume_claim.claim_name
                        == pvc.metadata.name):
                    return pod
        return None

    @staticmethod
    def _is_bindable(pod) -> bool:
        return podutil.is_scheduled(pod) and not podutil.is_terminal(pod)
