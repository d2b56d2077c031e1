"""Node lifecycle controller: readiness, liveness, expiration, emptiness,
finalizer.

Reference: pkg/controllers/node/ (orchestrator + 5 sub-reconcilers), and
the JAX package's ``controllers/node.py``. The orchestrator deep-copies the
node, runs every sub-reconciler in sequence, patches once if anything
changed, and requeues at the minimum of the sub-results. Under the
Manager (runtime/manager.py), :meth:`NodeController.mappings` maps pod and
provisioner events onto node reconciles.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import LabelSelector, Node
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.utils import clock
from karpenter_tpu_torch.utils import node as nodeutil
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.fastcopy import deep_copy

log = logging.getLogger("karpenter.node")

LIVENESS_TIMEOUT_SECONDS = 15 * 60  # liveness.go LivenessTimeout


class Readiness:
    """Remove the not-ready taint once Ready (readiness.go)."""

    def reconcile(self, provisioner: Provisioner, n: Node, kube: KubeCore) -> Optional[float]:
        if not nodeutil.is_ready(n):
            return None
        n.spec.taints = [t for t in n.spec.taints
                         if t.key != wellknown.NOT_READY_TAINT_KEY]
        return None


class Liveness:
    """Delete nodes whose kubelet never reported within the timeout
    (liveness.go:224-250)."""

    def reconcile(self, provisioner: Provisioner, n: Node, kube: KubeCore) -> Optional[float]:
        created = n.metadata.creation_timestamp or clock.now()
        since_creation = clock.now() - created
        if since_creation < LIVENESS_TIMEOUT_SECONDS:
            return LIVENESS_TIMEOUT_SECONDS - since_creation
        condition = nodeutil.get_condition(n, "Ready")
        # "" = never set; NodeStatusNeverUpdated = kcm marked it unreachable
        if condition.reason not in ("", "NodeStatusNeverUpdated"):
            return None
        log.info("triggering termination for node %s that failed to join",
                 n.metadata.name)
        kube.delete("Node", n.metadata.name, n.metadata.namespace)
        return None


class Expiration:
    """Delete nodes older than ttlSecondsUntilExpired (expiration.go)."""

    def reconcile(self, provisioner: Provisioner, n: Node, kube: KubeCore) -> Optional[float]:
        ttl = provisioner.spec.ttl_seconds_until_expired
        if ttl is None:
            return None
        expiration_time = (n.metadata.creation_timestamp or 0) + ttl
        if clock.now() > expiration_time:
            log.info("triggering termination for expired node %s after %ss",
                     n.metadata.name, ttl)
            kube.delete("Node", n.metadata.name, n.metadata.namespace)
            return None
        return expiration_time - clock.now()


class Emptiness:
    """Stamp/clear the emptiness timestamp; delete after the TTL
    (emptiness.go:38-99)."""

    def reconcile(self, provisioner: Provisioner, n: Node, kube: KubeCore) -> Optional[float]:
        ttl = provisioner.spec.ttl_seconds_after_empty
        if ttl is None:
            return None
        if not nodeutil.is_ready(n):
            return None
        empty = self._is_empty(kube, n)
        stamp = n.metadata.annotations.get(wellknown.EMPTINESS_TIMESTAMP_ANNOTATION)
        if not empty:
            if stamp is not None:
                del n.metadata.annotations[wellknown.EMPTINESS_TIMESTAMP_ANNOTATION]
                log.info("removed emptiness TTL from node %s", n.metadata.name)
            return None
        if stamp is None:
            n.metadata.annotations[wellknown.EMPTINESS_TIMESTAMP_ANNOTATION] = (
                repr(clock.now()))
            log.info("added TTL to empty node %s", n.metadata.name)
            return float(ttl)
        try:
            emptiness_time = float(stamp)
        except ValueError:
            log.error("unparseable emptiness timestamp %r", stamp)
            return None
        if clock.now() > emptiness_time + ttl:
            log.info("triggering termination after %ss for empty node %s",
                     ttl, n.metadata.name)
            kube.delete("Node", n.metadata.name, n.metadata.namespace)
        return None

    def _is_empty(self, kube: KubeCore, n: Node) -> bool:
        """Only terminal/daemonset/static pods remain (emptiness.go:84-99)."""
        for p in kube.pods_on_node(n.metadata.name):
            if podutil.is_terminal(p):
                continue
            if not podutil.is_owned_by_daemonset(p) and not podutil.is_owned_by_node(p):
                return False
        return True


class Finalizer:
    """Re-add the termination finalizer on self-registered nodes
    (finalizer.go:178-193)."""

    def reconcile(self, provisioner: Provisioner, n: Node, kube: KubeCore) -> Optional[float]:
        if n.metadata.deletion_timestamp is not None:
            return None
        if wellknown.TERMINATION_FINALIZER not in n.metadata.finalizers:
            n.metadata.finalizers.append(wellknown.TERMINATION_FINALIZER)
        return None


class NodeController:
    """Orchestrator (node/controller.go:63-118)."""

    def __init__(self, kube: KubeCore):
        self.kube = kube
        self.readiness = Readiness()
        self.liveness = Liveness()
        self.expiration = Expiration()
        self.emptiness = Emptiness()
        self.finalizer = Finalizer()

    def kind(self) -> str:
        return "Node"

    def mappings(self):
        """Extra watches (node/controller.go:125-149): pod events map to
        their node; provisioner events map to all its nodes."""
        def pod_to_node(pod):
            return [(pod.spec.node_name, "")] if getattr(pod.spec, "node_name", "") else []

        def provisioner_to_nodes(p):
            nodes = self.kube.list("Node", label_selector=LabelSelector(
                match_labels={wellknown.PROVISIONER_NAME_LABEL: p.metadata.name}))
            return [(n.metadata.name, "") for n in nodes]

        return [("Pod", pod_to_node), ("Provisioner", provisioner_to_nodes)]

    def reconcile(self, name: str, namespace: str = "") -> Optional[float]:
        try:
            stored = self.kube.get("Node", name, namespace)
        except NotFound:
            return None
        provisioner_name = stored.metadata.labels.get(wellknown.PROVISIONER_NAME_LABEL)
        if provisioner_name is None:
            return None
        if stored.metadata.deletion_timestamp is not None:
            return None
        try:
            provisioner = self.kube.get("Provisioner", provisioner_name)
        except NotFound:
            return None

        node = deep_copy(stored)
        requeues: List[float] = []
        for sub in (self.readiness, self.liveness, self.expiration,
                    self.emptiness, self.finalizer):
            requeue = sub.reconcile(provisioner, node, self.kube)
            if requeue is not None:
                requeues.append(requeue)
        if _node_changed(node, stored):
            try:
                def apply(live: Node):
                    live.spec.taints = node.spec.taints
                    live.metadata.annotations = node.metadata.annotations
                    live.metadata.finalizers = node.metadata.finalizers
                self.kube.patch("Node", name, namespace, apply)
            except NotFound:
                return None
        return min(requeues) if requeues else None


def _node_changed(a: Node, b: Node) -> bool:
    return (
        [(t.key, t.value, t.effect) for t in a.spec.taints]
        != [(t.key, t.value, t.effect) for t in b.spec.taints]
        or a.metadata.annotations != b.metadata.annotations
        or a.metadata.finalizers != b.metadata.finalizers
    )
