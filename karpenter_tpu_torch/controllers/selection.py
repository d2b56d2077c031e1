"""Selection controller: route provisionable pods to a Provisioner worker.

Reference: pkg/controllers/selection/{controller.go,preferences.go,
volumetopology.go}, and the JAX package's ``controllers/selection.py``.
Filters to provisionable pods; validates supported features; relaxes
preferences on retries; injects volume topology (a claim's bound volume's
node affinity, or its storage class's allowed topologies, as required node
affinity); picks the first Provisioner whose constraints validate the pod
and enqueues it on that Provisioner's worker.

The route validates through the columnar engine
(``feasibility.validate_pod_fast``: a memoized signature lookup per
provisioner and pod shape, the scalar validator's verdicts and error
strings). A pod shed at intake burns its band's SLO error budget
(``slo.note_shed``).
"""

from __future__ import annotations

import logging
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import (
    Affinity, NodeAffinity, NodeSelectorRequirement, NodeSelectorTerm, Pod,
)
from karpenter_tpu_torch.obs import slo
from karpenter_tpu_torch.ops import feasibility
from karpenter_tpu_torch.pressure import classify, get_monitor
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.utils import clock
from karpenter_tpu_torch.utils import pod as podutil

log = logging.getLogger("karpenter.selection")

RELAXATION_TTL_SECONDS = 5 * 60  # preferences.go ExpirationTTL

# requeue jitter spread: factor in [1-J/2, 1+J/2) — wide enough that a
# mass-shed cohort's retries smear across ~2.5 s at the 5 s base, narrow
# enough that backoff tiers (5/10/20 s) never overlap
JITTER_SPREAD = 0.5


def requeue_jitter(key) -> float:
    """Deterministic per-pod jitter factor in [0.75, 1.25): crc32 of the
    (namespace, name) key mapped onto the spread, so the same pod always
    lands on the same offset while different pods spread uniformly.
    key=None → 1.0 (no jitter)."""
    if key is None:
        return 1.0
    h = zlib.crc32(f"{key[0]}/{key[1]}".encode())
    return 1.0 - JITTER_SPREAD / 2 + JITTER_SPREAD * (h / 2 ** 32)


def is_provisionable(p: Pod) -> bool:
    """controller.go:115-121."""
    return (
        not podutil.is_scheduled(p)
        and not podutil.is_preempting(p)
        and podutil.failed_to_schedule(p)
        and not podutil.is_owned_by_daemonset(p)
        and not podutil.is_owned_by_node(p)
    )


def validate(p: Pod) -> Optional[str]:
    """Supported-feature validation (controller.go:123-174)."""
    errs: List[str] = []
    if p.spec.affinity is not None:
        for side, what in ((p.spec.affinity.pod_affinity, "pod affinity"),
                           (p.spec.affinity.pod_anti_affinity, "pod anti-affinity")):
            if side is None:
                continue
            for term in side.required:
                if not term.topology_key:
                    errs.append(f"{what} term without a topology key is not supported")
        na = p.spec.affinity.node_affinity
        if na is not None:
            terms = list(na.required or [])
            terms += [t.preference for t in na.preferred]
            for term in terms:
                if term.match_fields:
                    errs.append("node selector term with matchFields is not supported")
                for r in term.match_expressions:
                    if r.operator not in ("In", "NotIn"):
                        errs.append(f"unsupported operator {r.operator}")
    for c in p.spec.topology_spread_constraints:
        if c.topology_key not in (wellknown.LABEL_HOSTNAME, wellknown.LABEL_TOPOLOGY_ZONE):
            errs.append(f"unsupported topology key {c.topology_key}")
    return "; ".join(errs) if errs else None


class Preferences:
    """Iterative preference relaxation with TTL reset (preferences.go:40-106).
    Full-cache sweeps are amortized (at most one per quarter TTL); the
    per-entry TTL stays exact via the timestamp check."""

    SWEEP_INTERVAL_SECONDS = RELAXATION_TTL_SECONDS / 4

    def __init__(self):
        self._cache: Dict[str, Tuple[Optional[Affinity], float]] = {}
        self._lock = threading.Lock()
        self._next_sweep = 0.0

    def relax(self, pod: Pod) -> None:
        now = clock.now()
        uid = pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"
        with self._lock:
            if now >= self._next_sweep:
                self._cache = {k: v for k, v in self._cache.items()
                               if now - v[1] < RELAXATION_TTL_SECONDS}
                self._next_sweep = now + self.SWEEP_INTERVAL_SECONDS
            entry = self._cache.get(uid)
            if entry is not None and now - entry[1] >= RELAXATION_TTL_SECONDS:
                entry = None  # expired between sweeps: same TTL semantics
            if entry is None:
                self._cache[uid] = (pod.spec.affinity, now)
                return
            pod.spec.affinity = entry[0]
            if self._relax(pod):
                self._cache[uid] = (pod.spec.affinity, now)

    def _relax(self, pod: Pod) -> bool:
        return self._remove_preferred_term(pod) or self._remove_required_term(pod)

    def _remove_preferred_term(self, pod: Pod) -> bool:
        """Strip the heaviest preferred term (preferences.go:78-92)."""
        a = pod.spec.affinity
        if a is None or a.node_affinity is None or not a.node_affinity.preferred:
            return False
        terms = sorted(a.node_affinity.preferred, key=lambda t: -t.weight)
        a.node_affinity.preferred = terms[1:]
        log.debug("relaxed: removed preferred term weight=%s", terms[0].weight)
        return True

    def _remove_required_term(self, pod: Pod) -> bool:
        """Strip the first required OR-term, never the last
        (preferences.go:94-106)."""
        a = pod.spec.affinity
        if (a is None or a.node_affinity is None or a.node_affinity.required is None
                or len(a.node_affinity.required) <= 1):
            return False
        a.node_affinity.required = a.node_affinity.required[1:]
        log.debug("relaxed: removed required term")
        return True


class VolumeTopology:
    """PVC/PV/StorageClass topology → pod node affinity
    (volumetopology.go:37-128)."""

    def __init__(self, kube: KubeCore):
        self.kube = kube

    def inject(self, pod: Pod) -> None:
        requirements: List[NodeSelectorRequirement] = []
        for volume in pod.spec.volumes:
            requirements.extend(self._get_requirements(pod, volume))
        if not requirements:
            return
        if pod.spec.affinity is None:
            pod.spec.affinity = Affinity()
        if pod.spec.affinity.node_affinity is None:
            pod.spec.affinity.node_affinity = NodeAffinity()
        na = pod.spec.affinity.node_affinity
        if na.required is None:
            na.required = []
        if not na.required:
            na.required.append(NodeSelectorTerm())
        na.required[0].match_expressions.extend(requirements)

    def _get_requirements(self, pod: Pod, volume) -> List[NodeSelectorRequirement]:
        if volume.persistent_volume_claim is None:
            return []
        pvc = self.kube.get("PersistentVolumeClaim", volume.persistent_volume_claim.claim_name,
                            pod.metadata.namespace)
        if pvc.spec.volume_name:
            return self._pv_requirements(pvc)
        if pvc.spec.storage_class_name:
            return self._storage_class_requirements(pvc)
        return []

    def _pv_requirements(self, pvc) -> List[NodeSelectorRequirement]:
        pv = self.kube.get("PersistentVolume", pvc.spec.volume_name, "default")
        if pv.spec.node_affinity is None or pv.spec.node_affinity.required is None:
            return []
        terms = pv.spec.node_affinity.required
        return list(terms[0].match_expressions) if terms else []

    def _storage_class_requirements(self, pvc) -> List[NodeSelectorRequirement]:
        sc = self.kube.get("StorageClass", pvc.spec.storage_class_name, "default")
        if not sc.allowed_topologies:
            return []
        return [NodeSelectorRequirement(key=r.key, operator="In", values=list(r.values))
                for r in sc.allowed_topologies[0].match_label_expressions]


class SelectionController:
    """controller.go:59-111.

    Non-blocking, as the JAX package is by default: the pod is enqueued to
    the batcher and the 5-second requeue performs the post-batch
    re-verification the reference's gate wait enabled (a still-pending pod
    re-enters; the provisioning worker dedupes within a batch and re-reads
    provisionability)."""

    REQUEUE_SECONDS = 5.0  # re-verify scheduling after the batch

    def __init__(self, kube: KubeCore, provisioning_controller):
        self.kube = kube
        self.provisioning = provisioning_controller
        self.preferences = Preferences()
        self.volume_topology = VolumeTopology(kube)

    def kind(self) -> str:
        return "Pod"

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        # no-copy provisionability probe first
        try:
            if not self.kube.read("Pod", name, namespace, is_provisionable):
                return None
        except NotFound:
            return None
        # already awaiting a batch window? Skip the relax/validate/select
        # repeat — the window's consumption clears the key, so the NEXT
        # requeue performs the full post-batch re-verification
        key = (namespace, name)
        if any(w.pending(key) for w in list(self.provisioning.workers.values())):
            return self._requeue_seconds(key)
        try:
            pod = self.kube.get("Pod", name, namespace)
        except NotFound:
            return None
        if not is_provisionable(pod):
            return None
        err = validate(pod)
        if err is not None:
            log.debug("ignoring pod %s: %s", name, err)
            return None
        err = self._select_provisioner(pod)
        if err is not None:
            log.debug("could not schedule pod %s: %s", name, err)
        return self._requeue_seconds(key)

    def _requeue_seconds(self, key=None) -> float:
        """Pressure-aware requeue backoff (2× at L2, 4× at L3), jittered
        per pod (±25%, deterministic in the pod key) so a mass shed's
        retries do not re-enter intake on one tick."""
        level = int(get_monitor().level())
        if level >= 3:
            base = self.REQUEUE_SECONDS * 4
        elif level >= 2:
            base = self.REQUEUE_SECONDS * 2
        else:
            base = self.REQUEUE_SECONDS
        return base * requeue_jitter(key)

    def _select_provisioner(self, pod: Pod) -> Optional[str]:
        """controller.go:84-111: relax → volume topology → first matching
        provisioner → enqueue."""
        self.preferences.relax(pod)
        try:
            self.volume_topology.inject(pod)
        except NotFound as e:
            return f"getting volume topology requirements: {e}"
        targets = self.provisioning.targets()
        if not targets:
            return None
        errs = []
        chosen = chosen_worker = None
        for provisioner, worker in targets:
            err = feasibility.validate_pod_fast(provisioner.spec.constraints, pod)
            if err is None:
                chosen, chosen_worker = provisioner, worker
                break
            errs.append(f"tried provisioner/{provisioner.metadata.name}: {err}")
        if chosen is None:
            return f"matched 0/{len(errs)} provisioners: " + "; ".join(errs)
        gate = chosen_worker.add(pod, key=(pod.metadata.namespace, pod.metadata.name),
                                 provisioner=chosen.metadata.name)
        if gate is None:
            # shed at admission (pressure level or depth bound), already
            # counted by the batcher; the requeue retries once pressure
            # falls. It still burns the band's error budget: a shed pod
            # produces no latency sample, which would leave the burn
            # sentinel blind to the overload it exists to catch
            slo.note_shed(classify(pod)[0])
            return f"shed at intake by provisioner/{chosen.metadata.name} (pressure)"
        return None
