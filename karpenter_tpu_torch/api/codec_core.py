"""Core-object JSON codec: Kubernetes API JSON to the port's dataclasses
and back.

A copy of the JAX package's module, used by the API client
(runtime/kubeclient.py) and the stub API server (runtime/stubserver.py);
the Provisioner CRD has its own codec (api/codec.py). It decodes the subset
of core/v1, apps/v1, coordination.k8s.io/v1 and storage.k8s.io/v1 fields
the controllers read and encodes everything they write. Unknown fields are
dropped on decode. Encoders emit OWNED fields (the ones controllers mutate:
labels, annotations, finalizers, taints, unschedulable, ...)
unconditionally, even when empty, and omit unmodeled ones; the client's
read-merge-write (kubeclient._merge) then overlays exactly the owned fields
onto the server's raw JSON, so foreign and server-owned fields are never
erased while the removal of an owned field (a finalizer strip) still
round-trips.

As in the JAX package, pod (anti-)affinity is decoded (required terms
only) but not encoded: an object written through the client loses it.

Reference shapes: k8s core/v1 (Pod, Node, ConfigMap, Secret, PVC, PV),
apps/v1 (DaemonSet), storage.k8s.io/v1 (StorageClass).
"""

from __future__ import annotations

import calendar
import time
from typing import Any, Dict, Optional

from karpenter_tpu_torch.api.core import (
    Affinity, ConfigMap, Container, DaemonSet, DaemonSetSpec, LabelSelector,
    Lease, LeaseSpec,
    Node, NodeAffinity, NodeCondition, NodeSelectorRequirement,
    NodeSelectorTerm, NodeSpec, NodeStatus, ObjectMeta, OwnerReference,
    PersistentVolume, PersistentVolumeClaim, PersistentVolumeClaimSpec,
    PersistentVolumeClaimVolumeSource, PersistentVolumeSpec, Pod, PodAffinity,
    PodAffinityTerm, PodCondition, PodSpec, PodStatus, PodTemplateSpec,
    PreferredSchedulingTerm, ResourceRequirements, Secret, StorageClass, Taint,
    Toleration, TopologySelectorTerm, TopologySpreadConstraint, Volume,
    VolumeNodeAffinity,
)
from karpenter_tpu_torch.utils.resources import parse_resource_list

RFC3339 = "%Y-%m-%dT%H:%M:%SZ"


def ts_from(s: Optional[str]) -> Optional[float]:
    if not s:
        return None
    return float(calendar.timegm(time.strptime(s.split(".")[0].rstrip("Z") + "Z",
                                               RFC3339)))


def ts_to(t: Optional[float]) -> Optional[str]:
    if t is None:
        return None
    return time.strftime(RFC3339, time.gmtime(t))


# -- metadata ---------------------------------------------------------------

def meta_from(m: Dict[str, Any]) -> ObjectMeta:
    return ObjectMeta(
        name=m.get("name", ""),
        namespace=m.get("namespace", "default"),
        labels=dict(m.get("labels") or {}),
        annotations=dict(m.get("annotations") or {}),
        finalizers=list(m.get("finalizers") or []),
        owner_references=[
            OwnerReference(kind=o.get("kind", ""), name=o.get("name", ""),
                           controller=bool(o.get("controller")),
                           api_version=o.get("apiVersion", ""),
                           uid=o.get("uid", ""))
            for o in (m.get("ownerReferences") or [])
        ],
        deletion_timestamp=ts_from(m.get("deletionTimestamp")),
        creation_timestamp=ts_from(m.get("creationTimestamp")),
        resource_version=int(m.get("resourceVersion") or 0),
        uid=m.get("uid", ""),
    )


def meta_to(meta: ObjectMeta, cluster_scoped: bool = False) -> Dict[str, Any]:
    # labels/annotations/finalizers are OWNED fields: always emitted (even
    # empty) so the client's read-merge-write can express their removal —
    # an omitted key would be indistinguishable from "unmodeled, preserve"
    out: Dict[str, Any] = {
        "name": meta.name,
        "labels": dict(meta.labels),
        "annotations": dict(meta.annotations),
        "finalizers": list(meta.finalizers),
    }
    if not cluster_scoped:
        out["namespace"] = meta.namespace or "default"
    if meta.owner_references:
        # apiVersion/uid round-trip verbatim from decode — the server's
        # copy is authoritative (uid is REQUIRED server-side; inventing it
        # would make every update() of an owned object invalid). The
        # kind-based apiVersion guess remains only for locally-built refs
        # (tests/fixtures) that never hit a real API server.
        out["ownerReferences"] = [
            {"kind": o.kind, "name": o.name, "controller": o.controller,
             "apiVersion": o.api_version or (
                 "apps/v1" if o.kind == "DaemonSet" else "v1"),
             **({"uid": o.uid} if o.uid else {})}
            for o in meta.owner_references
        ]
    if meta.resource_version:
        out["resourceVersion"] = str(meta.resource_version)
    if meta.uid:
        out["uid"] = meta.uid
    return out


# -- shared fragments -------------------------------------------------------

def _req_from(r: Dict[str, Any]) -> NodeSelectorRequirement:
    return NodeSelectorRequirement(key=r.get("key", ""),
                                   operator=r.get("operator", "In"),
                                   values=list(r.get("values") or []))


def _req_to(r: NodeSelectorRequirement) -> Dict[str, Any]:
    return {"key": r.key, "operator": r.operator, "values": list(r.values)}


def _term_from(t: Dict[str, Any]) -> NodeSelectorTerm:
    return NodeSelectorTerm(
        match_expressions=[_req_from(r) for r in (t.get("matchExpressions") or [])],
        match_fields=[_req_from(r) for r in (t.get("matchFields") or [])],
    )


def _term_to(t: NodeSelectorTerm) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if t.match_expressions:
        out["matchExpressions"] = [_req_to(r) for r in t.match_expressions]
    if t.match_fields:
        out["matchFields"] = [_req_to(r) for r in t.match_fields]
    return out


def _selector_from(s: Optional[Dict[str, Any]]) -> Optional[LabelSelector]:
    if s is None:
        return None
    return LabelSelector(
        match_labels=dict(s.get("matchLabels") or {}),
        match_expressions=[_req_from(r) for r in (s.get("matchExpressions") or [])],
    )


def _selector_to(s: Optional[LabelSelector]) -> Optional[Dict[str, Any]]:
    if s is None:
        return None
    out: Dict[str, Any] = {}
    if s.match_labels:
        out["matchLabels"] = dict(s.match_labels)
    if s.match_expressions:
        out["matchExpressions"] = [_req_to(r) for r in s.match_expressions]
    return out


def _affinity_from(a: Optional[Dict[str, Any]]) -> Optional[Affinity]:
    if a is None:
        return None
    na = a.get("nodeAffinity")
    node_affinity = None
    if na is not None:
        required = na.get("requiredDuringSchedulingIgnoredDuringExecution")
        node_affinity = NodeAffinity(
            required=[_term_from(t) for t in required.get("nodeSelectorTerms") or []]
            if required else None,
            preferred=[
                PreferredSchedulingTerm(weight=int(p.get("weight", 1)),
                                        preference=_term_from(p.get("preference") or {}))
                for p in (na.get("preferredDuringSchedulingIgnoredDuringExecution") or [])
            ],
        )
    # pod (anti-)affinity: the required terms only, as in the JAX package
    def pa_from(block):
        if block is None:
            return None
        return PodAffinity(required=[
            PodAffinityTerm(topology_key=t.get("topologyKey", ""),
                            label_selector=_selector_from(t.get("labelSelector")))
            for t in (block.get("requiredDuringSchedulingIgnoredDuringExecution") or [])
        ])

    return Affinity(node_affinity=node_affinity,
                    pod_affinity=pa_from(a.get("podAffinity")),
                    pod_anti_affinity=pa_from(a.get("podAntiAffinity")))


def _affinity_to(a: Optional[Affinity]) -> Optional[Dict[str, Any]]:
    if a is None or a.node_affinity is None:
        return None
    na = a.node_affinity
    out: Dict[str, Any] = {}
    if na.required is not None:
        out["requiredDuringSchedulingIgnoredDuringExecution"] = {
            "nodeSelectorTerms": [_term_to(t) for t in na.required]}
    if na.preferred:
        out["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": p.weight, "preference": _term_to(p.preference)}
            for p in na.preferred
        ]
    return {"nodeAffinity": out}


def _resources_from(r: Optional[Dict[str, Any]]) -> ResourceRequirements:
    r = r or {}
    return ResourceRequirements(
        requests=parse_resource_list({k: str(v) for k, v in (r.get("requests") or {}).items()}),
        limits=parse_resource_list({k: str(v) for k, v in (r.get("limits") or {}).items()}),
    )


def _resources_to(r: ResourceRequirements) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if r.requests:
        out["requests"] = {k: str(q) for k, q in r.requests.items()}
    if r.limits:
        out["limits"] = {k: str(q) for k, q in r.limits.items()}
    return out


def _taint_from(t: Dict[str, Any]) -> Taint:
    return Taint(key=t.get("key", ""), value=t.get("value", ""),
                 effect=t.get("effect", "NoSchedule"))


def _taint_to(t: Taint) -> Dict[str, Any]:
    out = {"key": t.key, "effect": t.effect}
    if t.value:
        out["value"] = t.value
    return out


# -- Pod --------------------------------------------------------------------

def pod_spec_from(s: Dict[str, Any]) -> PodSpec:
    return PodSpec(
        node_name=s.get("nodeName", ""),
        node_selector=dict(s.get("nodeSelector") or {}),
        containers=[
            Container(name=c.get("name", "app"), image=c.get("image", ""),
                      resources=_resources_from(c.get("resources")))
            for c in (s.get("containers") or [])
        ],
        tolerations=[
            Toleration(key=t.get("key", ""), operator=t.get("operator", "Equal"),
                       value=t.get("value", ""), effect=t.get("effect", ""))
            for t in (s.get("tolerations") or [])
        ],
        affinity=_affinity_from(s.get("affinity")),
        topology_spread_constraints=[
            TopologySpreadConstraint(
                max_skew=int(c.get("maxSkew", 1)),
                topology_key=c.get("topologyKey", ""),
                when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
                label_selector=_selector_from(c.get("labelSelector")))
            for c in (s.get("topologySpreadConstraints") or [])
        ],
        volumes=[
            Volume(name=v.get("name", ""),
                   persistent_volume_claim=PersistentVolumeClaimVolumeSource(
                       claim_name=v["persistentVolumeClaim"].get("claimName", ""))
                   if v.get("persistentVolumeClaim") else None)
            for v in (s.get("volumes") or [])
        ],
        priority_class_name=s.get("priorityClassName", ""),
        priority=int(s.get("priority", 0) or 0),
        preemption_policy=s.get("preemptionPolicy", "PreemptLowerPriority"),
        # 0 is a valid, explicit "delete immediately" — only None defaults
        termination_grace_period_seconds=(
            30 if s.get("terminationGracePeriodSeconds") is None
            else int(s["terminationGracePeriodSeconds"])),
    )


def pod_spec_to(s: PodSpec) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if s.node_name:
        out["nodeName"] = s.node_name
    if s.node_selector:
        out["nodeSelector"] = dict(s.node_selector)
    if s.containers:
        out["containers"] = [
            {"name": c.name, **({"image": c.image} if c.image else {}),
             "resources": _resources_to(c.resources)}
            for c in s.containers
        ]
    if s.tolerations:
        out["tolerations"] = [
            {k: v for k, v in (("key", t.key), ("operator", t.operator),
                               ("value", t.value), ("effect", t.effect)) if v}
            for t in s.tolerations
        ]
    aff = _affinity_to(s.affinity)
    if aff:
        out["affinity"] = aff
    if s.topology_spread_constraints:
        out["topologySpreadConstraints"] = [
            {"maxSkew": c.max_skew, "topologyKey": c.topology_key,
             "whenUnsatisfiable": c.when_unsatisfiable,
             **({"labelSelector": _selector_to(c.label_selector)}
                if c.label_selector else {})}
            for c in s.topology_spread_constraints
        ]
    if s.volumes:
        out["volumes"] = [
            {"name": v.name,
             **({"persistentVolumeClaim": {"claimName": v.persistent_volume_claim.claim_name}}
                if v.persistent_volume_claim else {})}
            for v in s.volumes
        ]
    if s.priority_class_name:
        out["priorityClassName"] = s.priority_class_name
    if s.priority:
        out["priority"] = s.priority
    out["terminationGracePeriodSeconds"] = s.termination_grace_period_seconds
    return out


def pod_from(obj: Dict[str, Any]) -> Pod:
    status = obj.get("status") or {}
    pod = Pod(
        metadata=meta_from(obj.get("metadata") or {}),
        spec=pod_spec_from(obj.get("spec") or {}),
        status=PodStatus(
            phase=status.get("phase", "Pending"),
            conditions=[
                PodCondition(type=c.get("type", ""), status=c.get("status", ""),
                             reason=c.get("reason", ""))
                for c in (status.get("conditions") or [])
            ],
            nominated_node_name=status.get("nominatedNodeName", ""),
        ),
    )
    # prime the solver's marshal cache at ingest: the codec touches every
    # pod once per watch event, so the per-pod resource vector is computed
    # here, off the solve path
    from karpenter_tpu_torch.solver.adapter import pod_vector

    pod_vector(pod)
    return pod


def pod_to(p: Pod) -> Dict[str, Any]:
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": meta_to(p.metadata),
        "spec": pod_spec_to(p.spec),
        "status": {
            "phase": p.status.phase,
            **({"conditions": [
                {"type": c.type, "status": c.status,
                 **({"reason": c.reason} if c.reason else {})}
                for c in p.status.conditions]} if p.status.conditions else {}),
        },
    }


# -- Node -------------------------------------------------------------------

def node_from(obj: Dict[str, Any]) -> Node:
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    return Node(
        metadata=meta_from(obj.get("metadata") or {}),
        spec=NodeSpec(
            taints=[_taint_from(t) for t in (spec.get("taints") or [])],
            unschedulable=bool(spec.get("unschedulable")),
            provider_id=spec.get("providerID", ""),
        ),
        status=NodeStatus(
            capacity=parse_resource_list(
                {k: str(v) for k, v in (status.get("capacity") or {}).items()}),
            allocatable=parse_resource_list(
                {k: str(v) for k, v in (status.get("allocatable") or {}).items()}),
            conditions=[
                NodeCondition(type=c.get("type", ""), status=c.get("status", "Unknown"),
                              reason=c.get("reason", ""),
                              last_heartbeat_time=ts_from(c.get("lastHeartbeatTime")))
                for c in (status.get("conditions") or [])
            ],
        ),
    )


def node_to(n: Node) -> Dict[str, Any]:
    status: Dict[str, Any] = {}
    if n.status.capacity:
        status["capacity"] = {k: str(q) for k, q in n.status.capacity.items()}
    if n.status.allocatable:
        status["allocatable"] = {k: str(q) for k, q in n.status.allocatable.items()}
    if n.status.conditions:
        status["conditions"] = [
            {"type": c.type, "status": c.status,
             **({"reason": c.reason} if c.reason else {}),
             **({"lastHeartbeatTime": ts_to(c.last_heartbeat_time)}
                if c.last_heartbeat_time else {})}
            for c in n.status.conditions
        ]
    # taints/unschedulable are owned (cordon + not-ready lifecycle): always
    # emitted so removal survives the read-merge-write
    spec: Dict[str, Any] = {
        "taints": [_taint_to(t) for t in n.spec.taints],
        "unschedulable": n.spec.unschedulable,
    }
    if n.spec.provider_id:
        spec["providerID"] = n.spec.provider_id
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": meta_to(n.metadata, cluster_scoped=True),
            "spec": spec, "status": status}


# -- other kinds ------------------------------------------------------------

def daemonset_from(obj: Dict[str, Any]) -> DaemonSet:
    template = ((obj.get("spec") or {}).get("template") or {})
    return DaemonSet(
        metadata=meta_from(obj.get("metadata") or {}),
        spec=DaemonSetSpec(template=PodTemplateSpec(
            metadata=meta_from(template.get("metadata") or {}),
            spec=pod_spec_from(template.get("spec") or {}))),
    )


def configmap_from(obj: Dict[str, Any]) -> ConfigMap:
    return ConfigMap(metadata=meta_from(obj.get("metadata") or {}),
                     data=dict(obj.get("data") or {}))


def configmap_to(cm: ConfigMap) -> Dict[str, Any]:
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": meta_to(cm.metadata), "data": dict(cm.data)}


def secret_from(obj: Dict[str, Any]) -> Secret:
    return Secret(metadata=meta_from(obj.get("metadata") or {}),
                  data=dict(obj.get("data") or {}),
                  type=obj.get("type", "Opaque"))


def secret_to(s: Secret) -> Dict[str, Any]:
    return {"apiVersion": "v1", "kind": "Secret", "type": s.type,
            "metadata": meta_to(s.metadata), "data": dict(s.data)}


def lease_from(obj: Dict[str, Any]) -> Lease:
    spec = obj.get("spec") or {}
    return Lease(
        metadata=meta_from(obj.get("metadata") or {}),
        spec=LeaseSpec(
            holder_identity=spec.get("holderIdentity", "") or "",
            lease_duration_seconds=int(spec.get("leaseDurationSeconds") or 15),
            acquire_time=ts_from(spec.get("acquireTime")),
            renew_time=ts_from(spec.get("renewTime"))),
    )


def lease_to(lease: Lease) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "holderIdentity": lease.spec.holder_identity,
        "leaseDurationSeconds": lease.spec.lease_duration_seconds,
    }
    if lease.spec.acquire_time is not None:
        spec["acquireTime"] = ts_to(lease.spec.acquire_time)
    if lease.spec.renew_time is not None:
        spec["renewTime"] = ts_to(lease.spec.renew_time)
    else:
        spec["renewTime"] = None  # owned: an explicit release must round-trip
    return {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": meta_to(lease.metadata), "spec": spec}


def pvc_from(obj: Dict[str, Any]) -> PersistentVolumeClaim:
    spec = obj.get("spec") or {}
    return PersistentVolumeClaim(
        metadata=meta_from(obj.get("metadata") or {}),
        spec=PersistentVolumeClaimSpec(
            storage_class_name=spec.get("storageClassName"),
            volume_name=spec.get("volumeName", "")),
    )


def pvc_to(pvc: PersistentVolumeClaim) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if pvc.spec.storage_class_name is not None:
        spec["storageClassName"] = pvc.spec.storage_class_name
    if pvc.spec.volume_name:
        spec["volumeName"] = pvc.spec.volume_name
    return {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
            "metadata": meta_to(pvc.metadata), "spec": spec}


def daemonset_to(ds: DaemonSet) -> Dict[str, Any]:
    return {"apiVersion": "apps/v1", "kind": "DaemonSet",
            "metadata": meta_to(ds.metadata),
            "spec": {"template": {
                "metadata": meta_to(ds.spec.template.metadata),
                "spec": pod_spec_to(ds.spec.template.spec)}}}


def pv_to(pv: PersistentVolume) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if pv.spec.node_affinity is not None and pv.spec.node_affinity.required:
        spec["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
            _term_to(t) for t in pv.spec.node_affinity.required]}}
    return {"apiVersion": "v1", "kind": "PersistentVolume",
            "metadata": meta_to(pv.metadata, cluster_scoped=True), "spec": spec}


def storageclass_to(sc: StorageClass) -> Dict[str, Any]:
    return {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
            "metadata": meta_to(sc.metadata, cluster_scoped=True),
            "allowedTopologies": [
                {"matchLabelExpressions": [
                    {"key": e.key, "values": list(e.values)}
                    for e in t.match_label_expressions]}
                for t in sc.allowed_topologies]}


def pv_from(obj: Dict[str, Any]) -> PersistentVolume:
    spec = obj.get("spec") or {}
    na = spec.get("nodeAffinity")
    return PersistentVolume(
        metadata=meta_from(obj.get("metadata") or {}),
        spec=PersistentVolumeSpec(node_affinity=VolumeNodeAffinity(
            required=[_term_from(t) for t in
                      (na.get("required") or {}).get("nodeSelectorTerms") or []])
            if na else None),
    )


def storageclass_from(obj: Dict[str, Any]) -> StorageClass:
    return StorageClass(
        metadata=meta_from(obj.get("metadata") or {}),
        allowed_topologies=[
            TopologySelectorTerm(match_label_expressions=[
                NodeSelectorRequirement(key=e.get("key", ""), operator="In",
                                        values=list(e.get("values") or []))
                for e in (t.get("matchLabelExpressions") or [])
            ])
            for t in (obj.get("allowedTopologies") or [])
        ],
    )


# -- dispatch ---------------------------------------------------------------

DECODERS = {
    "Secret": secret_from,
    "Lease": lease_from,
    "Pod": pod_from,
    "Node": node_from,
    "DaemonSet": daemonset_from,
    "ConfigMap": configmap_from,
    "PersistentVolumeClaim": pvc_from,
    "PersistentVolume": pv_from,
    "StorageClass": storageclass_from,
}

ENCODERS = {
    "Secret": secret_to,
    "Lease": lease_to,
    "Pod": pod_to,
    "Node": node_to,
    "ConfigMap": configmap_to,
    "PersistentVolumeClaim": pvc_to,
    "DaemonSet": daemonset_to,
    "PersistentVolume": pv_to,
    "StorageClass": storageclass_to,
}


def decode(kind: str, obj: Dict[str, Any]):
    out = DECODERS[kind](obj)
    if kind == "Node":
        # cluster-scoped; the framework's store convention is namespace ""
        out.metadata.namespace = ""
    return out


def encode_obj(obj) -> Dict[str, Any]:
    return ENCODERS[obj.kind](obj)
