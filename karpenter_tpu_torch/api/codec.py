"""Provisioner manifest codec: CRD JSON dicts to the port's API dataclasses
and back.

A copy of the JAX package's module. Reference: the v1alpha5 CRD schema and
the Go type JSON tags in pkg/apis/provisioning/v1alpha5/{provisioner.go,
constraints.go}. Used by the admission webhook server (webhooks/server.py)
and the API client (runtime/kubeclient.py).
"""

from __future__ import annotations

from typing import Any, Dict

from karpenter_tpu_torch.api.codec_core import (
    ts_from as codec_core_ts_from, ts_to as codec_core_ts_to,
)
from karpenter_tpu_torch.api.constraints import Constraints, KubeletConfiguration, Limits, Taints
from karpenter_tpu_torch.api.core import NodeSelectorRequirement, ObjectMeta, Taint
from karpenter_tpu_torch.api.provisioner import (
    Condition, Provisioner, ProvisionerSpec, ProvisionerStatus,
)
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.utils.resources import parse_resource_list

API_VERSION = "karpenter.sh/v1alpha5"
KIND = "Provisioner"


def _ts_from_lenient(s):
    """codec_core.ts_from, but a malformed timestamp in a user-supplied
    manifest must not 500 the admission webhook — decode to None instead."""
    try:
        return codec_core_ts_from(s)
    except (ValueError, TypeError, AttributeError):
        return None


def provisioner_from_manifest(manifest: Dict[str, Any]) -> Provisioner:
    """Decode a CRD-shaped dict (what the API server posts to the webhook)."""
    meta = manifest.get("metadata") or {}
    spec = manifest.get("spec") or {}
    constraints = Constraints(
        labels=dict(spec.get("labels") or {}),
        taints=Taints([
            Taint(key=t.get("key", ""), value=t.get("value", ""),
                  effect=t.get("effect", "NoSchedule"))
            for t in (spec.get("taints") or [])
        ]),
        requirements=Requirements([
            NodeSelectorRequirement(
                key=r.get("key", ""), operator=r.get("operator", "In"),
                values=list(r.get("values") or []))
            for r in (spec.get("requirements") or [])
        ]),
        kubelet_configuration=KubeletConfiguration(
            cluster_dns=list((spec.get("kubeletConfiguration") or {})
                             .get("clusterDNS") or [])),
        provider=spec.get("provider"),
    )
    limits_res = (spec.get("limits") or {}).get("resources")
    status = manifest.get("status") or {}
    status_res = status.get("resources") or {}
    return Provisioner(
        status=ProvisionerStatus(
            conditions=[
                Condition(type=c.get("type", ""),
                          status=c.get("status", "Unknown"),
                          reason=c.get("reason", ""),
                          message=c.get("message", ""),
                          last_transition_time=_ts_from_lenient(
                              c.get("lastTransitionTime")))
                for c in (status.get("conditions") or [])
            ],
            resources=parse_resource_list(
                {k: str(v) for k, v in status_res.items()}),
            last_scale_time=_ts_from_lenient(status.get("lastScaleTime")),
        ),
        metadata=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {}),
            uid=meta.get("uid", ""),
        ),
        spec=ProvisionerSpec(
            constraints=constraints,
            ttl_seconds_after_empty=spec.get("ttlSecondsAfterEmpty"),
            ttl_seconds_until_expired=spec.get("ttlSecondsUntilExpired"),
            limits=Limits(resources=parse_resource_list(
                {k: str(v) for k, v in limits_res.items()}) if limits_res else None),
            consolidation_enabled=bool(spec.get("consolidation", {}).get("enabled"))
            if isinstance(spec.get("consolidation"), dict) else False,
        ),
    )


def provisioner_to_manifest(p: Provisioner) -> Dict[str, Any]:
    """Encode back to the CRD shape. Inverse of provisioner_from_manifest for
    every field the CRD declares (round-trip tested)."""
    c = p.spec.constraints
    spec: Dict[str, Any] = {}
    if c.labels:
        spec["labels"] = dict(c.labels)
    if c.taints:
        spec["taints"] = [
            {"key": t.key, **({"value": t.value} if t.value else {}),
             "effect": t.effect}
            for t in c.taints
        ]
    if len(c.requirements):
        # preserve value order: the defaulting webhook diffs original vs
        # round-tripped manifests, and normalizing here would patch every
        # user manifest even when no defaults applied
        spec["requirements"] = [
            {"key": r.key, "operator": r.operator, "values": list(r.values)}
            for r in c.requirements.items
        ]
    if c.kubelet_configuration.cluster_dns:
        spec["kubeletConfiguration"] = {
            "clusterDNS": list(c.kubelet_configuration.cluster_dns)}
    if c.provider is not None:
        spec["provider"] = c.provider
    if p.spec.ttl_seconds_after_empty is not None:
        spec["ttlSecondsAfterEmpty"] = p.spec.ttl_seconds_after_empty
    if p.spec.ttl_seconds_until_expired is not None:
        spec["ttlSecondsUntilExpired"] = p.spec.ttl_seconds_until_expired
    if p.spec.limits.resources:
        spec["limits"] = {"resources": {
            k: str(q) for k, q in p.spec.limits.resources.items()}}
    if p.spec.consolidation_enabled:
        spec["consolidation"] = {"enabled": True}
    manifest: Dict[str, Any] = {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": p.metadata.name},
        "spec": spec,
    }
    # status is ALWAYS emitted, empty lists/maps included: _merge's removal
    # contract is "owned fields always present, even when empty", so
    # clearing the last condition or the resources map must be expressible
    manifest["status"] = {
        "conditions": [
            {"type": c.type, "status": c.status,
             **({"reason": c.reason} if c.reason else {}),
             **({"message": c.message} if c.message else {}),
             **({"lastTransitionTime": codec_core_ts_to(
                 c.last_transition_time)}
                if c.last_transition_time is not None else {})}
            for c in p.status.conditions
        ],
        "resources": {k: str(q) for k, q in p.status.resources.items()},
    }
    if p.status.last_scale_time is not None:
        # scalar + volatile: emitted when set (reference omitempty,
        # provisioner_status.go:27) — unlike the owned list/map fields
        # above, absence means "unset", not "cleared"
        manifest["status"]["lastScaleTime"] = codec_core_ts_to(
            p.status.last_scale_time)
    meta = manifest["metadata"]
    if p.metadata.namespace and p.metadata.namespace != "default":
        meta["namespace"] = p.metadata.namespace
    if p.metadata.labels:
        meta["labels"] = dict(p.metadata.labels)
    if p.metadata.annotations:
        meta["annotations"] = dict(p.metadata.annotations)
    if p.metadata.uid:
        meta["uid"] = p.metadata.uid
    return manifest
