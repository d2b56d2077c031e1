"""Launch template provider: hash-named ensure-or-create + EKS bootstrap
userData generation.

A copy of the JAX package's module (reference:
pkg/cloudprovider/aws/launchtemplate.go). The template name is a
stable hash of everything that affects the booted node, so equivalent
constraints converge on one EC2 LaunchTemplate (launchtemplate.go:64-85);
userData is built deterministically (sorted labels/taints) for the same
reason (launchtemplate.go:229-246).
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import threading
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.cloudprovider.aws.discovery import AMIProvider, SecurityGroupProvider
from karpenter_tpu_torch.cloudprovider.aws.vendor import AWSProvider
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.utils.cache import TTLCache

log = logging.getLogger("karpenter.aws.launchtemplate")

LAUNCH_TEMPLATE_NAME_FORMAT = "Karpenter-{cluster}-{hash}"


def needs_docker(instance_types: List[InstanceType]) -> bool:
    """GPU/Neuron instances can't use containerd directly
    (launchtemplate.go:163-172)."""
    return any(
        not it.aws_neurons.is_zero() or not it.nvidia_gpus.is_zero()
        for it in instance_types)


def launch_template_name(options: Dict[str, object]) -> str:
    """Deterministic name from the hashed option struct
    (launchtemplate.go:64-70)."""
    digest = hashlib.sha256(
        json.dumps(options, sort_keys=True, default=str).encode()).hexdigest()[:16]
    return LAUNCH_TEMPLATE_NAME_FORMAT.format(
        cluster=options["ClusterName"], hash=digest)


class LaunchTemplateProvider:
    def __init__(
        self,
        ec2api: sdk.EC2API,
        ami_provider: AMIProvider,
        security_group_provider: SecurityGroupProvider,
        cluster_name: str,
        cluster_endpoint: str,
        ca_bundle: Optional[Callable[[], Optional[str]]] = None,
        eni_limited_pod_density: bool = True,
    ):
        self.ec2api = ec2api
        self.ami_provider = ami_provider
        self.security_group_provider = security_group_provider
        self.cluster_name = cluster_name
        self.cluster_endpoint = cluster_endpoint
        self.ca_bundle = ca_bundle or (lambda: None)
        self.eni_limited_pod_density = eni_limited_pod_density
        self._cache = TTLCache(60.0)
        self._lock = threading.Lock()

    def get(
        self,
        constraints: Constraints,
        provider: AWSProvider,
        instance_types: List[InstanceType],
        additional_labels: Dict[str, str],
    ) -> Dict[str, List[InstanceType]]:
        """launch template name → instance types using it
        (launchtemplate.go:88-126). AMI may differ per architecture/
        accelerator, hence the grouping."""
        if provider.launch_template is not None:
            return {provider.launch_template: list(instance_types)}
        security_group_ids = self.security_group_provider.get(provider)
        launch_templates: Dict[str, List[InstanceType]] = {}
        for ami_id, its in self.ami_provider.get(instance_types).items():
            user_data = self._user_data(constraints, its, additional_labels)
            template = self._ensure(
                {
                    "UserData": user_data,
                    "ClusterName": self.cluster_name,
                    "InstanceProfile": provider.instance_profile,
                    "AMIID": ami_id,
                    "SecurityGroupsIds": sorted(security_group_ids),
                    "Tags": dict(sorted(provider.tags.items())),
                    "MetadataOptions": provider.get_metadata_options(),
                })
            launch_templates[template.launch_template_name] = its
        return launch_templates

    def _ensure(self, options: Dict[str, object]) -> sdk.LaunchTemplate:
        """Cache → Describe → Create, single-flighted (launchtemplate.go:128-160)."""
        with self._lock:
            name = launch_template_name(options)
            cached = self._cache.get(name)
            if cached is not None:
                return cached
            existing = self.ec2api.describe_launch_templates([name])
            if existing:
                log.debug("Discovered launch template %s", name)
                template = existing[0]
            else:
                template = self.ec2api.create_launch_template(sdk.LaunchTemplate(
                    launch_template_name=name,
                    user_data=str(options["UserData"]),
                    image_id=str(options["AMIID"]),
                    instance_profile=str(options["InstanceProfile"]),
                    security_group_ids=list(options["SecurityGroupsIds"]),
                    metadata_options=dict(options["MetadataOptions"]),
                    tags=dict(options["Tags"]),
                ))
                log.debug("Created launch template, %s", name)
            self._cache.set(name, template)
            return template

    # -- userData (launchtemplate.go:229-296) -------------------------------
    def _user_data(
        self,
        constraints: Constraints,
        instance_types: List[InstanceType],
        additional_labels: Dict[str, str],
    ) -> str:
        container_runtime = "" if needs_docker(instance_types) else " --container-runtime containerd"
        lines = [
            "#!/bin/bash -xe",
            "exec > >(tee /var/log/user-data.log|logger -t user-data -s 2>/dev/console) 2>&1",
            f"/etc/eks/bootstrap.sh '{self.cluster_name}'{container_runtime} \\",
            f"    --apiserver-endpoint '{self.cluster_endpoint}'",
        ]
        ca = self.ca_bundle()
        if ca is not None:
            lines[-1] += " \\"
            lines.append(f"    --b64-cluster-ca '{ca}'")

        kubelet_extra = " ".join(filter(None, [
            self._node_label_args({**additional_labels, **constraints.labels}),
            self._node_taint_args(constraints),
        ]))
        if not self.eni_limited_pod_density:
            lines[-1] += " \\"
            lines.append("    --use-max-pods=false")
            kubelet_extra = (kubelet_extra + " --max-pods=110").strip()
        if kubelet_extra:
            lines[-1] += " \\"
            lines.append(f"    --kubelet-extra-args '{kubelet_extra}'")
        if constraints.kubelet_configuration.cluster_dns:
            lines[-1] += " \\"
            lines.append(
                f"    --dns-cluster-ip '{constraints.kubelet_configuration.cluster_dns[0]}'")
        return base64.b64encode("\n".join(lines).encode()).decode()

    @staticmethod
    def _node_label_args(labels: Dict[str, str]) -> str:
        """Sorted --node-labels, skipping allowed-domain labels the kubelet
        may not self-apply (launchtemplate.go:298-313)."""
        items = [
            f"{k}={v}" for k, v in sorted(labels.items())
            if k not in wellknown.ALLOWED_LABEL_DOMAINS
        ]
        return f"--node-labels={','.join(items)}" if items else ""

    @staticmethod
    def _node_taint_args(constraints: Constraints) -> str:
        """Sorted --register-with-taints (launchtemplate.go:315-332)."""
        if not constraints.taints:
            return ""
        sorted_taints = sorted(
            constraints.taints, key=lambda t: (t.key, t.value, t.effect))
        return "--register-with-taints=" + ",".join(
            f"{t.key}={t.value}:{t.effect}" for t in sorted_taints)
