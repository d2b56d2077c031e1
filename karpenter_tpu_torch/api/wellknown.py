"""Well-known labels, annotations and domains.

Reference: pkg/apis/provisioning/v1alpha5/{requirements.go:24-71,register.go:43-47}.
"""

from __future__ import annotations

# k8s node labels
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"

# legacy/beta aliases
LABEL_FAILURE_DOMAIN_BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_BETA_ARCH = "beta.kubernetes.io/arch"
LABEL_BETA_OS = "beta.kubernetes.io/os"
LABEL_BETA_INSTANCE_TYPE = "beta.kubernetes.io/instance-type"

# karpenter domain (register.go:43-47)
KARPENTER_DOMAIN = "karpenter.sh"
LABEL_CAPACITY_TYPE = KARPENTER_DOMAIN + "/capacity-type"

CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

# NormalizedLabels (requirements.go:65-70): aliased concepts → well-known
NORMALIZED_LABELS = {
    LABEL_FAILURE_DOMAIN_BETA_ZONE: LABEL_TOPOLOGY_ZONE,
    LABEL_BETA_ARCH: LABEL_ARCH,
    LABEL_BETA_OS: LABEL_OS,
    LABEL_BETA_INSTANCE_TYPE: LABEL_INSTANCE_TYPE,
}
