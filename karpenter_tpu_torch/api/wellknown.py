"""Well-known labels, annotations and domains.

Reference: pkg/apis/provisioning/v1alpha5/{requirements.go:24-71,register.go:43-47}.
"""

from __future__ import annotations

# k8s node labels
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"
LABEL_HOSTNAME = "kubernetes.io/hostname"

# legacy/beta aliases
LABEL_FAILURE_DOMAIN_BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_BETA_ARCH = "beta.kubernetes.io/arch"
LABEL_BETA_OS = "beta.kubernetes.io/os"
LABEL_BETA_INSTANCE_TYPE = "beta.kubernetes.io/instance-type"

# karpenter domain (register.go:43-47)
KARPENTER_DOMAIN = "karpenter.sh"
PROVISIONER_NAME_LABEL = KARPENTER_DOMAIN + "/provisioner-name"
NOT_READY_TAINT_KEY = KARPENTER_DOMAIN + "/not-ready"
DO_NOT_EVICT_ANNOTATION = KARPENTER_DOMAIN + "/do-not-evict"
EMPTINESS_TIMESTAMP_ANNOTATION = KARPENTER_DOMAIN + "/emptiness-timestamp"
TERMINATION_FINALIZER = KARPENTER_DOMAIN + "/termination"
LABEL_CAPACITY_TYPE = KARPENTER_DOMAIN + "/capacity-type"
# provider tag stamped at launch (before any Node exists) so a leaked
# instance is attributable to the launch that leaked it
LAUNCH_NONCE_TAG = KARPENTER_DOMAIN + "/launch-nonce"
# operator-defined placement domain (a topology key for pod affinity); kept
# well-known so tighten() keeps its pin, as in the JAX package
LABEL_NODE_GROUP = KARPENTER_DOMAIN + "/node-group"

CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"

ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
OPERATING_SYSTEM_LINUX = "linux"

# gang (pod-group) labels: pods carrying the same pod-group value (within one
# namespace) bind all-or-nothing; pod-group-size is the full membership
# count, pod-group-slice an optional TPU slice shape (api/gang.py)
POD_GROUP_LABEL = KARPENTER_DOMAIN + "/pod-group"
POD_GROUP_SIZE_LABEL = KARPENTER_DOMAIN + "/pod-group-size"
POD_GROUP_SLICE_LABEL = KARPENTER_DOMAIN + "/pod-group-slice"

WELL_KNOWN_LABELS = frozenset({
    LABEL_TOPOLOGY_ZONE,
    LABEL_INSTANCE_TYPE,
    LABEL_ARCH,
    LABEL_OS,
    LABEL_CAPACITY_TYPE,
    LABEL_HOSTNAME,  # used internally for hostname topology spread
    LABEL_NODE_GROUP,
})

# NormalizedLabels (requirements.go:65-70): aliased concepts → well-known
NORMALIZED_LABELS = {
    LABEL_FAILURE_DOMAIN_BETA_ZONE: LABEL_TOPOLOGY_ZONE,
    LABEL_BETA_ARCH: LABEL_ARCH,
    LABEL_BETA_OS: LABEL_OS,
    LABEL_BETA_INSTANCE_TYPE: LABEL_INSTANCE_TYPE,
}

# restricted label machinery (requirements.go:29-50), read by the admission
# webhook's label checks (webhooks/admission.py)
RESTRICTED_LABELS = frozenset({EMPTINESS_TIMESTAMP_ANNOTATION, LABEL_HOSTNAME})
ALLOWED_LABEL_DOMAINS = frozenset({"kops.k8s.io"})
RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", KARPENTER_DOMAIN})
