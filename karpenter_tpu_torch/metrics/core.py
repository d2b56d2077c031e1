"""Help text for metrics whose call sites create them lazily.

Several hot paths create series through ``HISTOGRAMS.time(name, ...)``
or ``registry.gauge(name)`` with no help string (the reference's
constants.go carried the help separately). The registry attaches help
order-independently (`Registry._get_or_create` upgrades an empty help),
so pre-registering here — imported via ``karpenter_tpu_torch.metrics`` — is
enough for ``expose()`` to render ``# HELP`` for every series. The names
and help text are the JAX package's, letter for letter.

Any NEW lazily-created metric must be added here.
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT, Registry

GAUGE_HELP = {
    "nodes_allocatable": "Node allocatable capacity by resource type.",
    "nodes_total_pod_requests":
        "Sum of resource requests of non-daemon pods on the node.",
    "nodes_total_pod_limits":
        "Sum of resource limits of non-daemon pods on the node.",
    "nodes_total_daemon_requests":
        "Sum of resource requests of daemonset pods on the node.",
    "nodes_total_daemon_limits":
        "Sum of resource limits of daemonset pods on the node.",
    "nodes_system_overhead":
        "Node capacity minus allocatable (system/kubelet reservation).",
    "pods_state":
        "One series per known pod with its placement labels and phase.",
}

HISTOGRAM_HELP = {
    "scheduling_duration_seconds":
        "Wall time of one scheduler feasibility pass per provisioner.",
    "binpacking_duration_seconds":
        "Wall time of the bin-packing solve per provisioner.",
    "bind_duration_seconds":
        "Wall time from node create to all chunk pods bound.",
    "cloudprovider_duration_seconds":
        "Latency of cloud-provider API methods by method/provider.",
}


def register(reg: Registry = DEFAULT) -> None:
    for name, help_ in GAUGE_HELP.items():
        reg.gauge(name, help_)
    for name, help_ in HISTOGRAM_HELP.items():
        reg.histogram(name, help_)


register()
