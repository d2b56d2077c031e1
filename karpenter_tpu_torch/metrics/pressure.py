"""Metrics for the brownout subsystem (karpenter_tpu_torch/pressure/).

Five series, all on the process-wide registry (exposed with the
``karpenter_`` prefix by registry.expose()):

- ``karpenter_pressure_level``             gauge — the current ladder rung
  (0=L0 normal … 3=L3 system-critical-only)
- ``karpenter_pods_shed_total``            counter, ``reason`` ×
  ``priority_band`` labels — every admission the intake refused
  (reason: pressure-l2 | pressure-l3 | depth-bound | displaced)
- ``karpenter_intake_queue_depth``         gauge — items awaiting a batch
  window, summed across all provisioner batchers
- ``karpenter_window_splits_total``        counter — oversized windows the
  provisioning loop split at L1+ to bound solve p99
- ``karpenter_kube_client_throttle_seconds`` histogram — time requests
  spent blocked in the kube client's TokenBucket. Registered here as in
  the JAX package; nothing in the port feeds it until the rate-limited
  kube client comes with the entry points.
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

PRESSURE_LEVEL = DEFAULT.gauge(
    "pressure_level",
    "Brownout ladder rung (0=normal, 1=window-shrink, 2=shed low bands, "
    "3=system-critical only)")
PODS_SHED_TOTAL = DEFAULT.counter(
    "pods_shed_total",
    "Pods refused at intake admission, by reason and priority band")
INTAKE_QUEUE_DEPTH = DEFAULT.gauge(
    "intake_queue_depth",
    "Pods awaiting a batch window across all provisioner batchers")
WINDOW_SPLITS_TOTAL = DEFAULT.counter(
    "window_splits_total",
    "Provisioning windows split into bounded solve chunks at L1+")
KUBE_CLIENT_THROTTLE_SECONDS = DEFAULT.histogram(
    "kube_client_throttle_seconds",
    "Seconds kube API requests waited in the client-side token bucket")
