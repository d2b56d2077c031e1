"""Metrics for the device-vectorized scoring policies (ops/policy.py,
solver/policy.py).

Four series, all on the process-wide registry (exposed with the
``karpenter_`` prefix by registry.expose()):

- ``karpenter_policy_score_seconds``    histogram, ``stage`` label
  ("device" = one batched window scoring dispatch, "host" = one scalar
  per-cell scoring pass, "verify" = the probe re-verification)
- ``karpenter_policy_fallback_total``   counter, ``reason`` label — every
  time a device score is discarded for the scalar oracle's answer
- ``karpenter_policy_cells_scored_total`` counter — (schedule × type ×
  offering) cells scored on device, the work the host loop no longer does
- ``karpenter_policy_spot_selected_total`` counter, ``policy`` label —
  placements whose winning offering was spot (the frontier's observable)
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

POLICY_SCORE_SECONDS = DEFAULT.histogram(
    "policy_score_seconds",
    "Packing-policy scoring time per window (stage=device|host|verify)")
POLICY_FALLBACK_TOTAL = DEFAULT.counter(
    "policy_fallback_total",
    "Device policy scores discarded for the scalar oracle's answer, by reason")
POLICY_CELLS_SCORED_TOTAL = DEFAULT.counter(
    "policy_cells_scored_total",
    "Feasible (schedule x type x offering) cells scored on device")
POLICY_SPOT_SELECTED_TOTAL = DEFAULT.counter(
    "policy_spot_selected_total",
    "Placements whose winning offering was spot, by policy")

# Preferred (soft) affinity series — karpenter_soft_affinity_* —
# the weighted score terms fused into the same scoring program
SOFT_AFFINITY_TERMS_TOTAL = DEFAULT.counter(
    "soft_affinity_terms_total",
    "Preferred pod-(anti-)affinity terms that produced soft votes")
SOFT_AFFINITY_STEERED_TOTAL = DEFAULT.counter(
    "soft_affinity_steered_total",
    "Launches whose zone choice was narrowed by preferred-affinity votes")
SOFT_AFFINITY_BLOCKED_DRAINS_TOTAL = DEFAULT.counter(
    "soft_affinity_blocked_drains_total",
    "Consolidation drains skipped because the soft-affinity loss "
    "exceeded the price savings")
