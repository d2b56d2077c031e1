"""Metrics for the per-pod SLO engine (karpenter_tpu_torch/obs/slo.py).

Nine series, all on the process-wide registry (exposed with the
``karpenter_`` prefix by registry.expose()):

- ``karpenter_slo_stage_latency_p50_seconds`` gauge, ``band`` × ``stage``
  labels — digest p50 per lifecycle stage (intake/schedule/solve/bind/e2e)
- ``karpenter_slo_stage_latency_p99_seconds`` gauge, same labels — digest
  p99 per lifecycle stage
- ``karpenter_slo_samples``          gauge, ``band`` × ``stage`` labels —
  samples folded into each digest cell since the last reset
- ``karpenter_slo_objective_seconds`` gauge, ``band`` label — configured
  latency objective threshold per band
- ``karpenter_slo_burn_rate``        gauge, ``band`` × ``window``
  (fast|slow) labels — breach fraction over the window divided by the
  error budget (1 − target)
- ``karpenter_slo_burning_bands``    gauge — bands currently past both
  burn thresholds (readyz degrades while this is nonzero)
- ``karpenter_slo_burn_trips_total`` gauge — slo-burn flight-recorder
  trips since the last reset
- ``karpenter_slo_breaches_total``   counter, ``band`` × ``stage``
  labels — samples (and intake sheds) past the band's objective
- ``karpenter_slo_breach_latency_seconds`` histogram, ``band`` label —
  breaching samples only, exemplared with the sample window's trace id
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

SLO_STAGE_P50 = DEFAULT.gauge(
    "slo_stage_latency_p50_seconds",
    "Digest p50 latency per priority band and lifecycle stage")
SLO_STAGE_P99 = DEFAULT.gauge(
    "slo_stage_latency_p99_seconds",
    "Digest p99 latency per priority band and lifecycle stage")
SLO_SAMPLES = DEFAULT.gauge(
    "slo_samples",
    "Samples folded into each (band, stage) digest cell since reset")
SLO_OBJECTIVE = DEFAULT.gauge(
    "slo_objective_seconds",
    "Configured per-band latency objective threshold")
SLO_BURN_RATE = DEFAULT.gauge(
    "slo_burn_rate",
    "Error-budget burn rate per band over the fast/slow window")
SLO_BURNING_BANDS = DEFAULT.gauge(
    "slo_burning_bands",
    "Bands currently past both burn-rate thresholds (degrades readyz)")
SLO_BURN_TRIPS = DEFAULT.gauge(
    "slo_burn_trips_total",
    "slo-burn flight-recorder trips since the last reset")
SLO_BREACHES = DEFAULT.counter(
    "slo_breaches_total",
    "Latency samples and intake sheds past the band's objective")
SLO_BREACH_LATENCY = DEFAULT.histogram(
    "slo_breach_latency_seconds",
    "Latency of objective-breaching samples, exemplared with the sample "
    "window's trace id")
