"""Metrics for the columnar constraint filter (ops/feasibility.py).

Three series, all on the process-wide registry (exposed with the
``karpenter_`` prefix by registry.expose()):

- ``karpenter_filter_batch_seconds``   histogram, ``stage`` label
  ("schedule" = one scheduler window, "catalog" = one catalog mask build)
- ``karpenter_filter_fallback_total``  counter, ``reason`` label — every
  time the engine hands a decision back to the scalar path
- ``karpenter_filter_intern_table_size`` gauge — live values in the
  global key→value intern table (drops to 0 on a generation reset)
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

FILTER_BATCH_SECONDS = DEFAULT.histogram(
    "filter_batch_seconds",
    "Columnar feasibility filter time per batch (stage=schedule|catalog)")
FILTER_FALLBACK_TOTAL = DEFAULT.counter(
    "filter_fallback_total",
    "Scalar-path fallbacks taken by the feasibility engine, by reason")
FILTER_INTERN_TABLE_SIZE = DEFAULT.gauge(
    "filter_intern_table_size",
    "Interned label values held by the feasibility engine's vocab table")

# -- device-resident fused filter (ops/device_filter.py) --------------------
FILTER_DEVICE_SECONDS = DEFAULT.histogram(
    "filter_device_seconds",
    "Device-resident fused feasibility filter time "
    "(stage=dispatch|verify|gang)")
FILTER_DEVICE_FALLBACK_TOTAL = DEFAULT.counter(
    "filter_device_fallback_total",
    "Device-filter retreats to the host columnar / scalar path, by reason")
FILTER_PLANE_RING_REUSES_TOTAL = DEFAULT.counter(
    "filter_plane_ring_reuses_total",
    "Catalog bit-plane ring fills skipped because the slot already held "
    "this catalog's planes (content-token match: zero transfer)")
