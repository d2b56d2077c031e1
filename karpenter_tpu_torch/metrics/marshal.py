"""Metrics for the incremental window encoding (ops/encode.py arena +
solver/adapter.py marshal).

Five series, all on the process-wide registry (exposed with the
``karpenter_`` prefix by registry.expose()):

- ``karpenter_marshal_row_cache_hits_total``      counter — window pods
  served straight from the delta-marshal arena (a cached row gather; no
  Python encode)
- ``karpenter_marshal_row_cache_misses_total``    counter — window pods
  that paid the Python marshal + arena row assignment (new or churned
  signatures)
- ``karpenter_marshal_row_cache_evictions_total`` counter — arena rows
  invalidated by a generation reset (intern-table rebind, vocab rebind,
  or capacity rollover)
- ``karpenter_marshal_delta_fraction``            gauge — miss fraction of
  the most recent marshal window (0 = fully incremental steady state,
  1 = cold rebuild)
- ``karpenter_catalog_encoding_rebuilds_total``   counter — catalog device
  tensor (totals/reserved0/valid) rebuilds; flat while the (catalog token,
  constraints fingerprint, scales) key repeats window after window
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

MARSHAL_ROW_CACHE_HITS_TOTAL = DEFAULT.counter(
    "marshal_row_cache_hits_total",
    "Window pods served from the delta-marshal row arena without a "
    "Python encode")
MARSHAL_ROW_CACHE_MISSES_TOTAL = DEFAULT.counter(
    "marshal_row_cache_misses_total",
    "Window pods that paid the Python marshal and an arena row "
    "assignment (new or churned signatures)")
MARSHAL_ROW_CACHE_EVICTIONS_TOTAL = DEFAULT.counter(
    "marshal_row_cache_evictions_total",
    "Arena rows invalidated by a generation reset (intern rebind, "
    "vocab rebind, capacity rollover)")
MARSHAL_DELTA_FRACTION = DEFAULT.gauge(
    "marshal_delta_fraction",
    "Miss fraction of the most recent marshal window "
    "(0=fully incremental, 1=cold rebuild)")
CATALOG_ENCODING_REBUILDS_TOTAL = DEFAULT.counter(
    "catalog_encoding_rebuilds_total",
    "Catalog device tensor rebuilds by the encoding cache; flat while "
    "the (catalog token, constraints fingerprint, scales) key repeats")
