"""Metrics for the whole-window global-solve backend.

Per-window series on the process registry (``karpenter_`` prefix via
registry.expose()):

- ``karpenter_global_windows_total``   counter — provisioning windows
  dispatched through the global (ADMM relaxation) backend
- ``karpenter_global_used_total``      counter — schedules whose rounded
  relaxation plan was strictly cheaper, fully feasible, host-verified,
  and USED in place of the FFD backend's plan
- ``karpenter_global_fallback_total``  counter, ``reason`` label —
  schedules that kept the FFD backend's plan bit-for-bit (``empty``,
  ``unpriced``, ``unencodable``, ``no-support``, ``infeasible``,
  ``costlier``, ``unverified``, ``error``, ``window-cap``): the
  zero-unverified-placements contract made visible
- ``karpenter_global_widened_accept_total`` counter — no-support
  schedules recovered by the single widened-support rounding retry
  (accepted through the same exact cheaper/verify gates)
- ``karpenter_global_iterations``      gauge — projected-gradient
  iterations configured for the last dispatched window
- ``karpenter_global_support_threshold`` gauge — the adaptive absolute
  support threshold currently in force (EWMA acceptance-rate driven,
  between the widened 0.05 floor and the strict 0.4 ceiling)
- ``karpenter_global_solve_seconds``   histogram — dispatch+fetch wall
  seconds of the batched global solve (rounding + verification included)
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

GLOBAL_WINDOWS_TOTAL = DEFAULT.counter(
    "global_windows_total",
    "Provisioning windows dispatched through the global (ADMM relaxation) "
    "backend")

GLOBAL_USED_TOTAL = DEFAULT.counter(
    "global_used_total",
    "Schedules whose rounded relaxation plan was strictly cheaper, "
    "host-verified, and used in place of the FFD plan")

GLOBAL_FALLBACK_TOTAL = DEFAULT.counter(
    "global_fallback_total",
    "Schedules that kept the FFD backend's plan bit-for-bit, by reason")

GLOBAL_WIDENED_ACCEPT_TOTAL = DEFAULT.counter(
    "global_widened_accept_total",
    "No-support schedules recovered by the widened-support rounding retry")

GLOBAL_SUPPORT_THRESHOLD = DEFAULT.gauge(
    "global_support_threshold",
    "Adaptive absolute support threshold in force (EWMA acceptance-rate "
    "interpolation between the widened floor and the strict ceiling)")

GLOBAL_ITERATIONS = DEFAULT.gauge(
    "global_iterations",
    "Projected-gradient iterations configured for the last global window")

GLOBAL_SOLVE_SECONDS = DEFAULT.histogram(
    "global_solve_seconds",
    "Wall seconds of the batched global solve (dispatch + fetch, "
    "rounding and host verification included)")
