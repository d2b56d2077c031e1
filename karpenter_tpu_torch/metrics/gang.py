"""Metrics for gang (all-or-nothing pod group) scheduling.

Per-window series on the process registry (``karpenter_`` prefix via
registry.expose()):

- ``karpenter_gang_windows_total``       counter — gang co-pack windows
  solved (one batched device/host solve per window)
- ``karpenter_gangs_placed_total``       counter — gangs whose members ALL
  bound (atomic bind committed; the only success state a gang has)
- ``karpenter_gangs_unplaceable_total``  counter, ``reason`` label — gangs
  that did not place: ``expired`` (partial group aged past the batcher
  hold TTL and was shed back to the band-aware requeue), ``oversize``
  (declared size exceeds the window item cap), ``infeasible`` (no
  offering passes the group feasibility column / device filter),
  ``capacity`` (host re-verification found earlier gangs consumed the
  window's pool), ``no-type`` (encode found no instance type that can
  host the members), ``bind-failed`` (mid-bind failure; members unwound
  through the termination finalizer and requeued)
- ``karpenter_gang_hold_seconds``        histogram — how long a gang waited
  in the batcher between its first member arriving and the window that
  carried the complete group
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

GANG_WINDOWS_TOTAL = DEFAULT.counter(
    "gang_windows_total",
    "Gang co-pack windows solved (one batched solve per window)")

GANGS_PLACED_TOTAL = DEFAULT.counter(
    "gangs_placed_total",
    "Gangs whose members all bound atomically")

GANGS_UNPLACEABLE_TOTAL = DEFAULT.counter(
    "gangs_unplaceable_total",
    "Gangs that did not place, by reason (expired | oversize | infeasible "
    "| capacity | no-type | bind-failed)")

GANG_HOLD_SECONDS = DEFAULT.histogram(
    "gang_hold_seconds",
    "Batcher hold time from a gang's first member to its complete window")
