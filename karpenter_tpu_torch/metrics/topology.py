"""Metrics for torus-grid slice carving and priced gang preemption.

Series on the process registry (``karpenter_`` prefix via
registry.expose()):

- ``karpenter_topology_carve_windows_total``  counter — gang windows that
  carried carve tensors (at least one slice-shaped gang with carving on)
- ``karpenter_topology_carves_committed_total``  counter — contiguous
  sub-grid carves committed to the occupancy ledger (one per gang × node)
- ``karpenter_topology_carve_rejects_total``  counter — host cell-by-cell
  verification rejected a bin whose *resources* fit but whose free chips
  form no contiguous sub-grid — each one is phantom capacity the shape-only
  gate would have handed to a gang
- ``karpenter_topology_ledger_nodes``  gauge — real nodes currently
  carrying committed carves in the process occupancy ledger
- ``karpenter_preemptions_total``  counter, ``band`` label — gangs
  displaced by a higher-priority gang, by the VICTIM's pressure band
  (``system-critical`` never appears here by construction)
- ``karpenter_preemption_declined_total``  counter, ``reason`` label —
  preemption attempts that did not fire: ``fresh-cheaper`` (the what-if
  displacement price met or exceeded a fresh node for the beneficiary),
  ``no-victim`` (no strictly-lower-band resident to displace),
  ``unplaceable`` (displacement alone still left the beneficiary without
  a carve; evictions rolled back), ``budget`` (the anti-thrash
  preemption budget had no token for the victim's band, or the victim
  gang is still in its post-displacement cooldown)
- ``karpenter_preemption_displaced_pods_total``  counter — member pods
  unbound and requeued through the band-aware batcher by preemptions
- ``karpenter_preemption_budget_tokens``  gauge, ``band`` label —
  displacement tokens currently available in the per-band token bucket
- ``karpenter_preemption_budget_declines_total``  counter, ``reason``
  label — candidates filtered by the budget: ``tokens`` (band bucket
  empty) or ``cooldown`` (victim gang displaced within the last N
  gang windows)
- ``karpenter_preemption_budget_cooldowns``  gauge — victim gangs
  currently inside their post-displacement cooldown window

Carve self-heal rides the existing ``karpenter_filter_fallback_total``
counter with ``reason="carve-mismatch"`` (metrics/filter.py).
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

TOPOLOGY_CARVE_WINDOWS_TOTAL = DEFAULT.counter(
    "topology_carve_windows_total",
    "Gang windows solved with carve tensors (slice gangs, carving on)")

TOPOLOGY_CARVES_COMMITTED_TOTAL = DEFAULT.counter(
    "topology_carves_committed_total",
    "Contiguous sub-grid carves committed to the occupancy ledger")

TOPOLOGY_CARVE_REJECTS_TOTAL = DEFAULT.counter(
    "topology_carve_rejects_total",
    "Bins rejected by cell-by-cell carve verification after resources fit "
    "(phantom capacity the shape-only gate would have admitted)")

TOPOLOGY_LEDGER_NODES = DEFAULT.gauge(
    "topology_ledger_nodes",
    "Real nodes currently carrying committed carves in the ledger")

PREEMPTIONS_TOTAL = DEFAULT.counter(
    "preemptions_total",
    "Gangs displaced by a higher-priority gang, by victim band")

PREEMPTION_DECLINED_TOTAL = DEFAULT.counter(
    "preemption_declined_total",
    "Preemption attempts declined, by reason (fresh-cheaper | no-victim "
    "| unplaceable | budget)")

PREEMPTION_DISPLACED_PODS_TOTAL = DEFAULT.counter(
    "preemption_displaced_pods_total",
    "Member pods unbound and requeued by gang preemptions")

PREEMPTION_BUDGET_TOKENS = DEFAULT.gauge(
    "preemption_budget_tokens",
    "Displacement tokens available in the per-band preemption budget")

PREEMPTION_BUDGET_DECLINES_TOTAL = DEFAULT.counter(
    "preemption_budget_declines_total",
    "Preemption candidates filtered by the anti-thrash budget, by reason "
    "(tokens | cooldown)")

PREEMPTION_BUDGET_COOLDOWNS = DEFAULT.gauge(
    "preemption_budget_cooldowns",
    "Victim gangs currently inside their post-displacement cooldown")
