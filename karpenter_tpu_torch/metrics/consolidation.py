"""Metrics for the batched what-if consolidation engine.

Per-window series on the process registry (``karpenter_`` prefix via
registry.expose()):

- ``karpenter_consolidation_window_candidates``        gauge — candidates
  that entered the last what-if batch (post-filter window size)
- ``karpenter_consolidation_candidates_evaluated_total`` counter — drains
  evaluated by the batched solve, cumulative (one window adds N at once —
  the "evaluations per reconcile" the engine exists to multiply)
- ``karpenter_consolidation_candidates_filtered_total``  counter,
  ``reason`` label — candidates excluded BEFORE the batch:
  ``do-not-evict`` (an annotated pod pins the node), ``pdb`` (draining
  would breach a PodDisruptionBudget's headroom, or the pod's PDBs are
  misconfigured — >1 match / both fields set — which eviction would 500)
- ``karpenter_consolidation_drains_executed_total``    counter — node
  deletions the engine actually issued (every one host-verified)
- ``karpenter_consolidation_reclaimed_dollars_total``  counter — $/h
  reclaimed, summed over executed drains (0-priced when the catalog
  can't price the node)
- ``karpenter_consolidation_window_reclaimed_per_hour`` gauge — $/h
  reclaimed by the LAST window's plan
- ``karpenter_consolidation_whatif_solve_seconds``     histogram —
  dispatch+fetch wall time of the batched what-if solve
- ``karpenter_consolidation_relax_used_total``         counter — repacks
  where the relaxation's rounded plan beat exact FFD and was used
- ``karpenter_consolidation_relax_fallback_total``     counter,
  ``reason`` label — relaxation attempts that fell back to the exact FFD
  plan (``infeasible``, ``costlier``, ``unpriced``, ``unencodable``,
  ``no-support``, ``non-finite``, ...): the zero-unverified-drains
  contract made visible
- ``karpenter_consolidation_unknown_instance_type_total`` counter — nodes
  whose instance-type label is absent from the current catalog (priced at
  $0 and still consolidatable; logged once per window, not per node)
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

CONSOLIDATION_WINDOW_CANDIDATES = DEFAULT.gauge(
    "consolidation_window_candidates",
    "Candidate drains in the last batched what-if window (post-filter)")

CONSOLIDATION_CANDIDATES_TOTAL = DEFAULT.counter(
    "consolidation_candidates_evaluated_total",
    "Candidate drains evaluated by the batched what-if solve, cumulative")

CONSOLIDATION_FILTERED_TOTAL = DEFAULT.counter(
    "consolidation_candidates_filtered_total",
    "Candidates excluded before the what-if batch, by reason "
    "(do-not-evict | pdb)")

CONSOLIDATION_DRAINS_TOTAL = DEFAULT.counter(
    "consolidation_drains_executed_total",
    "Node drains executed by the consolidation engine (host-verified)")

CONSOLIDATION_RECLAIMED_TOTAL = DEFAULT.counter(
    "consolidation_reclaimed_dollars_total",
    "Cumulative $/h reclaimed by executed drains")

CONSOLIDATION_WINDOW_RECLAIMED = DEFAULT.gauge(
    "consolidation_window_reclaimed_per_hour",
    "$/h reclaimed by the last consolidation window's plan")

CONSOLIDATION_SOLVE_SECONDS = DEFAULT.histogram(
    "consolidation_whatif_solve_seconds",
    "Wall seconds of the batched what-if solve (dispatch + fetch)")

CONSOLIDATION_RELAX_USED = DEFAULT.counter(
    "consolidation_relax_used_total",
    "Global repacks where the relaxation's rounded plan was used")

CONSOLIDATION_RELAX_FALLBACKS = DEFAULT.counter(
    "consolidation_relax_fallback_total",
    "Relaxation attempts that fell back to the exact FFD plan, by reason")

CONSOLIDATION_UNKNOWN_TYPE_TOTAL = DEFAULT.counter(
    "consolidation_unknown_instance_type_total",
    "Nodes whose instance-type label is absent from the catalog "
    "(priced $0, still consolidatable; logged once per window)")
