"""Priority bands: which pods matter most when the control plane must
choose. A copy of the JAX package's module.

The ladder sheds whole *bands*, not individual priorities, so the policy
stays explainable and the soak invariant ("zero system-critical pods are
ever shed") is checkable per band. Classification is derived from the
fields the kube scheduler itself uses:

==================  =====================================================
band                membership
==================  =====================================================
system-critical     ``priorityClassName`` system-cluster-critical /
                    system-node-critical, or priority ≥ 2e9 (the range
                    reserved for system classes)
high                priority > 0
default             priority == 0 with resource requests
low                 priority < 0
besteffort          no resource requests anywhere (BestEffort QoS) and
                    priority ≤ 0 — the first band to go
==================  =====================================================

Shedding policy (aligned with the "Priority Matters" packing argument,
arxiv 2511.08373): L0/L1 admit everything; L2 sheds besteffort + low;
L3 admits only system-critical. An aging term (see
:func:`effective_rank`) promotes a long-waiting pod one band per aging
step so sustained pressure cannot starve it forever.
"""

from __future__ import annotations

from typing import Optional, Tuple

# rank 0 is most important; RANKS index == rank
BANDS = ("system-critical", "high", "default", "low", "besteffort")
RANK = {name: i for i, name in enumerate(BANDS)}

SYSTEM_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")
SYSTEM_PRIORITY_FLOOR = 2_000_000_000  # kube reserves ≥ 2e9 for system classes


def classify(pod) -> Tuple[str, int]:
    """(band, priority value) for a Pod — tolerant of non-pod items (the
    batcher is also exercised with plain test payloads), which land in the
    default band."""
    spec = getattr(pod, "spec", None)
    if spec is None:
        return "default", 0
    priority = int(getattr(spec, "priority", 0) or 0)
    if (spec.priority_class_name in SYSTEM_PRIORITY_CLASSES
            or priority >= SYSTEM_PRIORITY_FLOOR):
        return "system-critical", priority
    if priority > 0:
        return "high", priority
    if _is_besteffort(spec):
        return "besteffort", priority
    if priority < 0:
        return "low", priority
    return "default", priority


def _is_besteffort(spec) -> bool:
    containers = getattr(spec, "containers", None) or []
    for c in containers:
        resources = getattr(c, "resources", None)
        if resources is not None and (resources.requests or resources.limits):
            return False
    return True


def shed_reason(rank: int, level: int) -> Optional[str]:
    """Admission policy: the reason this band is refused at this ladder
    rung, or None when admitted. ``rank`` is the *effective* rank (aging
    already applied), so a long-waiting low-priority pod that aged into
    the default band is admitted at L2."""
    if rank == RANK["system-critical"]:
        return None  # never shed, at any level — the soak's hard invariant
    if level >= 3:
        return "pressure-l3"
    if level >= 2 and rank >= RANK["low"]:
        return "pressure-l2"
    return None


def effective_rank(rank: int, age_seconds: float, aging_step_seconds: float) -> int:
    """Aging promotion: one band per full aging step spent waiting, never
    into system-critical (rank floor 1). The promotion is quantized to
    whole steps so pods that arrived within the same step sort identically
    regardless of sub-step arrival interleaving."""
    if rank == 0:
        return 0
    if aging_step_seconds <= 0:
        return rank
    steps = int(age_seconds / aging_step_seconds)
    return max(1, rank - steps)
