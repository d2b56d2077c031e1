"""Pod-pod affinity: the preferred terms consolidation prices.

A trimmed copy of the JAX package's ``scheduling/affinity.py``: the
soft-affinity kill switch and the preferred-term reader, which
``ops/whatif.soft_affinity_loss`` uses to price a drain that scatters a
co-located set. Required-term injection, the domain assignment and the
match matrix come with the gang and topology port.
"""

from __future__ import annotations

import os

from karpenter_tpu_torch.api.core import Pod

SOFT_AFFINITY_ENV = "KARPENTER_SOFT_AFFINITY"


def soft_enabled() -> bool:
    """Preferred-term kill switch: default ON, 0/false/off disables."""
    return os.environ.get(SOFT_AFFINITY_ENV, "1").strip().lower() not in (
        "0", "false", "off")


def _preferred_terms(pod: Pod, anti: bool) -> list:
    """(weight, term) pairs of one side's preferred list; zero-weight and
    selector-less terms are inert (kube weight range is 1-100)."""
    aff = pod.spec.affinity
    if aff is None:
        return []
    side = aff.pod_anti_affinity if anti else aff.pod_affinity
    if side is None:
        return []
    return [(int(w.weight), w.term) for w in side.preferred
            if w.term.topology_key and w.term.label_selector is not None
            and int(w.weight) != 0]
