"""Anti-thrash preemption budget: a token bucket over displacements.

A copy of the JAX package's ``scheduling/preempt_budget.py``. Priced
preemption (solver/gang.py) decides whether displacing a resident gang is
*cheaper* than a fresh node, but price alone does not bound churn: under a
saturated flood the same low-band residents could be displaced, requeued,
placed again and displaced again every window. Two rules guard it:

1. **Per-band token bucket.** Each pressure band has a displacement
   budget, a bucket of fixed capacity refilled by ``refill_per_window``
   tokens at the start of every gang window. An executed preemption
   charges one token from the *victim's* band; when a band's bucket is
   empty, further candidates from it are filtered out of the window's
   ``PreemptContext`` before the planner sees them. ``system-critical``
   has no bucket: it is never a victim.
2. **Per-gang cooldown.** A gang displaced once cannot be displaced again
   for ``cooldown_windows`` gang windows, whatever its band's tokens.

The budget is in memory and process-local: a rate guard, not correctness
state. It publishes the JAX package's series: the per-band
``karpenter_preemption_budget_tokens`` and the cooldown gauge on every
change, and each filtered candidate in
``karpenter_preemption_budget_declines_total`` by reason (``cooldown``,
``tokens``) and ``karpenter_preemption_declined_total`` as ``budget``.
:attr:`declines` keeps the same counts as an attribute.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

from karpenter_tpu_torch.metrics.topology import (
    PREEMPTION_BUDGET_COOLDOWNS, PREEMPTION_BUDGET_DECLINES_TOTAL, PREEMPTION_BUDGET_TOKENS,
    PREEMPTION_DECLINED_TOTAL,
)
from karpenter_tpu_torch.pressure.bands import BANDS

# Per-band bucket capacity: how many displacements a band can absorb in a
# burst. Lower bands are cheaper to displace, so their buckets are deeper.
DEFAULT_CAPACITY: Dict[str, int] = {
    "high": 1,
    "default": 2,
    "low": 4,
    "besteffort": 4,
}


class PreemptionBudget:
    """Token-bucket displacement budget with a per-gang cooldown.

    Per gang window the provisioning worker calls :meth:`tick` once when it
    starts building a preempt context, then :meth:`admit` to filter the
    candidates, and :meth:`charge` for each displacement it executes. All
    three take the lock."""

    def __init__(self, capacity: Optional[Dict[str, int]] = None,
                 refill_per_window: int = 1, cooldown_windows: int = 3) -> None:
        self.capacity = dict(capacity or DEFAULT_CAPACITY)
        self.refill_per_window = int(refill_per_window)
        self.cooldown_windows = int(cooldown_windows)
        self._lock = threading.Lock()
        self._window = 0
        # buckets start full so the first window is never throttled
        self._tokens: Dict[str, int] = dict(self.capacity)
        # gang_key(str) -> window index when it was last displaced
        self._cooldown: Dict[str, int] = {}
        self.declines: Dict[str, int] = {}
        self._publish_locked()

    def tick(self) -> None:
        """Advance one gang window: refill every band's bucket (up to its
        capacity) and expire finished cooldowns."""
        with self._lock:
            self._window += 1
            for band, cap in self.capacity.items():
                self._tokens[band] = min(cap, self._tokens.get(band, 0) + self.refill_per_window)
            # a gang charged at window W stays filtered through window
            # W + cooldown_windows inclusive
            horizon = self._window - self.cooldown_windows
            self._cooldown = {g: w for g, w in self._cooldown.items() if w >= horizon}
            self._publish_locked()

    def admit(self, candidates: Iterable) -> List:
        """Filter a window's preemption candidates to what the budget
        allows. Gangs cooling down go first; the rest are ranked cheapest
        displacement first per band and cut to the band's tokens (tokens
        are only *reserved* here; :meth:`charge` consumes them). The
        admitted list keeps the caller's order, so the planner's tie
        breaks stay deterministic."""
        cands = list(candidates)
        if not cands:
            return cands
        with self._lock:
            by_band: Dict[str, List] = {}
            for c in cands:
                if str(c.gang_key) in self._cooldown:
                    self._decline_locked("cooldown")
                    continue
                by_band.setdefault(c.band, []).append(c)
            allowed = set()
            for band, group in by_band.items():
                budget = self._tokens.get(band)
                if budget is None:  # unknown band: no bucket, no throttle
                    allowed.update(id(c) for c in group)
                    continue
                ranked = sorted(group, key=lambda c: (c.displacement_cost, str(c.gang_key)))
                for c in ranked[:budget]:
                    allowed.add(id(c))
                for _c in ranked[budget:]:
                    self._decline_locked("tokens")
            return [c for c in cands if id(c) in allowed]

    def charge(self, gang_key, band: str) -> None:
        """Record one executed displacement: consume a token from the
        victim's band and start the victim gang's cooldown."""
        with self._lock:
            if band in self._tokens:
                self._tokens[band] = max(0, self._tokens[band] - 1)
            self._cooldown[str(gang_key)] = self._window
            self._publish_locked()

    def tokens(self, band: str) -> int:
        with self._lock:
            return self._tokens.get(band, 0)

    def in_cooldown(self, gang_key) -> bool:
        with self._lock:
            return str(gang_key) in self._cooldown

    def _decline_locked(self, reason: str) -> None:
        PREEMPTION_BUDGET_DECLINES_TOTAL.inc(reason=reason)
        PREEMPTION_DECLINED_TOTAL.inc(reason="budget")
        self.declines[reason] = self.declines.get(reason, 0) + 1

    def _publish_locked(self) -> None:
        for band in BANDS:
            if band in self.capacity:
                PREEMPTION_BUDGET_TOKENS.set(float(self._tokens.get(band, 0)), band=band)
        PREEMPTION_BUDGET_COOLDOWNS.set(float(len(self._cooldown)))
