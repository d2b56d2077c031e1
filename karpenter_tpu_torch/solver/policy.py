"""Pluggable packing-policy scoring: which (instance type, offering) a
node's placement should prefer, beyond the reference's cheapest-feasible
tiebreak.

A copy of the JAX package's ``solver/policy.py``. Feasibility
(ops/device_filter.py) never consults a policy: a policy only orders and
tiebreaks among cells the filter already proved viable, so a policy bug
can misprice a node but never place an infeasible one.

Three built-ins:

- ``cheapest`` (default): delegates verbatim to models/cost.py's
  effective_price / order_options_by_price, so the default policy is
  bit-for-bit the pre-policy behavior.
- ``interruption-priced``: spot is discounted but carries a reclaim tax.
  A spot offering scores ``price x spot_factor + interruption_rate x
  repack_cost_per_hour`` where the repack cost comes from the what-if
  engine (:func:`whatif_repack_cost`): 0 when the node's pods would refit
  on existing free capacity, else the cheapest on-demand replacement
  price. Spot wins exactly when losing it is cheap to repack:
  ``rate x repack < price x (1 - factor)``.
- ``throughput-per-dollar``: heterogeneous accelerator catalogs score by
  $/unit-of-throughput using a per-type throughput table
  (PolicyContext.throughput); types absent from the table default to 1.0
  so the policy degrades to cheapest-feasible on unknown hardware.

Scores are $/h-shaped floats, lower is better; ``(inf, None)`` means no
viable offering. The device program of this module is ops/policy.py, which
evaluates the same algebra over every (schedule x type x capacity type)
cell of a window in one call and is probe-verified against a numpy
mirror.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.models.cost import (
    CostConfig, effective_price, order_options_by_price,
)


@dataclass(frozen=True)
class PolicyContext:
    """Per-window pricing context handed to non-default policies.

    ``repack_cost_per_hour`` is the what-if engine's price of losing one
    spot node of this window's shape: ~0 when its pods refit on existing
    free capacity, else the $/h of the cheapest on-demand replacement.
    ``throughput`` maps instance-type name -> relative throughput for the
    throughput-per-dollar policy (absent types default to 1.0).
    ``soft_affinity_cost_per_weight`` converts one unit of preferred
    pod-(anti-)affinity weight (kube range 1-100) into $/h: a zone a
    schedule's peers voted +w for scores ``w x cost`` cheaper there,
    an anti vote the opposite. 0 disables soft pricing entirely: the
    scoring rows are then bit-for-bit the rows without votes."""

    repack_cost_per_hour: float = 0.0
    throughput: Mapping[str, float] = field(default_factory=dict)
    soft_affinity_cost_per_weight: float = 0.001

    def token(self) -> tuple:
        """Hashable identity for device-side table caching (ops/policy.py)."""
        return (round(self.repack_cost_per_hour, 9),
                tuple(sorted(self.throughput.items())),
                round(self.soft_affinity_cost_per_weight, 9))


class ScoringPolicy:
    """One scoring strategy. ``score`` prices a single instance type under
    a constraint set; ``order_options`` orders a packed node's viable
    type options for launch. ``always_tiebreak`` forces price scoring on
    even when SolverConfig.cost_tiebreak is off (a non-default policy that
    never scored would silently be cheapest)."""

    name = ""
    always_tiebreak = False

    def score(self, it: InstanceType, requirements: Requirements,
              cost_config: CostConfig,
              ctx: PolicyContext) -> Tuple[float, Optional[str]]:
        raise NotImplementedError

    def order_options(self, options: Sequence[InstanceType],
                      requirements: Requirements, cost_config: CostConfig,
                      ctx: PolicyContext) -> list:
        # stable sort: capacity (FFD) order is the tiebreak, same contract
        # as models/cost.order_options_by_price
        return sorted(options, key=lambda it: self.score(
            it, requirements, cost_config, ctx)[0])


class CheapestFeasible(ScoringPolicy):
    """The default: today's cheapest-viable-offering tiebreak, by structural
    delegation to models/cost.py (bit-for-bit — no re-derived float path)."""

    name = "cheapest"

    def score(self, it, requirements, cost_config, ctx):
        return effective_price(it, requirements, cost_config)

    def order_options(self, options, requirements, cost_config, ctx):
        return order_options_by_price(options, requirements, cost_config)


class InterruptionPriced(ScoringPolicy):
    """Spot priced with its reclaim tax (module docstring algebra)."""

    name = "interruption-priced"
    always_tiebreak = True

    def score(self, it, requirements, cost_config, ctx):
        capacity_types = requirements.capacity_types()
        zones = requirements.zones()
        best: Tuple[float, Optional[str]] = (float("inf"), None)
        for o in it.offerings:
            if capacity_types is not None and o.capacity_type not in capacity_types:
                continue
            if zones is not None and o.zone not in zones:
                continue
            if o.capacity_type == wellknown.CAPACITY_TYPE_SPOT:
                price = (it.price * cost_config.spot_price_factor
                         + o.interruption_rate * ctx.repack_cost_per_hour)
            else:
                price = it.price
            if price < best[0]:
                best = (price, o.capacity_type)
        return best if best[1] is not None else (float("inf"), None)


class ThroughputPerDollar(ScoringPolicy):
    """Heterogeneous catalogs: cheapest effective price per unit of relative
    throughput. A type absent from the table scores at throughput 1.0, so an
    unannotated catalog degrades to cheapest-feasible ordering."""

    name = "throughput-per-dollar"
    always_tiebreak = True

    def score(self, it, requirements, cost_config, ctx):
        price, ct = effective_price(it, requirements, cost_config)
        if ct is None:
            return (float("inf"), None)
        tput = float(ctx.throughput.get(it.name, 1.0))
        if tput <= 0.0:
            return (float("inf"), None)  # zero-throughput types never win
        return (price / tput, ct)


def soft_zone_votes(soft: Optional[Mapping]) -> Dict[str, int]:
    """Zone-keyed entries of a schedule's soft-affinity vote map
    ({(topology_key, value): signed weight} → {zone: weight}). The scoring
    seams price zones only — other keys are consolidation-side."""
    if not soft:
        return {}
    return {v: int(w) for (k, v), w in soft.items()
            if k == wellknown.LABEL_TOPOLOGY_ZONE and int(w)}


def soft_zone_adjust(it: InstanceType, requirements: Requirements,
                     votes: Mapping[str, int], ctx: PolicyContext) -> float:
    """$/h soft-affinity adjustment when scoring ``it``: the best case over
    the type's allowed-zone offerings, ``min over z of -w(z) x cost`` (a
    positive vote is a discount — the launch zone steering realizes it).
    0 with no votes, zero cost, or no viable zone. This is the HOST-loop
    (float) leg; the device kernel applies the same min-over-zones in
    exact int micro-$ (ops/policy.py)."""
    if not votes or ctx.soft_affinity_cost_per_weight <= 0.0:
        return 0.0
    zones = requirements.zones()
    best: Optional[float] = None
    for o in it.offerings:
        if zones is not None and o.zone not in zones:
            continue
        adj = -votes.get(o.zone, 0) * ctx.soft_affinity_cost_per_weight
        if best is None or adj < best:
            best = adj
    return best if best is not None else 0.0


_POLICIES: Dict[str, ScoringPolicy] = {}


def register(policy: ScoringPolicy) -> ScoringPolicy:
    _POLICIES[policy.name] = policy
    return policy


def get(name: str) -> ScoringPolicy:
    try:
        return _POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown packing policy {name!r}; available: {available()}")


def available() -> List[str]:
    return sorted(_POLICIES)


DEFAULT_POLICY = register(CheapestFeasible())
register(InterruptionPriced())
register(ThroughputPerDollar())


def whatif_repack_cost(
    pod_vecs: Sequence,
    free_vecs: Sequence,
    instance_types: Sequence[InstanceType],
    requirements: Requirements,
    cost_config: CostConfig = CostConfig(),
) -> float:
    """What-if price of one spot interruption for a node carrying
    ``pod_vecs``: 0 when the displaced pods would refit on the fleet's
    existing free capacity (``free_vecs``, models/consolidate.fits_on_
    existing — the same oracle consolidation trusts for scale-down), else
    the $/h of the cheapest viable **on-demand** replacement (a repack that
    lands on spot again would itself be interrupted; pricing the on-demand
    floor keeps the policy's fixed point honest). An unpriced/unviable
    catalog prices the repack at 0 — the policy then degrades to plain
    spot-discount ordering."""
    if not pod_vecs:
        return 0.0
    if free_vecs:
        from karpenter_tpu_torch.models.consolidate import fits_on_existing
        if fits_on_existing(list(pod_vecs), list(free_vecs)):
            return 0.0
    best = float("inf")
    for it in instance_types:
        zones = requirements.zones()
        for o in it.offerings:
            if o.capacity_type != wellknown.CAPACITY_TYPE_ON_DEMAND:
                continue
            if zones is not None and o.zone not in zones:
                continue
            if it.price < best:
                best = it.price
            break
    return best if best != float("inf") else 0.0
