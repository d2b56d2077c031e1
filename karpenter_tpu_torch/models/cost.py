"""Cost model: price-aware ordering of a node's instance-type options.

Prices live on the catalog (InstanceType.price = on-demand $/h; spot offers
a discounted rate), so the solver can order each node's options
cheapest-first, with capacity order as the tiebreak, and consolidation can
price a running node (``node_price``) and a re-pack plan (``plan_cost``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.cloudprovider.spi import InstanceType

# Long-run average discount of spot vs on-demand. Configurable per solve.
DEFAULT_SPOT_PRICE_FACTOR = 0.35


@dataclass(frozen=True)
class CostConfig:
    spot_price_factor: float = DEFAULT_SPOT_PRICE_FACTOR


def effective_price(
    it: InstanceType,
    requirements: Requirements,
    config: CostConfig = CostConfig(),
) -> Tuple[float, Optional[str]]:
    """Cheapest viable (price, capacity_type) for this instance type under
    the constraints' capacity-type/zone requirements. Unpriced catalogs
    (price=0) collapse to 0 everywhere, making cost ordering a no-op."""
    capacity_types = requirements.capacity_types()
    zones = requirements.zones()
    best: Tuple[float, Optional[str]] = (float("inf"), None)
    for offering in it.offerings:
        if capacity_types is not None and offering.capacity_type not in capacity_types:
            continue
        if zones is not None and offering.zone not in zones:
            continue
        price = it.price
        if offering.capacity_type == wellknown.CAPACITY_TYPE_SPOT:
            price *= config.spot_price_factor
        if price < best[0]:
            best = (price, offering.capacity_type)
    if best[1] is None:
        return (float("inf"), None)
    return best


def order_options_by_price(
    options: Sequence[InstanceType],
    requirements: Requirements,
    config: CostConfig = CostConfig(),
) -> list:
    """Stable cheapest-first ordering of a node's instance-type options;
    the stable sort keeps capacity order as the tiebreak."""
    return sorted(options, key=lambda it: effective_price(it, requirements, config)[0])


def node_price(it: InstanceType, capacity_type: str) -> float:
    """$/h of one node of this type at this capacity type."""
    if capacity_type == wellknown.CAPACITY_TYPE_SPOT:
        return it.price * CostConfig().spot_price_factor
    return it.price


def plan_cost(packings, requirements: Requirements) -> float:
    """$/h of a pack plan (a sequence of solver.solve.Packing), charging
    each node its cheapest viable option."""
    total = 0.0
    config = CostConfig()
    for packing in packings:
        price, _ = min(
            (effective_price(it, requirements, config) for it in packing.instance_type_options),
            key=lambda t: t[0])
        total += price * packing.node_quantity
    return total
