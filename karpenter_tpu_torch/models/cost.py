"""Cost model: price-aware ordering of a node's instance-type options.

Prices live on the catalog (InstanceType.price = on-demand $/h; spot offers
a discounted rate), so the solver can order each node's options
cheapest-first, with capacity order as the tiebreak.
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
