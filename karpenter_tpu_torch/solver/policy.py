"""Packing-policy scoring: which instance type a node's placement prefers.

The port carries the default policy only: ``cheapest`` delegates to
models/cost.py's effective_price / order_options_by_price. A policy only
orders and tiebreaks among types feasibility already proved viable.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.models.cost import (
    CostConfig, effective_price, order_options_by_price,
)


class CheapestFeasible:
    """Cheapest viable offering; capacity order breaks price ties."""

    name = "cheapest"

    def score(self, it: InstanceType, requirements: Requirements,
              cost_config: CostConfig) -> Tuple[float, Optional[str]]:
        return effective_price(it, requirements, cost_config)

    def order_options(self, options: Sequence[InstanceType],
                      requirements: Requirements,
                      cost_config: CostConfig) -> list:
        return order_options_by_price(options, requirements, cost_config)


DEFAULT_POLICY = CheapestFeasible()
