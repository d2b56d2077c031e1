"""CloudProvider metrics decorator.

Reference: pkg/cloudprovider/metrics/cloudprovider.go:65-92 — every SPI
method is wrapped in a ``cloudprovider_duration_seconds{method, provider}``
histogram, installed unconditionally at cmd/controller/main.go:76-77 so
provider latency is always visible at /metrics. The decorator is
transparent: it satisfies the same CloudProvider contract and forwards
everything, timing failures too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Node
from karpenter_tpu_torch.cloudprovider.spi import BindCallback, CloudProvider, InstanceType
from karpenter_tpu_torch.metrics.registry import HISTOGRAMS

METRIC = "cloudprovider_duration_seconds"


class MeteredCloudProvider(CloudProvider):
    """Wraps any provider so every SPI method emits a duration histogram
    (metrics/cloudprovider.go:65-92: Create/Delete/GetInstanceTypes/
    Default/Validate, and the capacity enumeration the GC reads)."""

    def __init__(self, inner: CloudProvider):
        self._inner = inner
        self._provider = inner.name()

    def _timer(self, method: str):
        return HISTOGRAMS.time(METRIC, method=method, provider=self._provider)

    def create(self, constraints: Constraints, instance_types: Sequence[InstanceType],
               quantity: int, bind: BindCallback) -> List[Optional[str]]:
        with self._timer("Create"):
            return self._inner.create(constraints, instance_types, quantity, bind)

    def delete(self, node: Node) -> Optional[str]:
        with self._timer("Delete"):
            return self._inner.delete(node)

    def list_instances(self):
        with self._timer("ListInstances"):
            return self._inner.list_instances()

    def delete_instance(self, instance_id: str) -> Optional[str]:
        with self._timer("DeleteInstance"):
            return self._inner.delete_instance(instance_id)

    def get_instance_types(self, constraints: Constraints) -> List[InstanceType]:
        with self._timer("GetInstanceTypes"):
            return self._inner.get_instance_types(constraints)

    def default(self, constraints: Constraints) -> None:
        with self._timer("Default"):
            return self._inner.default(constraints)

    def validate(self, constraints: Constraints) -> Optional[str]:
        with self._timer("Validate"):
            return self._inner.validate(constraints)

    def name(self) -> str:
        return self._inner.name()

    def __getattr__(self, item):
        # provider-specific extras (the fake's fault injection and ledger)
        # pass through untimed; only the SPI surface is metered. Private
        # lookups raise instead of dereferencing _inner: during unpickle or
        # deepcopy __getattr__ runs before __dict__ is restored, and a
        # dereference would recurse forever.
        if item.startswith("_"):
            raise AttributeError(item)
        return getattr(self._inner, item)


def decorate(provider: CloudProvider) -> MeteredCloudProvider:
    """Idempotent wrap (a double-decorated provider would double-count)."""
    if isinstance(provider, MeteredCloudProvider):
        return provider
    return MeteredCloudProvider(provider)
