"""The port's CloudProvider metrics decorator (cloudprovider/metrics.py),
with the cases of tests/test_cloudprovider_metrics.py: every SPI call lands
in ``karpenter_cloudprovider_duration_seconds{method, provider}``, failures
included; decorate() is idempotent; extras pass through untimed; main.py
installs it. The series' name, help and label sets equal the JAX
package's for the same calls.
"""

import pytest

from karpenter_tpu.cloudprovider.fake.provider import FakeCloudProvider as JaxFake
from karpenter_tpu.cloudprovider.fake.provider import instance_types as jax_instance_types
from karpenter_tpu.cloudprovider.metrics import METRIC as JAX_METRIC
from karpenter_tpu.cloudprovider.metrics import decorate as jax_decorate
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.metrics.registry import HISTOGRAMS as JAX_HISTOGRAMS
from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider, instance_types
from karpenter_tpu_torch.cloudprovider.metrics import METRIC, MeteredCloudProvider, decorate
from karpenter_tpu_torch.metrics.registry import HISTOGRAMS, NAMESPACE
from karpenter_tpu_torch.solver.solve import universe_constraints

SPI = ("Create", "Delete", "GetInstanceTypes", "Default", "Validate", "ListInstances",
       "DeleteInstance")


def series(hist):
    return {dict(lv)["method"]: total for lv, (_, _, total) in hist.collect().items()}


def drive(provider, constraints):
    """Every metered SPI method once (create twice over)."""
    got = provider.get_instance_types(constraints)
    provider.default(constraints)
    provider.validate(constraints)
    bound = []
    provider.create(constraints, got, 2, lambda n: bound.append(n) and None)
    provider.delete(bound[0])
    records = provider.list_instances()
    provider.delete_instance(records[0].instance_id)
    return got, bound


def test_all_spi_methods_metered_as_in_the_jax_package():
    port_before = series(HISTOGRAMS.histogram(METRIC))
    jax_before = series(JAX_HISTOGRAMS.histogram(JAX_METRIC))
    catalog = instance_types(3)
    got, bound = drive(decorate(FakeCloudProvider(catalog=catalog)),
                       universe_constraints(catalog))
    jcat = jax_instance_types(3)
    drive(jax_decorate(JaxFake(catalog=jcat)), jax_universe(jcat))
    assert [it.name for it in got] == [it.name for it in catalog] and len(bound) == 2
    port_moved = {m: series(HISTOGRAMS.histogram(METRIC)).get(m, 0) - port_before.get(m, 0)
                  for m in SPI}
    jax_moved = {m: series(JAX_HISTOGRAMS.histogram(JAX_METRIC)).get(m, 0)
                 - jax_before.get(m, 0) for m in SPI}
    assert port_moved == jax_moved == {m: 1 for m in SPI}
    assert METRIC == JAX_METRIC
    assert HISTOGRAMS.histogram(METRIC).help == JAX_HISTOGRAMS.histogram(JAX_METRIC).help
    assert HISTOGRAMS.histogram(METRIC).buckets == JAX_HISTOGRAMS.histogram(JAX_METRIC).buckets


def test_failure_still_observed():
    class Exploding(FakeCloudProvider):
        def get_instance_types(self, constraints):
            raise RuntimeError("boom")

    provider = decorate(Exploding())
    before = series(HISTOGRAMS.histogram(METRIC)).get("GetInstanceTypes", 0)
    with pytest.raises(RuntimeError, match="boom"):
        provider.get_instance_types(None)
    assert series(HISTOGRAMS.histogram(METRIC))["GetInstanceTypes"] == before + 1


def test_idempotent_decorate_and_passthrough():
    inner = FakeCloudProvider(catalog=instance_types(2))
    wrapped = decorate(inner)
    assert decorate(wrapped) is wrapped
    assert isinstance(wrapped, MeteredCloudProvider) and wrapped.name() == "fake"
    # provider-specific extras (fault injection) reach the inner provider
    wrapped.insufficient_capacity.add(("x", "z", "spot"))
    assert inner.insufficient_capacity == {("x", "z", "spot")}
    with pytest.raises(AttributeError):
        wrapped._private


def test_exposed_with_labels():
    catalog = instance_types(2)
    decorate(FakeCloudProvider(catalog=catalog)).get_instance_types(
        universe_constraints(catalog))
    text = HISTOGRAMS.expose()
    assert f"{NAMESPACE}_{METRIC}_bucket" in text
    assert 'method="GetInstanceTypes"' in text and 'provider="fake"' in text


def test_main_installs_the_decorator():
    from karpenter_tpu_torch.config.options import Options
    from karpenter_tpu_torch.main import build_cloud_provider

    provider = build_cloud_provider(Options(cloud_provider="fake"))
    assert isinstance(provider, MeteredCloudProvider)
    with pytest.raises(KeyError, match="unknown cloud provider"):
        build_cloud_provider(Options(cloud_provider="aws"))
