"""The port's device feasibility mask (karpenter_tpu_torch/ops/device_filter)
against the JAX package's and against the scalar validator.

Catalogs and allowed sets come from the JAX package's own seeded fuzz
helpers (tests/test_feasibility.py); each catalog is copied field for field
into the port's types, so both packages see the same instance types. The
port's ``compute_mask`` runs on the CPU. Every raw (schedule, type) verdict
must equal the port's ``adapter._validate`` and, where both packages mask
the same window, the JAX package's ``device_filter.compute_mask``. Exact:
the verdicts are booleans.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import device_filter as jax_device_filter
from karpenter_tpu.solver import adapter as jax_adapter
from karpenter_tpu_torch.backend import to_device_int32
from karpenter_tpu_torch.cloudprovider import spi as port_spi
from karpenter_tpu_torch.ops import device_filter
from karpenter_tpu_torch.solver import adapter
from karpenter_tpu_torch.utils.resources import Quantity as PortQuantity
from tests.test_device_filter import _rand_allowed_oov, _rand_required
from tests.test_feasibility import _q, _rand_allowed, rand_constraints, rand_instance_type


def to_port(it):
    """A JAX-package InstanceType → the port's, field for field."""
    q = lambda x: PortQuantity(x.nano)  # noqa: E731
    return port_spi.InstanceType(
        name=it.name,
        offerings=[port_spi.Offering(o.capacity_type, o.zone, o.interruption_rate)
                   for o in it.offerings],
        architecture=it.architecture, operating_systems=frozenset(it.operating_systems),
        cpu=q(it.cpu), memory=q(it.memory), pods=q(it.pods),
        nvidia_gpus=q(it.nvidia_gpus), amd_gpus=q(it.amd_gpus),
        aws_neurons=q(it.aws_neurons), aws_pod_eni=q(it.aws_pod_eni),
        overhead={k: q(v) for k, v in it.overhead.items()}, price=it.price)


def scalar(catalog, allowed, required):
    return [adapter._validate(it, allowed, required) is None for it in catalog]


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_fuzz_mask_matches_scalar_validator_and_jax(seed):
    """60 windows a seed, each a batch of 1-5 schedules over one random
    catalog of 0-12 types: None allowed sets (rejected, Go sets.Has(nil)),
    empty sets, out-of-vocabulary values, GPU exclusivity both ways, ENI,
    and (capacity type, zone) offering pairs. Every verdict equals the
    port's scalar validator; every fifth window also the JAX package's
    device mask."""
    rng = random.Random(seed)
    for case in range(60):
        jcat = [rand_instance_type(rng, i) for i in range(rng.randint(0, 12))]
        catalog = [to_port(it) for it in jcat]
        pairs = [(_rand_allowed_oov(rng), _rand_required(rng))
                 for _ in range(rng.randint(1, 5))]
        mask = device_filter.compute_mask(catalog, pairs, device="cpu")
        assert mask is not None and mask.shape == (len(pairs), len(catalog))
        for s, (allowed, required) in enumerate(pairs):
            assert list(mask[s]) == scalar(catalog, allowed, required), \
                f"seed {seed} case {case} schedule {s}"
        if case % 5 == 0:
            want = jax_device_filter.compute_mask(jcat, pairs)
            np.testing.assert_array_equal(mask, want)


def test_constraint_derived_pairs_keep_scalar_quirks():
    """Allowed sets from random Requirements (NotIn without In collapsing
    to nothing, alias keys, Exists rows), collapsed by the JAX package's
    evaluation before either mask."""
    rng = random.Random(0xDEF1)
    for case in range(30):
        catalog = [to_port(rand_instance_type(rng, i)) for i in range(rng.randint(1, 10))]
        pairs = [(jax_adapter._allowed_sets(rand_constraints(rng)), _rand_required(rng))
                 for _ in range(3)]
        mask = device_filter.compute_mask(catalog, pairs, device="cpu")
        for s, (allowed, required) in enumerate(pairs):
            assert list(mask[s]) == scalar(catalog, allowed, required), f"case {case}"


def test_none_and_empty_allowed_reject_everything():
    rng = random.Random(2)
    catalog = [to_port(rand_instance_type(rng, i)) for i in range(6)]
    full = (frozenset(["spot", "on-demand"]), frozenset(["us-1a", "us-1b", "eu-9a"]),
            frozenset(f"it-{j}" for j in range(7)), frozenset(["amd64", "arm64"]),
            frozenset(["linux", "windows", "bottlerocket"]))
    assert device_filter.compute_mask(catalog, [(full, frozenset())], device="cpu").any()
    for axis in range(5):
        for hole in (None, frozenset()):
            allowed = tuple(hole if i == axis else a for i, a in enumerate(full))
            mask = device_filter.compute_mask(catalog, [(allowed, frozenset())], device="cpu")
            assert mask is not None and not mask.any()


def test_ct_vocab_overflow_returns_none_and_is_counted():
    rng = random.Random(3)
    its = [to_port(rand_instance_type(rng, 0)) for _ in range(40)]
    for i, it in enumerate(its):
        it.offerings = [port_spi.Offering(f"ct-kind-{i}", "us-1a")]
    device_filter.reset_fallback_counts()
    assert device_filter.planes_for(its) is None
    assert device_filter.fallback_counts() == {"ct-vocab-overflow": 1}
    assert device_filter.compute_mask(its, [(_rand_allowed(rng), frozenset())],
                                      device="cpu") is None
    assert device_filter.fallback_counts() == {"ct-vocab-overflow": 1}  # cached


def test_window_program_outputs():
    """window_mask: last_valid is the largest feasible type (0 for a row
    with none, where any-feasible is False) and the probe columns are the
    mask's."""
    rng = random.Random(9)
    catalog = [to_port(rand_instance_type(rng, i)) for i in range(11)]
    pairs = [(_rand_allowed(rng), _rand_required(rng)) for _ in range(6)]
    pairs.append(((None,) * 5, frozenset()))
    planes = device_filter.planes_for(catalog)
    rows = [device_filter.schedule_row(planes, a, r) for a, r in pairs]
    stacked = device_filter._stack_rows(planes, rows, len(rows))
    dev = torch.device("cpu")
    probe_idx = device_filter._probe_indices(planes.n)
    *rows_d, probe_d = to_device_int32([*stacked, probe_idx], dev)
    mask, lv, any_feas, probe = device_filter.window_mask(
        device_filter.resident_planes(planes, dev), tuple(rows_d), probe_d.long())
    mask = mask.numpy()
    assert mask.shape == (len(pairs), planes.TB) and not mask[:, planes.n:].any()
    for b, (allowed, required) in enumerate(pairs):
        ref = scalar(catalog, allowed, required)
        assert list(mask[b, :planes.n]) == ref
        feasible = np.flatnonzero(ref)
        assert bool(any_feas[b]) == bool(feasible.size)
        assert int(lv[b]) == (int(feasible[-1]) if feasible.size else 0)
        assert lv.dtype == torch.int32
    np.testing.assert_array_equal(probe.numpy(), mask[:, probe_idx])
    assert list(probe_idx[:11]) == list(range(11))  # small catalog: every column


def test_planes_stay_resident_per_catalog():
    rng = random.Random(4)
    catalog = [to_port(rand_instance_type(rng, i)) for i in range(5)]
    planes = device_filter.planes_for(catalog)
    assert device_filter.planes_for(catalog) is planes
    a = device_filter.resident_planes(planes, torch.device("cpu"))
    assert device_filter.resident_planes(planes, torch.device("cpu")) is a
    assert all(t.dtype == torch.int32 for t in a)


def test_universe_feasible_subsequence_equals_host_order():
    """The order proof, fuzzed as the JAX package fuzzes it: the universe
    packables' stable (cpu, memory) order restricted to a fused-eligible
    feasible subset equals the host comparator's sorted feasible list,
    including its ties; and the port's universe order equals the JAX
    package's type for type."""
    rng = random.Random(0xBEEF)
    for case in range(80):
        jcat = [rand_instance_type(rng, i) for i in range(rng.randint(1, 14))]
        catalog = [to_port(it) for it in jcat]
        allowed = _rand_allowed(rng)
        required = _rand_required(rng)
        if len(required & set(device_filter._GPU_CLASSES)) >= 3:
            continue  # kept off the fused path by the same rule
        _, host_types = adapter.build_packables(
            catalog, port_constraints(allowed), [], [], required=required)
        _, uni_types, _ = adapter.build_universe_packables(catalog)
        feasible = [it for it in uni_types if adapter._validate(it, allowed, required) is None]
        assert [id(it) for it in feasible] == [id(it) for it in host_types], f"case {case}"
        _, jax_uni, _ = jax_adapter.build_universe_packables(jcat)
        assert [catalog.index(it) for it in uni_types] == [jcat.index(it) for it in jax_uni]


def port_constraints(allowed):
    """Constraints whose allowed sets are exactly ``allowed`` (the memo the
    packables build reads, seeded so no requirement list is needed)."""
    from karpenter_tpu_torch.api.constraints import Constraints

    c = Constraints()
    c.__dict__["_allowed_sets_memo"] = (adapter._fingerprint(c), allowed)
    return c


def test_universe_packables_copy_and_version_contract():
    rng = random.Random(5)
    catalog = [to_port(rand_instance_type(rng, i)) for i in range(6)]
    p1, t1, v1 = adapter.build_universe_packables(catalog)
    p2, t2, v2 = adapter.build_universe_packables(catalog)
    assert v1 == v2 and [id(t) for t in t1] == [id(t) for t in t2]
    assert p1[0] is not p2[0] and p1[0].reserved == p2[0].reserved
    p1[0].reserved[0] += 1  # a caller's mutation does not reach the cache
    assert adapter.build_universe_packables(catalog)[0][0].reserved == p2[0].reserved
    refreshed = [to_port(rand_instance_type(random.Random(5), i)) for i in range(6)]
    assert adapter.build_universe_packables(refreshed)[2] != v1  # new objects, new version
    daemon_vecs = ((_q(1).nano, 0, 0, 0, 0, 0, 0, 0),)
    assert adapter.build_universe_packables(catalog, daemon_vecs=daemon_vecs)[2] != v1


def test_allowed_sets_memo_follows_the_requirement_list():
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.api.constraints import Constraints
    from karpenter_tpu_torch.api.core import NodeSelectorRequirement

    c = Constraints()
    first = adapter.allowed_sets_cached(c)
    assert adapter.allowed_sets_cached(c) is first
    c.requirements.items.append(NodeSelectorRequirement(
        key=wellknown.LABEL_TOPOLOGY_ZONE, operator="In", values=["z"]))
    assert adapter.allowed_sets_cached(c)[1] == frozenset(["z"])


def test_kill_switch(monkeypatch):
    for value, on in (("0", False), ("off", False), ("false", False), ("1", True), ("", True)):
        monkeypatch.setenv("KARPENTER_DEVICE_FILTER", value)
        assert device_filter.enabled() is on
