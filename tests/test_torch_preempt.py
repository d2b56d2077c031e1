"""The port's preemption budget against the JAX package's, on the same sequences.

Both packages' ``PreemptionBudget`` receive the same seeded sequence of
gang windows: a ``tick``, candidates from every band with random
displacement prices and repeated gang keys, ``admit``, and a ``charge``
for a random subset of the admitted candidates. After every step the
admitted gang keys (in order), each band's tokens, each gang's cooldown
and the declines by reason (the JAX package's
``karpenter_preemption_budget_declines_total``, the port's
``declines``) must be equal. Exact: everything here is an integer.
"""

import random

import numpy as np
import pytest

from karpenter_tpu.metrics.topology import PREEMPTION_BUDGET_DECLINES_TOTAL
from karpenter_tpu.scheduling.preempt_budget import PreemptionBudget as JaxBudget
from karpenter_tpu.solver.gang import PreemptCandidate as JaxCandidate
from karpenter_tpu_torch.scheduling.preempt_budget import DEFAULT_CAPACITY
from karpenter_tpu_torch.scheduling.preempt_budget import PreemptionBudget as PortBudget
from karpenter_tpu_torch.solver.gang import PreemptCandidate as PortCandidate

BANDS = ("high", "default", "low", "besteffort", "unknown")


def jax_declines():
    return {dict(k)["reason"]: v for k, v in PREEMPTION_BUDGET_DECLINES_TOTAL.collect().items()}


def candidates(cls, draws):
    return [cls(gang_key=("ns", f"g{g}"), bin_index=0, node=f"n{g % 3}", band=band,
                pods=[("ns", f"g{g}-m0")], cells=np.arange(4), refund=[1, 1],
                displacement_cost=cost) for g, band, cost in draws]


@pytest.mark.parametrize("kwargs", [{}, {"capacity": {"low": 2, "default": 1},
                                         "refill_per_window": 2, "cooldown_windows": 1},
                                    {"cooldown_windows": 0, "refill_per_window": 0}])
@pytest.mark.parametrize("seed", [1, 7, 42])
def test_budget_equals_jax(seed, kwargs):
    rng = random.Random(seed)
    jax_b, port_b = JaxBudget(**kwargs), PortBudget(**kwargs)
    before = jax_declines()
    for window in range(30):
        if rng.random() < 0.9:
            jax_b.tick()
            port_b.tick()
        draws = [(rng.randrange(12), rng.choice(BANDS), round(rng.random(), 2))
                 for _ in range(rng.randrange(0, 9))]
        got = port_b.admit(candidates(PortCandidate, draws))
        want = jax_b.admit(candidates(JaxCandidate, draws))
        assert [c.gang_key for c in got] == [c.gang_key for c in want], f"window {window}"
        for c_p, c_j in zip(got, want):
            if rng.random() < 0.6:
                port_b.charge(c_p.gang_key, c_p.band)
                jax_b.charge(c_j.gang_key, c_j.band)
        for band in BANDS:
            assert port_b.tokens(band) == jax_b.tokens(band)
        for g in range(12):
            assert port_b.in_cooldown(("ns", f"g{g}")) == jax_b.in_cooldown(("ns", f"g{g}"))
        after = jax_declines()
        assert port_b.declines == {r: after[r] - before.get(r, 0.0)
                                   for r in after if after[r] != before.get(r, 0.0)}


def test_default_capacity_equals_jax():
    from karpenter_tpu.scheduling import preempt_budget as jax_module

    assert DEFAULT_CAPACITY == jax_module.DEFAULT_CAPACITY
    assert PortBudget().tokens("low") == JaxBudget().tokens("low") == 4
    assert PortBudget().tokens("system-critical") == 0
