"""The port's packing policies and window scoring against the JAX package's.

Catalogs, windows and pods are built separately in each package from the
same seeded draws (tests/test_policy.py's priced catalog: spot offerings
with interruption rates in two zones). Every comparison is exact (int32
micro-$ rows, strings, plans: tolerance 0):

- ``score_fused_window`` (B6): the port's program on the CPU against the
  JAX package's jitted ``_score_jit`` on the CPU, member for member on
  every column, under each of the three policies, with and without
  soft-affinity votes, at weight 0 and under the ``KARPENTER_SOFT_AFFINITY``
  kill switch; the count of viable cells against the JAX package's metric;
  every row also against the port's own numpy mirror (``_host_best``);
  the sabotage heal;
- ``steer_zone`` over tests/test_soft_affinity.py's TestSteerZone cases;
- ``whatif_repack_cost``, ``soft_zone_adjust``, ``fleet_prices`` with the
  reclaim tax;
- ``solve_batch`` (fused: the program's rows; not fused: the host loop with
  its soft adjustment) and solo ``solve()`` under each policy, plan for plan.
"""

import random

import numpy as np
import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wellknown
from karpenter_tpu.cloudprovider import spi as jax_spi
from karpenter_tpu.cloudprovider.fake.provider import make_instance_type as jax_make_it
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.metrics.policy import POLICY_CELLS_SCORED_TOTAL
from karpenter_tpu.models import consolidate as jax_consolidate
from karpenter_tpu.models.cost import CostConfig as JaxCostConfig
from karpenter_tpu.ops import device_filter as jax_df
from karpenter_tpu.ops import policy as jax_ops_policy
from karpenter_tpu.solver import batch_solve as jax_batch
from karpenter_tpu.solver import policy as jax_policy
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu.solver.adapter import marshal_pods_interned as jax_marshal_pods
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch.cloudprovider import spi as port_spi
from karpenter_tpu_torch.controllers import consolidation as port_consolidation
from karpenter_tpu_torch.models import consolidate as port_consolidate
from karpenter_tpu_torch.models.cost import CostConfig as PortCostConfig
from karpenter_tpu_torch.models.ffd import encode_prices
from karpenter_tpu_torch.ops import device_filter as port_df
from karpenter_tpu_torch.ops import policy as port_ops_policy
from karpenter_tpu_torch.solver import batch_solve as port_batch
from karpenter_tpu_torch.solver import policy as port_policy
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.solver.adapter import marshal_pods_interned as port_marshal_pods
from tests.test_torch_solve import canonical

SEEDS = (1, 7, 42)
POLICIES = ("cheapest", "interruption-priced", "throughput-per-dollar")


class Pkg:
    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.core = jax_core if jax else port_core
        self.wk = jax_wellknown if jax else port_wellknown
        self.spi = jax_spi if jax else port_spi
        self.make_it = jax_make_it if jax else port_spi.make_instance_type
        self.universe = jax_universe if jax else port_solve_mod.universe_constraints
        self.policy = jax_policy if jax else port_policy
        self.ops_policy = jax_ops_policy if jax else port_ops_policy
        self.batch = jax_batch if jax else port_batch
        self.solve = jax_solve_mod if jax else port_solve_mod
        self.CostConfig = JaxCostConfig if jax else PortCostConfig
        self.consolidate = jax_consolidate if jax else port_consolidate

    def config(self, **kw):
        if self.name == "jax":
            return jax_solve_mod.SolverConfig(device_min_pods=1, device_timeout_s=0, **kw)
        return port_solve_mod.SolverConfig(device_min_pods=0, **kw)

    def context(self, **kw):
        return self.policy.PolicyContext(**kw)


JAX, PORT = Pkg("jax"), Pkg("port")


@pytest.fixture(autouse=True)
def fresh_state():
    port_ops_policy.clear_caches()
    jax_ops_policy.clear_caches()
    yield
    port_ops_policy.clear_caches()
    jax_ops_policy.clear_caches()


def catalog(pkg, n=12, seed=0, rates=True):
    """tests/test_policy.py's ``_catalog`` in ``pkg``."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        cpu = rng.choice([2, 4, 8, 16, 32])
        price = round(0.04 * cpu * rng.uniform(0.8, 1.3), 4)
        offerings = [pkg.spi.Offering(ct, f"zone-{z + 1}", interruption_rate=(
            round(rng.uniform(0.01, 0.2), 4) if ct == "spot" and rates else 0.0))
            for z in range(2) for ct in ("on-demand", "spot")]
        out.append(pkg.make_it(name=f"t{i}-{cpu}c", cpu=str(cpu), memory=f"{cpu * 4}Gi",
                               pods=str(cpu * 8), price=price, offerings=offerings))
    return out


def pod(pkg, name, cpu, mem):
    c = pkg.core
    return c.Pod(metadata=c.ObjectMeta(name=name), spec=c.PodSpec(containers=[c.Container(
        resources=c.ResourceRequirements.make(requests={"cpu": cpu, "memory": mem}))]))


def problems(pkg, cat, seed, n=4, soft=False, open_zones=False):
    """tests/test_policy.py's ``_problems`` (one zone a problem), or with
    ``soft`` tests/test_soft_affinity.py's ``_soft_problems`` (zones pinned
    or open, random zone vote maps)."""
    rng = random.Random(seed)
    constraints = pkg.universe(cat)
    zones = sorted({o.zone for it in cat for o in it.offerings})
    out = []
    for b in range(n):
        reqs = constraints.requirements
        if not open_zones and (not soft or rng.random() < 0.5):
            z = f"zone-{1 + b % 2}" if not soft else rng.choice(zones)
            reqs = reqs.add(pkg.core.NodeSelectorRequirement(
                key=pkg.wk.LABEL_TOPOLOGY_ZONE, operator="In", values=[z]))
        tightened = constraints.deepcopy()
        tightened.requirements = reqs
        pods = [pod(pkg, f"p{b}-{j}", f"{rng.choice([100, 250, 500, 1000])}m",
                    f"{rng.choice([128, 512, 1024])}Mi")
                for j in range(rng.randint(40, 120))]
        votes = None
        if soft and rng.random() < 0.75:
            votes = {(pkg.wk.LABEL_TOPOLOGY_ZONE, z): rng.choice([-100, -7, 1, 42, 100])
                     for z in rng.sample(zones, rng.randint(1, len(zones)))}
        out.append(pkg.batch.Problem(constraints=tightened, pods=pods, instance_types=cat,
                                     soft_affinity=votes))
    return out


def fused_of(pkg, probs):
    if pkg.name == "jax":
        cfg = pkg.config()
        marshaled = [jax_marshal_pods(p.pods) for p in probs]
        return jax_df.prepare_fused(probs, marshaled, cfg,
                                    jax_solve_mod.resolved_device_max_shapes(cfg))
    return port_df.prepare_fused(probs, [port_marshal_pods(p.pods) for p in probs], "cpu")


def context_kw(name, cat_names, repack=2.0, soft_cost=0.001):
    kw = {"soft_affinity_cost_per_weight": soft_cost}
    if name == "interruption-priced":
        kw["repack_cost_per_hour"] = repack
    if name == "throughput-per-dollar":
        kw["throughput"] = {cat_names[0]: 2.0, cat_names[1]: 0.5, cat_names[2]: 0.0}
    return kw


def score_both(seed, name, soft=False, **ctx_over):
    """Score one window in both packages; returns (port rows, port cells,
    JAX rows, JAX cells, the port's fused batch and tables input)."""
    jcat, pcat = catalog(JAX, seed=seed), catalog(PORT, seed=seed)
    kw = context_kw(name, [it.name for it in pcat], **ctx_over)
    jfused = fused_of(JAX, problems(JAX, jcat, seed, soft=soft))
    pfused = fused_of(PORT, problems(PORT, pcat, seed, soft=soft))
    assert jfused is not None and pfused is not None
    try:
        cells0 = POLICY_CELLS_SCORED_TOTAL.collect().get((), 0.0)
        jrows = jax_ops_policy.score_fused_window(
            jfused, jax_policy.get(name), JaxCostConfig(), JAX.context(**kw))
        jcells = POLICY_CELLS_SCORED_TOTAL.collect().get((), 0.0) - cells0
    finally:
        jfused.release()
    got = port_ops_policy.score_fused_window(
        pfused, port_policy.get(name), PortCostConfig(), PORT.context(**kw))
    assert jrows is not None and got is not None
    return got[0], got[1], jrows, jcells, pfused, PORT.context(**kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("soft", [False, True])
def test_window_rows_equal_the_jax_package(seed, name, soft):
    mism = port_ops_policy.MISMATCHES
    rows, cells, jrows, jcells, fused, ctx = score_both(seed, name, soft=soft)
    assert len(rows) == len(jrows)
    for a, b in zip(rows, jrows):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert cells == jcells > 0
    assert port_ops_policy.MISMATCHES == mism
    # every column against the port's own mirror, not only the probes
    planes = port_df.planes_for(fused.uni_types)
    tables = port_ops_policy.tables_for(planes, fused.uni_types, port_policy.get(name),
                                        PortCostConfig(), ctx)
    zw, cta, za = port_ops_policy._rows_host(planes, fused.verify)
    soft_bz = port_ops_policy._soft_rows(planes, fused.soft, ctx)
    assert (soft_bz is not None) == soft
    mirror = port_ops_policy._host_best(tables, planes, zw, cta, za, soft_bz=soft_bz)
    idx = [p.index for p in fused.packables]
    for b, row in enumerate(rows):
        assert np.array_equal(row[:len(idx)], mirror[b, idx])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["cheapest", "throughput-per-dollar"])
def test_penalty_free_rows_are_encode_prices_of_the_host_scores(seed, name):
    pcat = catalog(PORT, seed=seed)
    probs = problems(PORT, pcat, seed)
    fused = fused_of(PORT, probs)
    ctx = PORT.context(**context_kw(name, [it.name for it in pcat]))
    policy = port_policy.get(name)
    rows, _ = port_ops_policy.score_fused_window(fused, policy, PortCostConfig(), ctx)
    TB = port_df.planes_for(fused.uni_types).TB
    for b, i in enumerate(fused.batch_idx):
        reqs = probs[i].constraints.requirements
        want = encode_prices([policy.score(fused.uni_types[p.index], reqs, PortCostConfig(),
                                           ctx)[0] for p in fused.packables], TB)
        assert np.array_equal(rows[b], want)


@pytest.mark.parametrize("case", ["zero-weight", "kill-switch"])
def test_soft_rows_off_are_the_plain_rows(case, monkeypatch):
    """Weight 0 or KARPENTER_SOFT_AFFINITY=0: the voted window's rows equal
    the rows of the same window without votes, in both packages."""
    if case == "kill-switch":
        monkeypatch.setenv("KARPENTER_SOFT_AFFINITY", "0")
    cost = 0.0 if case == "zero-weight" else 0.001
    for pkg in (JAX, PORT):
        cat = catalog(pkg, seed=42)
        voted = problems(pkg, cat, 42, soft=True)
        plain = [pkg.batch.Problem(constraints=p.constraints, pods=p.pods,
                                   instance_types=p.instance_types) for p in voted]
        ctx = pkg.context(soft_affinity_cost_per_weight=cost)
        out = []
        for probs in (voted, plain):
            fused = fused_of(pkg, probs)
            rows = pkg.ops_policy.score_fused_window(
                fused, pkg.policy.get("cheapest"), pkg.CostConfig(), ctx)
            if pkg is JAX:
                fused.release()
            else:
                rows = rows[0]
            out.append(rows)
        for a, b in zip(*out):
            assert np.array_equal(a, b)
    _, _, jrows, _, _, _ = score_both(42, "cheapest", soft=True, soft_cost=cost)
    rows, *_ = score_both(42, "cheapest", soft=True, soft_cost=cost)
    for a, b in zip(rows, jrows):
        assert np.array_equal(a, b)


def test_sabotaged_row_heals_to_the_mirror(monkeypatch):
    """A member whose device row is wrong at a probe column gets its whole
    row from the numpy mirror, counted in MISMATCHES."""
    good, *_ = score_both(7, "interruption-priced", soft=True)
    real = port_ops_policy._cells_expr

    def sabotage(*args, **kw):
        best, cells = real(*args, **kw)
        best = best.clone()
        best[1] = 0
        return best, cells

    monkeypatch.setattr(port_ops_policy, "_cells_expr", sabotage)
    before = port_ops_policy.MISMATCHES
    healed, *_ = score_both(7, "interruption-priced", soft=True)
    assert port_ops_policy.MISMATCHES == before + 1
    for a, b in zip(healed, good):
        assert np.array_equal(a, b)


def test_unfactorable_policy_keeps_the_host_loop():
    class Custom(port_policy.ScoringPolicy):
        name = "custom"

        def score(self, it, requirements, cost_config, ctx):
            return (1.0, "on-demand")

    pcat = catalog(PORT, seed=1)
    fused = fused_of(PORT, problems(PORT, pcat, 1))
    assert port_ops_policy.score_fused_window(fused, Custom(), PortCostConfig(),
                                              PORT.context()) is None


STEER_CASES = ["positive vote", "pinned zone", "saturated tie", "irrelevant votes",
               "kill switch"]


@pytest.mark.parametrize("case", STEER_CASES)
def test_steer_zone_equals_the_jax_package(case, monkeypatch):
    if case == "kill switch":
        monkeypatch.setenv("KARPENTER_SOFT_AFFINITY", "0")
    got = []
    for pkg in (JAX, PORT):
        if case == "saturated tie":
            fake = __import__("karpenter_tpu.cloudprovider.fake.provider" if pkg is JAX
                              else "karpenter_tpu_torch.cloudprovider.fake.provider",
                              fromlist=["instance_types"])
            cat = fake.instance_types(5)
            zone = "test-zone-2"
        else:
            cat = catalog(pkg, seed=1)
            zone = "nowhere-zone" if case == "irrelevant votes" else "zone-2"
        reqs = pkg.universe(cat).requirements
        if case == "pinned zone":
            reqs = reqs.add(pkg.core.NodeSelectorRequirement(
                key=pkg.wk.LABEL_TOPOLOGY_ZONE, operator="In", values=["zone-1"]))
        soft = {(pkg.wk.LABEL_TOPOLOGY_ZONE, zone): 80 if case == "saturated tie" else 100}
        got.append(pkg.ops_policy.steer_zone(cat, reqs, pkg.CostConfig(), pkg.context(),
                                             soft))
    assert got[0] == got[1]
    assert got[1] == {"positive vote": "zone-2", "saturated tie": "test-zone-2"}.get(case)


def test_soft_zone_adjust_equals_the_jax_package():
    rng = random.Random(3)
    for _ in range(40):
        seed = rng.randint(0, 99)
        vals = [(z, rng.choice([-100, -7, 0, 1, 42, 100])) for z in ("zone-1", "zone-2", "x")]
        pin = rng.choice([None, "zone-1", "zone-2"])
        cost = rng.choice([0.0, 0.001, 0.01])
        out = []
        for pkg in (JAX, PORT):
            cat = catalog(pkg, seed=seed)
            reqs = pkg.universe(cat).requirements
            if pin:
                reqs = reqs.add(pkg.core.NodeSelectorRequirement(
                    key=pkg.wk.LABEL_TOPOLOGY_ZONE, operator="In", values=[pin]))
            votes = pkg.policy.soft_zone_votes({(pkg.wk.LABEL_TOPOLOGY_ZONE, z): w
                                                for z, w in vals})
            ctx = pkg.context(soft_affinity_cost_per_weight=cost)
            out.append([pkg.policy.soft_zone_adjust(it, reqs, votes, ctx) for it in cat])
        assert out[0] == out[1]


def vec(pkg, cpu_n, mem, pods_n=1):
    from karpenter_tpu_torch.solver import host_ffd
    v = [0] * host_ffd.NUM_RESOURCES
    v[host_ffd.R_CPU], v[host_ffd.R_MEMORY] = cpu_n, mem
    v[host_ffd.R_PODS] = pods_n * host_ffd.POD_UNIT_NANO
    return v


@pytest.mark.parametrize("case", ["refit", "no refit", "empty"])
def test_whatif_repack_cost_equals_the_jax_package(case):
    out = []
    for pkg in (JAX, PORT):
        cat = catalog(pkg)
        reqs = pkg.universe(cat).requirements
        pods = {"refit": [vec(pkg, 500 * 10**6, 512 << 20)],
                "no refit": [vec(pkg, 2 * 10**9, 1 << 30)], "empty": []}[case]
        free = [vec(pkg, 4 * 10**9, 8 << 30, 10)] if case == "refit" else []
        out.append(pkg.policy.whatif_repack_cost(pods, free, cat, reqs))
    assert out[0] == out[1]
    assert (out[1] == 0.0) == (case != "no refit")


def running_node(pkg, name, it, capacity_type, zone):
    c = pkg.core
    return c.Node(metadata=c.ObjectMeta(name=name, namespace="", labels={
        pkg.wk.LABEL_INSTANCE_TYPE: it.name, pkg.wk.LABEL_CAPACITY_TYPE: capacity_type,
        pkg.wk.LABEL_TOPOLOGY_ZONE: zone}))


@pytest.mark.parametrize("repack", [0.0, 0.5, 3.0])
def test_fleet_prices_reclaim_tax_equals_the_jax_package(repack):
    out = []
    for pkg in (JAX, PORT):
        cat = catalog(pkg, seed=5)
        nodes = [running_node(pkg, f"n{i}", it, ct, zone)
                 for i, (it, ct, zone) in enumerate(
                     (it, ct, zone) for it in cat[:6] for ct in ("spot", "on-demand")
                     for zone in ("zone-2", "stale-zone"))]
        nodes.append(running_node(pkg, "ghost", pkg.make_it(name="gone"), "spot", "zone-1"))
        kw = {"repack_cost_per_hour": repack}
        if pkg is JAX:
            prices, unknown = pkg.consolidate.fleet_prices(nodes, cat, JaxCostConfig(), **kw)
        else:
            prices, unknown = pkg.consolidate.fleet_prices(nodes, cat, **kw)
        out.append((prices, [n.metadata.name for n in unknown]))
    assert out[0] == out[1]
    assert port_consolidate.spot_interruption_rate(catalog(PORT, seed=5)[0], "stale-zone") > 0


def test_consolidation_controller_takes_the_repack_price():
    from karpenter_tpu_torch.runtime.kubecore import KubeCore
    c = port_consolidation.ConsolidationController(KubeCore(), repack_cost_per_hour=1.5,
                                                   device="cpu")
    assert c.repack_cost_per_hour == 1.5


def test_frontier_break_even():
    """ct flips from spot to on-demand exactly at rate x repack = price x
    (1 - factor), in both packages."""
    P, r = 1.0, 0.5
    for pkg in (JAX, PORT):
        it = pkg.make_it(name="fr", cpu="4", memory="8Gi", pods="16", price=P, offerings=[
            pkg.spi.Offering("on-demand", "zone-1"),
            pkg.spi.Offering("spot", "zone-1", interruption_rate=r)])
        reqs = pkg.universe([it]).requirements
        policy = pkg.policy.get("interruption-priced")
        threshold = P * (1.0 - pkg.CostConfig().spot_price_factor) / r
        for mult, want in ((0.0, "spot"), (0.5, "spot"), (0.99, "spot"),
                           (1.01, "on-demand"), (3.0, "on-demand")):
            ctx = pkg.context(repack_cost_per_hour=threshold * mult)
            assert policy.score(it, reqs, pkg.CostConfig(), ctx)[1] == want


def test_registry_equals_the_jax_package():
    assert port_policy.available() == jax_policy.available() == sorted(POLICIES)
    assert not port_policy.get("cheapest").always_tiebreak
    assert port_policy.get("interruption-priced").always_tiebreak
    with pytest.raises(KeyError):
        port_policy.get("no-such-policy")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("window", ["fused", "fused-soft", "host-loop-soft"])
def test_solve_batch_plans_equal_the_jax_package(seed, name, window):
    """solve_batch under each policy, plan for plan: a fused window takes
    the program's rows in both packages, a window without the device
    filter the per-cell host loop with its soft adjustment."""
    soft = window != "fused"
    filt = window != "host-loop-soft"
    results = []
    for pkg in (JAX, PORT):
        cat = catalog(pkg, seed=seed)
        probs = problems(pkg, cat, seed, soft=soft)
        cfg = pkg.config(packing_policy=name, device_filter=filt, policy_context=pkg.context(
            **context_kw(name, [it.name for it in cat])))
        if pkg is JAX:
            res = jax_batch.solve_batch(probs, cfg)
        else:
            port_solve_mod.reset_executor_counts()
            res = port_batch.solve_batch(probs, cfg, device="cpu")
            assert port_solve_mod.solver_health()["executor_counts"] == {"device-batch": 4}
        results.append([canonical(r, p.pods) for r, p in zip(res, probs)])
    assert results[1] == results[0]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", POLICIES)
def test_solo_solve_plans_equal_the_jax_package(seed, name):
    results = []
    for pkg in (JAX, PORT):
        cat = catalog(pkg, seed=seed)
        prob = problems(pkg, cat, seed, open_zones=True)[0]
        cfg = pkg.config(packing_policy=name, policy_context=pkg.context(
            **context_kw(name, [it.name for it in cat])))
        kw = {} if pkg is JAX else {"device": "cpu"}
        res = pkg.solve.solve(prob.constraints, prob.pods, cat, config=cfg, **kw)
        results.append(canonical(res, prob.pods))
    assert results[1] == results[0]


@pytest.mark.parametrize("name", POLICIES)
def test_batch_equals_solo_under_each_policy(name):
    """The port's window with the program's rows against its solo solve(),
    problem for problem (no votes: solo scoring has no soft term); the
    default policy scores only with the cost tie-break on."""
    cat = catalog(PORT, seed=11)
    probs = problems(PORT, cat, 11)
    cfg = PORT.config(packing_policy=name, cost_tiebreak=name == "cheapest",
                      policy_context=PORT.context(
        **context_kw(name, [it.name for it in cat])))
    runs = port_ops_policy.RUNS
    batch = port_batch.solve_batch(probs, cfg, device="cpu")
    assert port_ops_policy.RUNS == runs + 1
    for p, r in zip(probs, batch):
        solo = port_solve_mod.solve(p.constraints, p.pods, cat, config=cfg, device="cpu")
        assert canonical(r, p.pods) == canonical(solo, p.pods)
