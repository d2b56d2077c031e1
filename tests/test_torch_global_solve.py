"""The port's global window backend and repack relaxation against the JAX
package's (ops/global_solve, solver/global_solve, solver/relax).

Each window is built separately in both packages from the same seeded
numbers: ``random_window`` (the JAX package's own test windows, seeds 1, 7
and 42), config_14's 12-schedule priced window (bench.py), and the edge
windows (an empty schedule, an unpriced catalog, more schedules than
``max_schedules``, an unencodable pod). The port runs on the CPU
(``device="cpu"``); the JAX package runs its jitted XLA program on the CPU
(``device_min_cells=0``) and, for the program alone, also its numpy mirror.

The encoding is integer and float32 arithmetic in the same order in both
packages, so it is held bit for bit. The relaxation program may sum float32
in another order than XLA (a multiply and a sum per resource where XLA
contracts the resource axis, another reduction tree), so its node counts
are held within 1e-5 absolute plus 1e-5 relative of XLA's (on a CPU they
have differed by at most one ulp, 1.2e-7 at a node count of 1.8), and
within 1e-4 plus 1e-4 relative of the JAX package's numpy mirror, whose
einsums sum in yet another order: XLA itself differs from the mirror by up
to 1.5e-4 at a node count of 5.13 on config_14's window. What leaves the solve is held
exactly: every schedule's verdict, support, micro-$ costs and accepted node
set. The adaptive support controller is process-wide in both packages, so
every test starts both at the strict corner and solves windows in the same
order.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.cloudprovider import spi as jax_spi
from karpenter_tpu.cloudprovider.fake.provider import make_instance_type as jax_make_it
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.models.cost import effective_price as jax_effective_price
from karpenter_tpu.ops import global_solve as jax_gops
from karpenter_tpu.solver import batch_solve as jax_batch
from karpenter_tpu.solver import global_solve as jax_gs
from karpenter_tpu.solver import host_ffd as jax_host_ffd
from karpenter_tpu.solver import relax as jax_relax
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu.solver.adapter import build_packables_cached as jax_build_packables
from karpenter_tpu.solver.adapter import marshal_pods_interned as jax_marshal_pods
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.cloudprovider import spi as port_spi
from karpenter_tpu_torch.models.cost import effective_price as port_effective_price
from karpenter_tpu_torch.ops import global_solve as port_gops
from karpenter_tpu_torch.solver import batch_solve as port_batch
from karpenter_tpu_torch.solver import global_solve as port_gs
from karpenter_tpu_torch.solver import host_ffd as port_host_ffd
from karpenter_tpu_torch.solver import relax as port_relax
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.solver.adapter import build_packables as port_build_packables
from karpenter_tpu_torch.solver.adapter import marshal_pods as port_marshal_pods

SEEDS = (1, 7, 42)
ITERS = 300
# float32 sums in another order than XLA's: see the module docstring
ATOL = RTOL = 1e-5
MIRROR_ATOL = MIRROR_RTOL = 1e-4
FALLBACK_REASONS = {
    "empty", "window-cap", "unpriced", "unencodable", "no-support",
    "infeasible", "costlier", "unverified", "error",
}
SHAPES = [("1", "2Gi"), ("2", "4Gi"), ("4", "8Gi"), ("500m", "1Gi")]
PRICED = [("small", "8", "16Gi", 1.0), ("mid", "16", "32Gi", 3.5),
          ("big", "32", "64Gi", 10.0)]


@pytest.fixture(autouse=True)
def fresh_support_controllers(monkeypatch):
    """Both packages' support controllers at the strict corner, and a fresh
    watchdog for the JAX package's device path."""
    jax_gops.SUPPORT.reset()
    port_gops.SUPPORT.reset()
    monkeypatch.setattr(jax_solve_mod, "_WATCHDOG", jax_solve_mod._DeviceWatchdog())
    port_solve_mod.reset_executor_counts()
    yield
    jax_gops.SUPPORT.reset()
    port_gops.SUPPORT.reset()


# -- windows, built in either package ----------------------------------------

def pkg_api(pkg):
    if pkg == "jax":
        return (jax_core, jax_make_it, jax_spi.Offering, jax_universe, jax_batch.Problem)
    return (port_core, port_spi.make_instance_type, port_spi.Offering,
            port_solve_mod.universe_constraints, port_batch.Problem)


def catalog(pkg, spec=PRICED):
    _, make_it, offering, _, _ = pkg_api(pkg)
    return [make_it(name=n, cpu=c, memory=m, pods="110",
                    offerings=[offering("on-demand", "z1")], price=p)
            for n, c, m, p in spec]


def req_pod(pkg, cpu, mem, name=""):
    core = pkg_api(pkg)[0]
    pod = core.Pod(spec=core.PodSpec(containers=[core.Container(
        resources=core.ResourceRequirements.make(requests={"cpu": cpu, "memory": mem}))]))
    pod.metadata.name = name
    return pod


def random_window(pkg, seed, n_scheds=5, spec=PRICED):
    """tests/test_global_solve.py's window: ``n_scheds`` schedules of 3-24
    pods drawn from four shapes, over one priced catalog."""
    rng = random.Random(seed)
    _, _, _, universe, problem = pkg_api(pkg)
    cat = catalog(pkg, spec)
    constraints = universe(cat)
    problems = []
    for b in range(n_scheds):
        pods = [req_pod(pkg, *rng.choice(SHAPES), name=f"p{b}-{j}")
                for j in range(rng.randint(3, 24))]
        problems.append(problem(constraints=constraints, pods=pods, instance_types=cat))
    return problems


def config14_window(pkg):
    """bench.py:1554-1616: 12 schedules of one shape each (270 pods) over
    six types whose price per cpu spreads 4x."""
    _, make_it, offering, universe, problem = pkg_api(pkg)

    def t(name, cpu, ratio, price):
        return make_it(name=name, cpu=str(cpu), memory=f"{cpu * ratio}Gi",
                       pods=str(min(110, cpu * 15)),
                       offerings=[offering("on-demand", f"bench-zone-{z + 1}")
                                  for z in range(3)], price=price)

    cat = [t("gw-small-8", 8, 4, 0.40), t("gw-small-12", 12, 4, 0.66),
           t("gw-mid-16", 16, 4, 1.92), t("gw-mid-24", 24, 4, 3.36),
           t("gw-big-32", 32, 4, 6.40), t("gw-big-48", 48, 4, 10.56)]
    shapes = [(1000, 2048), (2000, 4096), (500, 1024), (4000, 8192)]
    problems = []
    for b in range(12):
        c, m = shapes[b % len(shapes)]
        pods = [req_pod(pkg, f"{c}m", f"{m}Mi", name=f"gw{b}-{j}")
                for j in range(10 + (b * 7) % 26)]
        problems.append(problem(constraints=universe(cat), pods=pods, instance_types=cat))
    return problems


def edge_window(pkg, kind):
    problems = random_window(pkg, 5, n_scheds=3)
    if kind == "empty":
        problems[1].pods = []
    elif kind == "unpriced":
        problems = random_window(pkg, 11, n_scheds=2, spec=[("free", "8", "16Gi", 0.0)])
    elif kind == "unencodable":
        # 1n of cpu beside whole cpus: no int32 scale holds the cpu column
        problems[0].pods.append(req_pod(pkg, "1n", "64Mi", name="tiny"))
    elif kind == "over_cap":
        problems = random_window(pkg, 13, n_scheds=258)
        for b, prob in enumerate(problems):
            prob.pods = prob.pods[:1 + b % 3]
    return problems


WINDOWS = ([("random", s) for s in SEEDS] + [("config_14", None)]
           + [("edge", k) for k in ("empty", "unpriced", "unencodable", "over_cap")])


def build_window(pkg, which, arg):
    if which == "random":
        return random_window(pkg, arg)
    if which == "config_14":
        return config14_window(pkg)
    return edge_window(pkg, arg)


def window_ids():
    return [f"{w}-{a}" for w, a in WINDOWS]


# -- comparisons -------------------------------------------------------------

def info_tuple(info):
    return (info.used, info.reason, info.support, info.widened, info.relax_cost_micro,
            info.ffd_cost_micro, info.iters)


def plan_canon(result, pods):
    """An accepted plan as pod names: node count, and per packing its option
    names, quantity and pods per node."""
    if result is None:
        return None
    return (result.node_count,
            [(tuple(it.name for it in p.instance_type_options), p.node_quantity,
              [[x.metadata.name for x in node] for node in p.pods]) for p in result.packings],
            [p.metadata.name for p in result.unschedulable])


def assert_conserved(result, pods):
    placed = [id(p) for pk in result.packings for node in pk.pods for p in node]
    placed += [id(p) for p in result.unschedulable]
    assert sorted(placed) == sorted(id(p) for p in pods)


def both_windows(which, arg):
    return build_window("jax", which, arg), build_window("port", which, arg)


def port_types(win):
    return torch.from_numpy(win.d_types)


# -- encode_window -----------------------------------------------------------

@pytest.mark.parametrize("which,arg", WINDOWS, ids=window_ids())
def test_encode_window_matches_bit_for_bit(which, arg):
    jprobs, pprobs = both_windows(which, arg)
    jwin = jax_gops.encode_window(jprobs, jax_solve_mod.SolverConfig().cost_config)
    pwin = port_gops.encode_window(pprobs, port_solve_mod.SolverConfig().cost_config)
    assert (pwin.b, pwin.sb, pwin.tb) == (jwin.b, jwin.sb, jwin.tb)
    for js, ps in zip(jwin.scheds, pwin.scheds, strict=True):
        assert (ps.pos, ps.reason, ps.row, ps.num_shapes, ps.num_types) == \
            (js.pos, js.reason, js.row, js.num_shapes, js.num_types)
        assert ps.prices_micro == js.prices_micro and ps.prices == js.prices
        assert [tuple(v) for v in ps.pod_vecs] == [tuple(v) for v in js.pod_vecs]
        assert ps.pod_ids == js.pod_ids
        assert [(p.index, list(p.total), list(p.reserved)) for p in ps.packables] == \
            [(p.index, list(p.total), list(p.reserved)) for p in js.packables]
        assert [it.name for it in ps.sorted_types] == [it.name for it in js.sorted_types]
    assert pwin.device_ready == jwin.device_ready
    if not jwin.device_ready:
        return
    for name in ("d_shapes", "d_counts", "d_caps", "d_prices", "d_tmask", "d_n0"):
        got, want = getattr(pwin, name), getattr(jwin, name)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), name
    # the warm start, built from counts and types per row where the program runs
    x0 = port_gs.warm_start(torch.from_numpy(pwin.d_counts), port_types(pwin), pwin.tb)
    assert np.array_equal(x0.numpy(), jwin.d_x0)


def test_window_cap_declines_overflow_schedules():
    jprobs, pprobs = both_windows("random", 5)
    jwin = jax_gops.encode_window(jprobs, jax_solve_mod.SolverConfig().cost_config,
                                  max_schedules=2)
    pwin = port_gops.encode_window(pprobs, port_solve_mod.SolverConfig().cost_config,
                                   max_schedules=2)
    reasons = [s.reason for s in pwin.scheds]
    assert reasons == [s.reason for s in jwin.scheds]
    assert reasons[:2] == [None, None] and set(reasons[2:]) == {"window-cap"}


# -- the program -------------------------------------------------------------

@pytest.mark.parametrize("which,arg", [("random", s) for s in SEEDS] + [("config_14", None)],
                         ids=[f"random-{s}" for s in SEEDS] + ["config_14"])
def test_program_matches_global_jit_and_mirror(which, arg):
    jwin = jax_gops.encode_window(build_window("jax", which, arg),
                                  jax_solve_mod.SolverConfig().cost_config)
    fn = jax_gs._global_jit(jwin.b, jwin.sb, jwin.tb, ITERS)
    want = np.asarray(fn(jwin.d_shapes, jwin.d_counts, jwin.d_caps, jwin.d_prices,
                         jwin.d_tmask, jwin.d_x0, jwin.d_n0))
    mirror = jax_gops.host_global_support(jwin, ITERS)
    t = torch.from_numpy
    x0 = t(jwin.d_x0.copy())
    got = port_gs.relax_node_counts(t(jwin.d_shapes), t(jwin.d_counts), t(jwin.d_caps),
                                    t(jwin.d_prices), t(jwin.d_tmask), x0, t(jwin.d_n0),
                                    ITERS).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, mirror, atol=MIRROR_ATOL, rtol=MIRROR_RTOL)
    # padded types and rows stay at zero
    assert np.all(got[jwin.d_tmask == 0] == 0)
    # the supports the rounding reads are the same, row for row
    for s in jwin.live:
        assert port_gops.support_positions(got[s.row], s.num_types) == \
            jax_gops.support_positions(want[s.row], s.num_types)


def test_program_leaves_its_inputs_but_x0():
    jwin = jax_gops.encode_window(random_window("jax", 7),
                                  jax_solve_mod.SolverConfig().cost_config)
    args = [torch.from_numpy(a.copy()) for a in (
        jwin.d_shapes, jwin.d_counts, jwin.d_caps, jwin.d_prices, jwin.d_tmask)]
    x0, n0 = torch.from_numpy(jwin.d_x0.copy()), torch.from_numpy(jwin.d_n0.copy())
    before = [a.clone() for a in args] + [n0.clone()]
    n = port_gs.relax_node_counts(*args, x0, n0, 5)
    assert all(torch.equal(a, b) for a, b in zip(args + [n0], before))
    assert not torch.equal(n, n0)


def test_program_runs_full_float32_and_restores_tf32():
    """The products are sums of float32 products, never a matmul, so TF32
    cannot reach them; the process's TF32 flag is neither read nor set."""
    prev = torch.backends.cuda.matmul.allow_tf32

    def forbidden(*a, **k):
        raise AssertionError("the program called a matmul")

    jwin = jax_gops.encode_window(random_window("jax", 1),
                                  jax_solve_mod.SolverConfig().cost_config)
    t = torch.from_numpy
    args = (t(jwin.d_shapes), t(jwin.d_counts), t(jwin.d_caps), t(jwin.d_prices),
            t(jwin.d_tmask))
    want = port_gs.relax_node_counts(*args, t(jwin.d_x0.copy()), t(jwin.d_n0), 3)
    names = ("bmm", "baddbmm", "matmul", "mm", "einsum")
    real = {name: getattr(torch, name) for name in names}
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for name in names:
            setattr(torch, name, forbidden)
        got = port_gs.relax_node_counts(*args, t(jwin.d_x0.copy()), t(jwin.d_n0), 3)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        for name, fn in real.items():
            setattr(torch, name, fn)
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(got, want)


def test_program_inputs_cut_only_unused_resources():
    """program_inputs keeps the resource columns some shape uses; the
    columns it drops add exact zeros, so n is the same bit for bit."""
    _, pprobs = both_windows("random", 7)
    win = port_gops.encode_window(pprobs, port_solve_mod.SolverConfig().cost_config)
    used = port_gs.used_resources(win)
    assert list(used) == list(np.flatnonzero(win.d_shapes.any(axis=(0, 1))))
    assert 0 < len(used) < win.d_shapes.shape[2]
    cut = port_gs.run_program(port_gs.program_inputs(win, torch.device("cpu")), win.tb)
    t = torch.from_numpy
    counts, types = t(win.d_counts), t(win.d_types)
    full = port_gs.relax_node_counts(
        t(win.d_shapes), counts, t(win.d_caps), t(win.d_prices), t(win.d_tmask),
        port_gs.warm_start(counts, types, win.tb), t(win.d_n0), port_gs.ITERS)
    assert torch.equal(cut, full)


# -- the whole window --------------------------------------------------------

def solve_both(jprobs, pprobs):
    want = jax_gs.solve_window_global(jprobs, jax_solve_mod.SolverConfig(),
                                      jax_gs.GlobalConfig(device_min_cells=0))
    got = port_gs.solve_window_global(pprobs, port_solve_mod.SolverConfig(),
                                      device="cpu")
    assert len(got.infos) == len(want.infos) == len(pprobs)
    for b, (gi, wi) in enumerate(zip(got.infos, want.infos)):
        assert info_tuple(gi) == info_tuple(wi), f"schedule {b}"
    for b, (gr, wr, pp, jp) in enumerate(zip(got.results, want.results, pprobs, jprobs)):
        assert plan_canon(gr, pp.pods) == plan_canon(wr, jp.pods), f"schedule {b}"
    return got, want


@pytest.mark.parametrize("which,arg", WINDOWS, ids=window_ids())
def test_window_matches_jax(which, arg):
    jprobs, pprobs = both_windows(which, arg)
    got, want = solve_both(jprobs, pprobs)
    assert port_gops.SUPPORT.rate == jax_gops.SUPPORT.rate
    live = sum(1 for i in got.infos if i.reason not in (
        "fallback-empty", "fallback-window-cap", "fallback-unpriced", "fallback-unencodable"))
    if live:
        assert want.executor == got.executor == "device-global"
        assert port_solve_mod.solver_health()["executor_counts"] == {"device-global": live}
    else:
        assert got.executor == "none"
        assert port_solve_mod.solver_health()["executor_counts"] == {}
    for info, result, prob in zip(got.infos, got.results, pprobs):
        if info.used:
            assert info.reason == "global" and result is not None
            assert result.unschedulable == []
            assert_conserved(result, prob.pods)
            assert info.relax_cost_micro < info.ffd_cost_micro
        else:
            assert result is None
            assert info.reason[len("fallback-"):] in FALLBACK_REASONS


def test_config14_accepts_the_cheaper_fleet():
    """config_14's window: the schedules the relaxation accepts are held to
    the exact gates, and the composed fleet is cheaper than FFD's."""
    jprobs, pprobs = both_windows("config_14", None)
    got, _ = solve_both(jprobs, pprobs)
    pwin = port_gops.encode_window(pprobs, port_solve_mod.SolverConfig().cost_config)
    assert got.accepted >= 1
    ffd_total = sum(i.ffd_cost_micro for i in got.infos)
    composed = sum(i.relax_cost_micro if r is not None else i.ffd_cost_micro
                   for i, r in zip(got.infos, got.results))
    assert composed < ffd_total
    for s, info, result in zip(pwin.scheds, got.infos, got.results):
        if result is None:
            continue
        ffd = port_host_ffd.pack(s.pod_vecs, s.pod_ids, s.packables)
        assert info.ffd_cost_micro == port_gops.plan_cost_micro(ffd, s.prices_micro)


def test_window_edges_decline_with_their_reasons():
    _, pprobs = both_windows("edge", "empty")
    got = port_gs.solve_window_global(pprobs, device="cpu")
    assert got.infos[1].reason == "fallback-empty" and got.results[1] is None
    _, pprobs = both_windows("edge", "unpriced")
    got = port_gs.solve_window_global(pprobs, device="cpu")
    assert got.accepted == 0 and all(i.reason == "fallback-unpriced" for i in got.infos)
    _, pprobs = both_windows("edge", "unencodable")
    got = port_gs.solve_window_global(pprobs, device="cpu")
    assert got.infos[0].reason == "fallback-unencodable"
    _, pprobs = both_windows("edge", "over_cap")
    got = port_gs.solve_window_global(pprobs, device="cpu")
    assert [i.reason for i in got.infos[256:]] == ["fallback-window-cap"] * 2


def test_single_type_window_declines_costlier():
    """One type only: the restricted rounding can never beat the full FFD,
    so every schedule declines with "costlier" in both packages."""
    spec = [("only", "8", "16Gi", 1.0)]
    jprobs = random_window("jax", 3, n_scheds=3, spec=spec)
    pprobs = random_window("port", 3, n_scheds=3, spec=spec)
    got, _ = solve_both(jprobs, pprobs)
    assert got.accepted == 0
    assert all(i.reason == "fallback-costlier" and i.relax_cost_micro >= i.ffd_cost_micro
               for i in got.infos)


def test_windows_in_sequence_move_both_controllers_alike():
    """The adaptive controller learns across windows: windows solved in the
    same order, with no reset between them, keep both packages' verdicts
    and thresholds equal."""
    order = [("random", 1), ("config_14", None), ("random", 7), ("random", 42),
             ("config_14", None)]
    rates = []
    for which, arg in order:
        jprobs, pprobs = both_windows(which, arg)
        solve_both(jprobs, pprobs)
        assert port_gops.SUPPORT.thresholds() == jax_gops.SUPPORT.thresholds()
        rates.append(port_gops.SUPPORT.rate)
    assert len(set(rates)) > 1


def test_forced_no_support_takes_the_widened_retry(monkeypatch):
    """The strict keep rule forced empty in both packages: the widened
    retry's verdicts are equal, and each accept passes the exact gates."""
    monkeypatch.setattr(jax_gs, "support_positions", lambda n, t, *thr: [])
    monkeypatch.setattr(port_gs, "support_positions", lambda n, t, *thr: [])
    accepted = 0
    for seed in SEEDS:
        jprobs, pprobs = both_windows("random", seed)
        got, _ = solve_both(jprobs, pprobs)
        for info, result, prob in zip(got.infos, got.results, pprobs):
            if info.used:
                accepted += 1
                assert info.widened and info.support > 0
                assert_conserved(result, prob.pods)
            else:
                assert info.reason == "fallback-no-support"
    assert accepted > 0


# -- exact-int seam, vocabulary, kill switch, controller, handle -------------

@pytest.mark.parametrize("price", [1.0, 0.0000014, 0.0, 3.999999, 1e30, float("inf")])
def test_price_micro_matches(price):
    assert port_gops.price_micro(price) == jax_gops.price_micro(price)
    assert port_gops.SAT_MICRO == jax_gops.SAT_MICRO == 2 ** 31 - 1


def test_plan_cost_and_verify_plan_match():
    jprobs, pprobs = both_windows("random", 42)
    jwin = jax_gops.encode_window(jprobs, jax_solve_mod.SolverConfig().cost_config)
    pwin = port_gops.encode_window(pprobs, port_solve_mod.SolverConfig().cost_config)
    for js, ps in zip(jwin.scheds, pwin.scheds):
        jffd = jax_host_ffd.pack(js.pod_vecs, js.pod_ids, js.packables)
        pffd = port_host_ffd.pack(ps.pod_vecs, ps.pod_ids, ps.packables)
        cost = port_gops.plan_cost_micro(pffd, ps.prices_micro)
        assert type(cost) is int and cost > 0
        assert cost == jax_gops.plan_cost_micro(jffd, js.prices_micro)
        vecs = dict(zip(ps.pod_ids, ps.pod_vecs))
        by_index = {p.index: p for p in ps.packables}
        assert port_gops.verify_plan(vecs, by_index, pffd)
        # a pod placed twice, a pod missing, a node on a type too small
        dup = port_host_ffd.pack(ps.pod_vecs, ps.pod_ids, ps.packables)
        dup.packings[0].pod_ids[0].append(dup.packings[0].pod_ids[0][0])
        assert not port_gops.verify_plan(vecs, by_index, dup)
        assert not jax_gops.verify_plan(dict(zip(js.pod_ids, js.pod_vecs)),
                                        {p.index: p for p in js.packables}, dup)
        short = port_host_ffd.pack(ps.pod_vecs[1:], ps.pod_ids[1:], ps.packables)
        assert not port_gops.verify_plan(vecs, by_index, short)


def test_support_rules_match():
    rows = [np.array([5.0, 0.3, 0.04, 0.0]), np.array([]), np.array([0.0, 0.0]),
            np.array([np.nan, 1.0]), np.array([np.inf, 1.0]), np.array([0.41, 0.39, 20.0])]
    for n in rows:
        T = len(n)
        assert port_gops.support_positions(n, T) == jax_gops.support_positions(n, T)
        assert port_gops.widened_support_positions(n, T) == \
            jax_gops.widened_support_positions(n, T)
        for thr in (port_gops.WIDE_SUPPORT, (0.2, 0.01)):
            assert port_gops.support_positions(n, T, *thr) == \
                jax_gops.support_positions(n, T, *thr)
    assert port_gops.support_positions(np.array([np.nan, 1.0]), 2) == []
    assert (port_gops.STRICT_SUPPORT, port_gops.WIDE_SUPPORT) == \
        (jax_gops.STRICT_SUPPORT, jax_gops.WIDE_SUPPORT)


def test_controller_follows_the_same_sequence():
    rng = random.Random(5)
    jc, pc = jax_gops.SupportController(), port_gops.SupportController()
    assert pc.thresholds() == jc.thresholds() == port_gops.STRICT_SUPPORT
    for _ in range(60):
        ok = rng.random() < 0.3
        jc.note(ok)
        pc.note(ok)
        assert pc.thresholds() == jc.thresholds() and pc.rate == jc.rate
    pc.reset()
    assert pc.thresholds() == port_gops.STRICT_SUPPORT


def test_fetch_is_idempotent():
    _, pprobs = both_windows("random", 7)
    handle = port_gs.dispatch_global_window(pprobs, device="cpu")
    first = handle.fetch()
    assert handle.fetch() is first
    assert port_solve_mod.solver_health()["executor_counts"] == {
        "device-global": len(handle.win.live)}
    assert handle.dispatch_seconds > 0 and handle.round_seconds > 0


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    _, pprobs = both_windows("random", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_gs.dispatch_global_window(pprobs)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_gs.solve_window_global(pprobs)
    prob = pprobs[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_relax.relax_solve(prob.constraints, prob.pods, prob.instance_types)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_relax.relax_pack([], [], [], [])


# -- no fallback -------------------------------------------------------------

def test_program_error_raises_out_of_dispatch(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(port_gs, "relax_node_counts", broken)
    _, pprobs = both_windows("random", 1)
    with pytest.raises(RuntimeError, match="injected"):
        port_gs.dispatch_global_window(pprobs, device="cpu")
    assert port_solve_mod.solver_health()["executor_counts"] == {}


def test_copy_error_raises_out_of_every_fetch():
    class Lost:
        def cpu(self):
            raise RuntimeError("injected copy fault")

    _, pprobs = both_windows("random", 7)
    handle = port_gs.dispatch_global_window(pprobs, device="cpu")
    handle.n_device = Lost()
    with pytest.raises(RuntimeError, match="injected"):
        handle.fetch()
    with pytest.raises(RuntimeError, match="earlier fetch"):
        handle.fetch()
    assert port_solve_mod.solver_health()["executor_counts"] == {}


def test_non_finite_node_counts_decline(monkeypatch):
    """A NaN from the program is not clamped: the window declines every
    live schedule with no-support (the widened retry finds none either),
    and the repack declines with non-finite."""
    real = port_gs.relax_node_counts

    def nan(*a, **k):
        n = real(*a, **k)
        n[..., 0] = float("nan")
        return n

    monkeypatch.setattr(port_gs, "relax_node_counts", nan)
    _, pprobs = both_windows("random", 42)
    got = port_gs.solve_window_global(pprobs, device="cpu")
    assert got.accepted == 0
    assert all(i.reason == "fallback-no-support" for i in got.infos)
    vecs, ids, packables, sorted_types, prices = port_problem(pprobs[0])
    _, info = port_relax.relax_pack(vecs, ids, packables, prices, device="cpu")
    assert not info.used and info.reason == "fallback-non-finite"


# -- B8: the repack relaxation -----------------------------------------------

def jax_problem(prob):
    """One problem prepared as the JAX package's relax_solve prepares it."""
    vecs, required, _ = jax_marshal_pods(prob.pods)
    packables, sorted_types = jax_build_packables(
        prob.instance_types, prob.constraints, prob.pods, prob.daemons, required=required)
    order = sorted(range(len(vecs)), key=lambda i: (-vecs[i][0], -vecs[i][1]))
    prices = [jax_effective_price(it, prob.constraints.requirements)[0] for it in sorted_types]
    prices = [0.0 if p == float("inf") else p for p in prices]
    return [vecs[i] for i in order], order, packables, sorted_types, prices


def port_problem(prob):
    vecs, required = port_marshal_pods(prob.pods)
    packables, sorted_types = port_build_packables(
        prob.instance_types, prob.constraints, prob.pods, prob.daemons, required=required)
    order = sorted(range(len(vecs)), key=lambda i: (-vecs[i][0], -vecs[i][1]))
    prices = [port_effective_price(it, prob.constraints.requirements)[0] for it in sorted_types]
    prices = [0.0 if p == float("inf") else p for p in prices]
    return [vecs[i] for i in order], order, packables, sorted_types, prices


def relax_tuple(info):
    return (info.used, info.reason, info.relax_cost, info.ffd_cost, info.support, info.iters)


def host_canon(result):
    return ([(p.instance_type_indices, p.node_quantity, p.pod_ids) for p in result.packings],
            result.unschedulable)


@pytest.mark.parametrize("which,arg", [("random", s) for s in SEEDS] + [("config_14", None)],
                         ids=[f"random-{s}" for s in SEEDS] + ["config_14"])
def test_relax_pack_matches_jax(which, arg):
    jprobs, pprobs = both_windows(which, arg)
    used = 0
    for b, (jp, pp) in enumerate(zip(jprobs, pprobs)):
        jv, jids, jpk, _, jprices = jax_problem(jp)
        pv, pids, ppk, _, pprices = port_problem(pp)
        assert (pv, pids, pprices) == (jv, jids, jprices)
        want, winfo = jax_relax.relax_pack(jv, jids, jpk, jprices)
        got, ginfo = port_relax.relax_pack(pv, pids, ppk, pprices, device="cpu")
        assert relax_tuple(ginfo) == relax_tuple(winfo), f"schedule {b}"
        assert host_canon(got) == host_canon(want), f"schedule {b}"
        used += ginfo.used
    if which == "config_14":
        assert used >= 1


def test_relax_pack_edges_match_jax():
    jprobs, pprobs = both_windows("edge", "unpriced")
    for jp, pp in zip(jprobs, pprobs):
        jv, jids, jpk, _, jprices = jax_problem(jp)
        pv, pids, ppk, _, pprices = port_problem(pp)
        _, winfo = jax_relax.relax_pack(jv, jids, jpk, jprices)
        _, ginfo = port_relax.relax_pack(pv, pids, ppk, pprices, device="cpu")
        assert relax_tuple(ginfo) == relax_tuple(winfo) and ginfo.reason == "fallback-unpriced"
    _, ginfo = port_relax.relax_pack([], [], [], [], device="cpu")
    assert ginfo.reason == "fallback-empty"


@pytest.mark.parametrize("seed", SEEDS)
def test_relax_solve_matches_jax(seed):
    jprobs, pprobs = both_windows("random", seed)
    jp, pp = jprobs[0], pprobs[0]
    want, winfo = jax_relax.relax_solve(jp.constraints, jp.pods, jp.instance_types,
                                        config=jax_solve_mod.SolverConfig(device_timeout_s=0))
    got, ginfo = port_relax.relax_solve(pp.constraints, pp.pods, pp.instance_types,
                                        device="cpu")
    assert relax_tuple(ginfo) == relax_tuple(winfo)
    assert plan_canon(got, pp.pods) == plan_canon(want, jp.pods)
