"""The port's metrics registry, its families and the metrics controllers
against the JAX package's, on the CPU.

- **The registry.** The same seeded sequence of ``set`` / ``inc`` /
  ``observe`` (with exemplars) / ``delete`` on a fresh registry of each
  package gives the same ``expose()`` text and the same ``snapshot()``:
  exact, the values are the sequence's own numbers.
- **The families.** The series the port registers are the JAX package's
  ported families (``metrics/{core, filter, marshal, pipeline, policy,
  pressure, global_solve, consolidation, gang, topology, slo, recovery}``
  and the ``gc_*`` counters ``controllers/gc.py`` registers, read from the
  JAX package's ``DEFAULT.registered()``): the same names, types, help
  text and buckets, and every one renders with its ``# HELP``.
- **The metrics controllers.** The same store in each package's
  ``KubeCore`` gives the same node and pod gauge series, and a deleted
  node's and pod's series go.
- **Attributes kept beside their series.** The port keeps some counts as
  module attributes that its tests and ``chip_smoke.py`` read; each is held
  equal to its series here, on a run that moves it.
"""

import importlib

import numpy as np
import pytest

from karpenter_tpu.metrics import registry as jax_registry
from karpenter_tpu_torch.metrics import registry as port_registry

SEEDS = (1, 7, 42)
FAMILIES = ("core", "filter", "marshal", "pipeline", "policy", "pressure", "global_solve",
            "consolidation", "gang", "topology", "slo", "recovery")
# controllers that register series of their own beside their code
CONTROLLER_SERIES = ("gc",)


# -- the registry --------------------------------------------------------------


def drive(reg, seed):
    """A seeded sequence of every registry operation on ``reg``."""
    rng = np.random.default_rng(seed)
    gauges = [reg.gauge(f"g{i}", f"gauge {i}") for i in range(3)]
    counters = [reg.counter(f"c{i}", f"counter {i}" if i else "") for i in range(3)]
    hists = [reg.histogram("h0", "default buckets"),
             reg.histogram("h1", "custom buckets", buckets=[0.1, 1.0, 10.0])]
    labels = [{}, {"stage": "marshal"}, {"stage": "device", "shard": "2"}, {"reason": "pdb"}]
    for step in range(400):
        lab = labels[rng.integers(len(labels))]
        op = rng.integers(7)
        if op == 0:
            gauges[rng.integers(3)].set(float(rng.normal()), **lab)
        elif op == 1:
            gauges[rng.integers(3)].inc(float(rng.integers(1, 5)), **lab)
        elif op == 2:
            counters[rng.integers(3)].inc(**lab)
        elif op == 3:
            counters[rng.integers(3)].inc(amount=float(rng.integers(1, 9)), **lab)
        elif op == 4:
            ex = f"w-{step:04d}" if rng.random() < 0.5 else None
            hists[rng.integers(2)].observe(float(rng.lognormal(-1.0, 2.0)), exemplar=ex, **lab)
        elif op == 5 and rng.random() < 0.3:
            gauges[rng.integers(3)].delete(**lab)
        elif op == 6 and rng.random() < 0.2:
            gauges[rng.integers(3)].delete_matching(stage="device")
    # help attaches whatever the order: the first call had none
    reg.counter("c0", "counter 0, helped late")
    return reg


@pytest.mark.parametrize("seed", SEEDS)
def test_registry_equals_the_jax_registry(seed):
    j = drive(jax_registry.Registry(), seed)
    p = drive(port_registry.Registry(), seed)
    assert p.expose() == j.expose()
    assert p.snapshot() == j.snapshot()
    assert "# HELP karpenter_c0 counter 0, helped late" in p.expose()
    assert p.histogram("h1").buckets == [0.1, 1.0, 10.0]
    with p.histogram("h0").time(stage="timed"):
        pass
    assert p.snapshot()["h0"]["series"]['stage="timed"']["count"] == 1


def test_registry_time_and_exemplars():
    reg = port_registry.Registry()
    with reg.time("op_seconds", kind="x"):
        pass
    h = reg.histogram("op_seconds")
    h.observe(0.5, exemplar="w-1", kind="x")
    snap = reg.snapshot()["op_seconds"]["series"]['kind="x"']
    assert snap["count"] == 2 and snap["exemplar"] == {"trace_id": "w-1", "value": 0.5}
    assert 'karpenter_op_seconds_bucket{kind="x",le="+Inf"} 2' in reg.expose()
    assert port_registry.HISTOGRAMS is port_registry.DEFAULT


# -- the families ----------------------------------------------------------------


def jax_ported_families():
    """The JAX package's series defined by the ported family modules, from
    its DEFAULT registry: name -> metric object."""
    names = set()
    mods = [importlib.import_module(f"karpenter_tpu.metrics.{fam}") for fam in FAMILIES]
    mods += [importlib.import_module(f"karpenter_tpu.controllers.{c}") for c in CONTROLLER_SERIES]
    for mod in mods:
        names |= {v.name for v in vars(mod).values()
                  if isinstance(v, (jax_registry.Gauge, jax_registry.Histogram))}
    core = importlib.import_module("karpenter_tpu.metrics.core")
    names |= set(core.GAUGE_HELP) | set(core.HISTOGRAM_HELP)
    reg = jax_registry.DEFAULT.registered()
    return {n: reg[n] for n in names}


def kind(metric, mod):
    if isinstance(metric, mod.Histogram):
        return "histogram", list(metric.buckets)
    return ("counter" if isinstance(metric, mod.Counter) else "gauge"), None


def test_families_equal_the_jax_families():
    for fam in FAMILIES:
        importlib.import_module(f"karpenter_tpu_torch.metrics.{fam}")
    for c in CONTROLLER_SERIES:
        importlib.import_module(f"karpenter_tpu_torch.controllers.{c}")
    want = jax_ported_families()
    got = port_registry.DEFAULT.registered()
    assert sorted(got) == sorted(want)
    for name, metric in got.items():
        assert metric.help == want[name].help, name
        assert kind(metric, port_registry) == kind(want[name], jax_registry), name


def test_every_series_renders_with_help():
    text = port_registry.DEFAULT.expose()
    for name in port_registry.DEFAULT.registered():
        assert f"# HELP karpenter_{name} " in text, name
        assert f"# TYPE karpenter_{name} " in text, name


# -- the metrics controllers -------------------------------------------------------


def store(root, seed):
    """A seeded store in package ``root``: nodes with capacity, allocatable,
    provisioner labels and a Ready condition (or not), bound pods with
    requests and limits, daemonset-owned pods among them."""
    core = importlib.import_module(f"{root}.api.core")
    wk = importlib.import_module(f"{root}.api.wellknown")
    res = importlib.import_module(f"{root}.utils.resources")
    kube = importlib.import_module(f"{root}.runtime.kubecore").KubeCore()
    rng = np.random.default_rng(seed)
    nodes, pods = [], []
    for n in range(4):
        cpu = int(rng.integers(2, 17))
        node = core.Node(metadata=core.ObjectMeta(name=f"node-{n}", namespace="", labels={
            wk.PROVISIONER_NAME_LABEL: "default", wk.LABEL_TOPOLOGY_ZONE: f"zone-{n % 2}",
            wk.LABEL_ARCH: "amd64", wk.LABEL_CAPACITY_TYPE: "spot" if n % 2 else "on-demand",
            wk.LABEL_INSTANCE_TYPE: f"type-{cpu}"}))
        node.status.capacity = res.parse_resource_list(
            {"cpu": str(cpu), "memory": f"{cpu * 4}Gi", "pods": "110"})
        node.status.allocatable = res.parse_resource_list(
            {"cpu": f"{cpu * 1000 - 250}m", "memory": f"{cpu * 4 - 1}Gi", "pods": "110"})
        node.status.conditions = [core.NodeCondition(
            type="Ready", status="True" if n != 3 else "False")]
        kube.create(node)
        nodes.append(node.metadata.name)
        for i in range(int(rng.integers(1, 5))):
            owner = [core.OwnerReference(kind="DaemonSet", name="ds", uid="ds")] if i == 0 else []
            req = {"cpu": f"{int(rng.integers(1, 9)) * 125}m",
                   "memory": f"{int(rng.integers(1, 9)) * 128}Mi"}
            pod = core.Pod(
                metadata=core.ObjectMeta(name=f"pod-{n}-{i}", namespace="default",
                                         owner_references=owner),
                spec=core.PodSpec(node_name=node.metadata.name, containers=[core.Container(
                    resources=core.ResourceRequirements.make(
                        requests=req, limits=req if i % 2 else None))]),
                status=core.PodStatus(phase="Running"))
            kube.create(pod)
            pods.append(pod.metadata.name)
    return kube, nodes, pods


def reconcile_all(root, kube, nodes, pods):
    mc = importlib.import_module(f"{root}.controllers.metrics_controllers")
    reg = importlib.import_module(f"{root}.metrics.registry").Registry()
    node_ctl, pod_ctl = mc.NodeMetricsController(kube, reg), mc.PodMetricsController(kube, reg)
    for n in nodes:
        node_ctl.reconcile(n)
    for p in pods:
        pod_ctl.reconcile(p)
    return reg, node_ctl, pod_ctl


@pytest.mark.parametrize("seed", SEEDS)
def test_metrics_controllers_equal_the_jax_controllers(seed):
    out = {}
    for root in ("karpenter_tpu", "karpenter_tpu_torch"):
        kube, nodes, pods = store(root, seed)
        reg, node_ctl, pod_ctl = reconcile_all(root, kube, nodes, pods)
        full = reg.snapshot()
        # a node and a pod go: their series are cleaned up
        kube.delete("Node", nodes[0], "")
        node_ctl.reconcile(nodes[0])
        kube.delete("Pod", pods[-1], "default")
        pod_ctl.reconcile(pods[-1])
        out[root] = (full, reg.snapshot(), reg.expose(), node_ctl.mappings()[0][0],
                     node_ctl.kind(), pod_ctl.kind())
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]
    full, after, *_ = out["karpenter_tpu_torch"]
    assert any('node_name="node-0"' in k for k in full["nodes_allocatable"]["series"])
    assert not any('node_name="node-0"' in k
                   for name in after if name.startswith("nodes_")
                   for k in after[name]["series"])
    assert any('phase="Running"' in k for k in after["pods_state"]["series"])
    assert len(after["pods_state"]["series"]) == len(full["pods_state"]["series"]) - 1


# -- attributes kept beside their series ---------------------------------------------


def counts(name, key="reason"):
    """A port counter's series by one label's value (a histogram's by its
    count)."""
    out = {}
    for lv, v in port_registry.DEFAULT.registered()[name].collect().items():
        if isinstance(v, tuple):
            v = v[2]
        out[dict(lv).get(key, "")] = v
    return out


def delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_feasibility_heals_equal_their_series(monkeypatch):
    """An affinity matrix the device got wrong: the probe heals to the
    scalar oracle, counted once in HEALS and in the series."""
    from karpenter_tpu_torch.api import core
    from karpenter_tpu_torch.ops import device_filter, feasibility

    device_filter.clear_affinity_cache()
    real = device_filter.affinity_matrix
    monkeypatch.setattr(device_filter, "affinity_matrix",
                        lambda *a, **k: ~real(*a, **k))
    sels = [core.LabelSelector(match_labels={"app": f"a{i}"}) for i in range(3)]
    peers = [(("app", f"a{i}"),) for i in range(4)]
    heals, series = feasibility.heal_counts(), counts("filter_fallback_total")
    hist = counts("filter_batch_seconds", "stage")
    mat = feasibility.affinity_match_matrix(sels, peers, device="cpu")
    assert mat.tolist() == [[p == s for p in range(4)] for s in range(3)]
    moved = delta(heals, feasibility.heal_counts())
    assert moved == {"affinity-mismatch": 1}
    assert delta(series, counts("filter_fallback_total")) == moved
    assert delta(hist, counts("filter_batch_seconds", "stage")) == {"affinity": 1}
    device_filter.clear_affinity_cache()


def test_device_filter_counts_equal_their_series(monkeypatch):
    """A sabotaged mask program (tests/test_torch_batch_solve.py): the
    fallback counts, the member-column and affinity program counts move
    with their series."""
    from karpenter_tpu_torch.ops import device_filter
    from tests.test_torch_batch_solve import solve_both

    real = device_filter._mask_expr

    def sabotaged(*args):
        mask = real(*args).clone()
        mask[0, :] = True
        return mask

    monkeypatch.setattr(device_filter, "_mask_expr", sabotaged)
    dev_series, series = counts("filter_device_fallback_total"), counts("filter_fallback_total")
    seconds = counts("filter_device_seconds", "stage")
    solve_both(13, 4, 80, 30, 30)
    moved = device_filter.fallback_counts()  # reset by solve_both before the solve
    assert moved == {"device-mask-mismatch": 1}
    assert delta(dev_series, counts("filter_device_fallback_total")) == moved
    assert delta(series, counts("filter_fallback_total")) == moved
    assert delta(seconds, counts("filter_device_seconds", "stage")) == {"dispatch": 1,
                                                                         "verify": 1}


def test_program_runs_equal_their_histogram_counts():
    """GANG_COLUMN_RUNS and AFFINITY_RUNS count programs; each run is one
    observation of filter_device_seconds (stage gang, affinity)."""
    from karpenter_tpu_torch.api import core
    from karpenter_tpu_torch.cloudprovider.fake import provider as fake
    from karpenter_tpu_torch.ops import device_filter, feasibility
    from karpenter_tpu_torch.solver import adapter
    from karpenter_tpu_torch.solver.solve import universe_constraints

    catalog = fake.instance_types(12)
    keys = [(adapter.allowed_sets_cached(universe_constraints(catalog)), frozenset())]
    feasibility.clear_gang_cache()
    device_filter.clear_affinity_cache()
    before = (device_filter.GANG_COLUMN_RUNS, device_filter.AFFINITY_RUNS,
              counts("filter_device_seconds", "stage"))
    feasibility.gang_feasibility_mask(catalog, keys, device="cpu")
    feasibility.affinity_match_matrix([core.LabelSelector(match_labels={"app": "x"})],
                                      [(("app", "x"),)], device="cpu")
    runs = (device_filter.GANG_COLUMN_RUNS - before[0], device_filter.AFFINITY_RUNS - before[1])
    assert runs == (1, 1)
    assert delta(before[2], counts("filter_device_seconds", "stage")) == {"gang": 1,
                                                                           "affinity": 1}


def test_policy_runs_and_mismatches_equal_their_series(monkeypatch):
    """A sabotaged scoring program (tests/test_torch_policy.py): the
    mismatch heals to the mirror, counted in MISMATCHES and the series;
    each program run is one device observation."""
    from karpenter_tpu_torch.ops import policy as port_ops_policy
    from tests.test_torch_policy import score_both

    real = port_ops_policy._cells_expr

    def sabotage(*args, **kw):
        best, cells = real(*args, **kw)
        best = best.clone()
        best[1] = 0
        return best, cells

    monkeypatch.setattr(port_ops_policy, "_cells_expr", sabotage)
    before = (port_ops_policy.RUNS, port_ops_policy.MISMATCHES,
              counts("policy_fallback_total"), counts("policy_score_seconds", "stage"),
              counts("policy_cells_scored_total"))
    _, cells, *_ = score_both(7, "interruption-priced", soft=True)
    assert port_ops_policy.RUNS - before[0] == 1
    moved = delta(before[2], counts("policy_fallback_total"))
    assert sum(moved.values()) == port_ops_policy.MISMATCHES - before[1] == 1
    assert set(moved) <= {"score-mismatch", "soft-affinity-mismatch"}
    assert delta(before[3], counts("policy_score_seconds", "stage")) == {"device": 1,
                                                                          "verify": 1}
    assert delta(before[4], counts("policy_cells_scored_total")) == {"": float(cells)}


def test_catalog_rebuilds_and_arena_equal_their_series():
    """The catalog encoding cache and the marshal arena: a cold solve, a
    repeat and a churned one; CATALOG_REBUILDS and the arena's stats move
    as their series."""
    from karpenter_tpu_torch.ops import encode
    from karpenter_tpu_torch.solver.solve import solve
    from tests.test_torch_solve import build

    encode.reset_marshal_arena()
    encode.clear_catalog_encoding_cache()
    constraints, pods, catalog = build("port", 3, 300, 12, 6)
    names = ("marshal_row_cache_hits_total", "marshal_row_cache_misses_total",
             "marshal_row_cache_evictions_total", "catalog_encoding_rebuilds_total")
    before = {n: counts(n).get("", 0.0) for n in names}
    rebuilds = encode.CATALOG_REBUILDS
    for _ in range(2):
        solve(constraints, pods, catalog, device="cpu")
    encode.marshal_arena()._reset_locked(-1, -1)  # a generation reset evicts every row
    solve(constraints, pods, catalog, device="cpu")
    stats = encode.marshal_arena().stats()
    moved = {n: counts(n).get("", 0.0) - before[n] for n in names}
    assert moved == {"marshal_row_cache_hits_total": stats["hits"],
                     "marshal_row_cache_misses_total": stats["misses"],
                     "marshal_row_cache_evictions_total": stats["evictions"],
                     "catalog_encoding_rebuilds_total": encode.CATALOG_REBUILDS - rebuilds}
    assert stats["hits"] > 0 and stats["misses"] > 0 and stats["evictions"] > 0
    gauge = port_registry.DEFAULT.registered()["marshal_delta_fraction"].collect()[()]
    assert gauge == encode.marshal_arena().delta_fraction


def test_ring_counters_equal_their_series():
    """DeviceRing.counters() deltas equal the ring's series over solves that
    allocate, refill and reuse; the device-bytes gauge reads 0 off a card."""
    from karpenter_tpu_torch.solver import pipeline
    from karpenter_tpu_torch.solver.solve import solve
    from tests.test_torch_solve import build

    pipeline.reset_ring()
    constraints, pods, catalog = build("port", 5, 200, 10, 5)
    before = {k: counts(f"pipeline_ring_{k}_total").get("", 0.0)
              for k in ("allocations", "refills", "reuses")}
    for _ in range(3):
        solve(constraints, pods, catalog, device="cpu")
    ring = pipeline.get_ring().counters()
    moved = {k: counts(f"pipeline_ring_{k}_total").get("", 0.0) - before[k] for k in before}
    assert moved == {k: float(ring[k]) for k in before}
    assert ring["allocations"] and ring["refills"] and ring["reuses"]
    assert pipeline.observe_device_bytes() == 0
    assert port_registry.DEFAULT.registered()["solver_device_bytes_in_use"].collect()[()] == 0.0


def test_carve_counts_equal_their_series():
    """A fragmented seed torus (tests/test_torch_carve.py): the carve walk's
    reject, a condemned carve verdict's heal and the planner's declined
    preemption move CARVE_REJECTS, topology.HEALS and DECLINES as their
    series."""
    from tests import test_torch_carve as carve

    P = carve.PORT
    before = (P.og.CARVE_REJECTS, P.st.HEALS, dict(P.sg.DECLINES),
              counts("topology_carve_rejects_total").get("", 0.0),
              counts("filter_fallback_total"), counts("preemption_declined_total"))
    unit = [max(v, 1) for v in P.ow._reserve_vec(carve.pod(P, "probe"))]
    enc, _, _ = carve.window(P, [("memo", 3, (2, 2), "default")], [("tpu-a", 1.0, (4, 4))],
                             seed_bins=[("frag-node", 0, [v * 100 for v in unit], (4, 4),
                                         carve.FRAGMENTED)])
    P.sg.plan_gang_window(enc)
    ok, _ = P.st.check_probes(enc, ~P.topo.scalar_carve(enc))
    assert not ok
    enc_p, ctx_p = carve.preemption_case(P, "fresh-cheaper")
    P.sg.plan_gang_window(enc_p, preempt=ctx_p)
    rejects = P.og.CARVE_REJECTS - before[0]
    assert rejects >= 1 and counts("topology_carve_rejects_total")[""] - before[3] == rejects
    assert P.st.HEALS - before[1] == 1
    assert delta(before[4], counts("filter_fallback_total")) == {"carve-mismatch": 1}
    declines = delta(before[2], P.sg.DECLINES)
    assert declines and delta(before[5], counts("preemption_declined_total")) == declines


def test_budget_declines_equal_their_series():
    """The preemption budget's declines (a gang in cooldown, a band out of
    tokens) and its token gauges."""
    from karpenter_tpu_torch.scheduling.preempt_budget import PreemptionBudget
    from karpenter_tpu_torch.solver.gang import PreemptCandidate

    def cand(g, band):
        return PreemptCandidate(gang_key=("ns", g), bin_index=0, node="n", band=band,
                                pods=[("ns", f"{g}-m0")], cells=np.arange(4), refund=[1],
                                displacement_cost=0.1)

    before = (counts("preemption_budget_declines_total"), counts("preemption_declined_total"))
    budget = PreemptionBudget(capacity={"low": 1}, refill_per_window=0)
    budget.tick()
    admitted = budget.admit([cand("a", "low"), cand("b", "low")])
    budget.charge(admitted[0].gang_key, "low")
    budget.admit([cand("a", "low")])
    assert budget.declines == {"tokens": 1, "cooldown": 1}
    assert delta(before[0], counts("preemption_budget_declines_total")) == budget.declines
    assert delta(before[1], counts("preemption_declined_total")) == {"budget": 2}
    tokens = port_registry.DEFAULT.registered()["preemption_budget_tokens"].collect()
    assert tokens[(("band", "low"),)] == 0.0
    cooldowns = port_registry.DEFAULT.registered()["preemption_budget_cooldowns"].collect()
    assert cooldowns[()] == 1.0


def test_global_errors_equal_their_series(monkeypatch):
    """A global leg that fails at fetch: the worker counts one error and the
    chunk's twelve schedules as global fallbacks under ``error``."""
    from karpenter_tpu_torch.solver import global_solve as port_gs
    from tests import test_torch_controller as controller

    def broken(*args, **kwargs):
        raise RuntimeError("injected global-leg failure")

    monkeypatch.setattr(port_gs, "_round_window", broken)
    before = counts("global_fallback_total")
    _, worker = controller.run_worker(controller.PORT, controller.priced_window(controller.PORT),
                                      backend="global")
    assert worker.global_errors == 1
    assert delta(before, counts("global_fallback_total")) == {"error": 12.0}
