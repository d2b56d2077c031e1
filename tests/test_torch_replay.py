"""The port's cluster-in-a-box replay and its verdict against the JAX
package's, on the CPU at small sizes.

- The fixtures and helpers (``diurnal_weights`` over seeds, tick and burst
  counts; ``tenant_catalog``, ``tpu_tenant_types``, ``tenant_provisioner``
  field by field; ``_pending_pod`` with a seeded ``uuid4``; ``_quantiles``;
  ``ReplayConfig``'s defaults and ``validate()`` messages) equal the JAX
  package's.
- The seeded traffic: both ``run_replay``s, chaos off, on one small config
  with spot and gangs, record every pod the harness creates (a recording
  store patched in as each module's ``KubeCore``) and every flood offer (a
  patched ``ProvisionerWorker.add``); the sequences, the offered counts,
  the churn deletes and the gangs offered are equal, both runs complete,
  and the reports' nested key sets are equal.
- ``store_ab`` at a small size gives the same counts in both packages.
- The reference's own legs (``tests/test_replay.py``'s tiny, spot and SLO
  replays) pass on the port with the same configs.
- The port's ``verdict`` equals ``tools.replay_verdict.verdict`` letter for
  letter over a table of reports; the stdin filter passes its input
  through unchanged; the CLI's line pipes through it to a verdict.

The replay is paced by the wall clock and its controllers run on
threads, so only the seeded traffic is compared; sheds, latencies and
levels are not.
"""

import json
import random
import subprocess
import sys
import uuid
from collections import Counter
from dataclasses import asdict, fields

import pytest

from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu import replay as jax_replay
from karpenter_tpu.controllers import provisioning as jax_provisioning
from karpenter_tpu.metrics import registry as jax_registry
from karpenter_tpu.obs import slo as jax_slo
from karpenter_tpu.ops import topology as jax_topo
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch import replay as port_replay
from karpenter_tpu_torch import replay_verdict as port_verdict
from karpenter_tpu_torch.controllers import provisioning as port_provisioning
from karpenter_tpu_torch.metrics import registry as port_registry
from karpenter_tpu_torch.obs import slo as port_slo
from karpenter_tpu_torch.ops import topology as port_topo
from tools import replay_verdict as jax_verdict

TINY = dict(pods_total=1_500, shards=2, tenants=2, seed=7, bound_cohort=60, churn_pods=120,
            max_depth=400, ticks=6, tick_sleep_s=0.05, burst_ticks=2, chaos=True,
            settle_s=45.0, flood_pool=64)
TRAFFIC = dict(TINY, chaos=False, gang_fraction=0.2, spot_fraction=0.5)


REGISTRIES = (jax_registry.DEFAULT, port_registry.DEFAULT)


def series(registry):
    """Each metric family's label sets."""
    return {name: set(m.collect()) for name, m in list(registry._metrics.items())}


def drop_new_series(registry, before):
    """Remove the series a replay added to a process-wide registry: its
    shard-labelled series would otherwise meet a later test that reads a
    family by one label (the pipeline's stage histogram by stage)."""
    for name, m in list(registry._metrics.items()):
        for lv in set(m.collect()) - before.get(name, set()):
            if hasattr(m, "delete"):
                m.delete(**dict(lv))
            else:
                with m._lock:
                    for held in (m._counts, m._sums, m._totals, m._exemplars):
                        held.pop(lv, None)


@pytest.fixture(autouse=True)
def fresh_process_state():
    """The SLO engines, pressure monitors, carve ledgers and metrics
    registries are process-wide: every test starts and ends with both
    packages reset, and leaves no series of its own behind."""
    for slo, pressure, topo in ((jax_slo, jax_pressure, jax_topo),
                                (port_slo, port_pressure, port_topo)):
        slo.reset()
        slo.configure(objectives=slo.default_objectives())
        pressure.set_monitor(None)
        topo.LEDGER.reset()
    before = [series(r) for r in REGISTRIES]
    yield
    for slo, pressure in ((jax_slo, jax_pressure), (port_slo, port_pressure)):
        slo.reset()
        pressure.set_monitor(None)
    for registry, held in zip(REGISTRIES, before):
        drop_new_series(registry, held)


def seeded_uuid4(monkeypatch, seed):
    rng = random.Random(seed)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))


# ---------------------------------------------------------------------------
# fixtures and helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 7, 42])
@pytest.mark.parametrize("ticks,bursts", [(1, 0), (6, 2), (12, 3), (24, 3), (5, 9)])
def test_diurnal_weights_equal(seed, ticks, bursts):
    assert (port_replay.diurnal_weights(ticks, bursts, random.Random(seed))
            == jax_replay.diurnal_weights(ticks, bursts, random.Random(seed)))


def instance_type_fields(it):
    return (it.name, [(o.capacity_type, o.zone, o.interruption_rate) for o in it.offerings],
            it.architecture, sorted(it.operating_systems), str(it.cpu), str(it.memory),
            str(it.pods), str(it.nvidia_gpus), str(it.amd_gpus), str(it.aws_neurons),
            str(it.aws_pod_eni), sorted((k, str(v)) for k, v in it.overhead.items()),
            it.price, it.tpu_topology)


@pytest.mark.parametrize("tenants", [1, 3, 8])
def test_tenant_catalogs_equal(tenants):
    for fn, args in (("tenant_catalog", (tenants,)), ("tenant_catalog", (tenants, 9)),
                     ("tpu_tenant_types", (tenants, "v5e-2x2")),
                     ("tpu_tenant_types", (tenants, "v4-2x2x2")),
                     ("tpu_tenant_types", (tenants, "plain"))):
        port = [instance_type_fields(it) for it in getattr(port_replay, fn)(*args)]
        jax = [instance_type_fields(it) for it in getattr(jax_replay, fn)(*args)]
        assert port == jax, (fn, args)


@pytest.mark.parametrize("tenant", [0, 1, 7])
def test_tenant_provisioner_equal(tenant):
    p, j = port_replay.tenant_provisioner(tenant), jax_replay.tenant_provisioner(tenant)
    assert port_replay.tenant_zone(tenant) == jax_replay.tenant_zone(tenant)
    assert (p.metadata.name, p.metadata.namespace) == (j.metadata.name, j.metadata.namespace)
    pc, jc = p.spec.constraints, j.spec.constraints
    assert ([(r.key, r.operator, list(r.values)) for r in pc.requirements.items]
            == [(r.key, r.operator, list(r.values)) for r in jc.requirements.items])
    assert pc.requirements.requirement("topology.kubernetes.io/zone") == {
        port_replay.tenant_zone(tenant)}
    assert (pc.labels, pc.taints) == (jc.labels, jc.taints)


def pod_fields(pod):
    c = pod.spec.containers
    return (pod.metadata.name, pod.metadata.namespace, pod.metadata.uid,
            dict(pod.metadata.labels), dict(pod.spec.node_selector), pod.spec.priority,
            pod.spec.priority_class_name, pod.status.phase,
            [(x.type, x.status, x.reason) for x in pod.status.conditions],
            [sorted((k, str(v)) for k, v in x.resources.requests.items()) for x in c])


@pytest.mark.parametrize("kwargs", [
    {}, {"zone": "replay-zone-2"}, {"requests": {"cpu": "250m", "memory": "512Mi"}},
    {"zone": "replay-zone-1", "requests": {"cpu": "100m"}, "priority": -10},
    {"priority": 100, "priority_class_name": "system-cluster-critical"}])
def test_pending_pod_equal(kwargs, monkeypatch):
    seeded_uuid4(monkeypatch, 3)
    port = port_replay._pending_pod("p-1", **kwargs)
    seeded_uuid4(monkeypatch, 3)
    jax = jax_replay._pending_pod("p-1", **kwargs)
    assert pod_fields(port) == pod_fields(jax)


@pytest.mark.parametrize("values", [[], [1.0], [3.0, 1.0, 2.0], [0.5] * 7 + [9.0],
                                    [random.Random(4).random() for _ in range(1000)]])
def test_quantiles_equal(values):
    assert port_replay._quantiles(values) == jax_replay._quantiles(values)


def test_replay_config_defaults_equal():
    assert [f.name for f in fields(port_replay.ReplayConfig)] == [
        f.name for f in fields(jax_replay.ReplayConfig)]
    assert asdict(port_replay.ReplayConfig()) == asdict(jax_replay.ReplayConfig())
    assert [asdict(s) for s in port_replay.REPLAY_SPECS] == [
        asdict(s) for s in jax_replay.REPLAY_SPECS]
    assert (port_replay.COHORT_BANDS, port_replay.FLOOD_BANDS) == (
        jax_replay.COHORT_BANDS, jax_replay.FLOOD_BANDS)


@pytest.mark.parametrize("bad", [
    {"shards": 0}, {"tenants": 0}, {"gang_fraction": 1.5}, {"gang_fraction": -0.1},
    {"spot_fraction": 2.0}, {"gang_size": 0}, {"pods_total": 100},
    {"pods_total": 3_999, "bound_cohort": 2_000, "churn_pods": 2_000}])
def test_validate_messages_equal(bad):
    with pytest.raises(ValueError) as port_err:
        port_replay.ReplayConfig(**bad).validate()
    with pytest.raises(ValueError) as jax_err:
        jax_replay.ReplayConfig(**bad).validate()
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# the seeded traffic
# ---------------------------------------------------------------------------

def traffic_run(mod, provisioning, pressure, monkeypatch, **kw):
    """One replay of TRAFFIC with every pod the harness creates and every
    flood offer recorded: (report, creates, deletes, offers)."""
    creates, deletes, offers = [], [], []

    class RecordingStore(mod.KubeCore):
        def create(self, obj):
            out = super().create(obj)
            if obj.kind == "Pod":
                band, _ = pressure.classify(obj)
                creates.append((obj.metadata.name, band,
                                obj.spec.node_selector.get("topology.kubernetes.io/zone"),
                                [sorted((k, str(v)) for k, v in c.resources.requests.items())
                                 for c in obj.spec.containers],
                                obj.spec.priority, obj.spec.priority_class_name,
                                dict(obj.metadata.labels), dict(obj.spec.node_selector)))
            return out

        def delete(self, kind, name, namespace="default", *args, **kwargs):
            out = super().delete(kind, name, namespace, *args, **kwargs)
            if kind == "Pod" and name.startswith("churn-"):
                deletes.append(name)
            return out

    add = provisioning.ProvisionerWorker.add

    def recording_add(self, pod, key=None, provisioner=None):
        if pod.metadata.name.startswith("flood-"):
            offers.append((pod.metadata.name, pressure.classify(pod)[0], provisioner))
        return add(self, pod, key=key, provisioner=provisioner)

    monkeypatch.setattr(mod, "KubeCore", RecordingStore)
    monkeypatch.setattr(provisioning.ProvisionerWorker, "add", recording_add)
    report = mod.run_replay(mod.ReplayConfig(**TRAFFIC), **kw)
    monkeypatch.undo()
    return report, creates, deletes, offers


def nested_keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= nested_keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def traffic():
    mp = pytest.MonkeyPatch()
    before = [series(r) for r in REGISTRIES]
    try:
        jax = traffic_run(jax_replay, jax_provisioning, jax_pressure, mp)
        port = traffic_run(port_replay, port_provisioning, port_pressure, mp, device="cpu")
    finally:
        mp.undo()
        for slo, pressure, topo in ((jax_slo, jax_pressure, jax_topo),
                                    (port_slo, port_pressure, port_topo)):
            slo.reset()
            pressure.set_monitor(None)
            topo.LEDGER.reset()
        for registry, held in zip(REGISTRIES, before):
            drop_new_series(registry, held)
    return jax, port


def test_seeded_traffic_equal(traffic):
    (jr, jc, jd, jo), (pr, pc, pd, po) = traffic
    assert jr["completed"] and pr["completed"], (jr, pr)
    assert pc == jc and len(pc) == (TRAFFIC["bound_cohort"] + pr["gangs"]["offered_gangs"] * 4
                                    + TRAFFIC["churn_pods"] // TRAFFIC["ticks"]
                                    * TRAFFIC["ticks"])
    assert pd == jd and len(pd) == pr["churn_deleted"] == jr["churn_deleted"]
    # the routes' order depends on which shard worker the threads started
    # first, so the tenant a flood offer went to is compared as counts
    assert [o[:2] for o in po] == [o[:2] for o in jo]
    counts = [sorted(Counter(o[2] for o in offers).values())
              for offers in (po, jo)]
    assert counts[0] == counts[1]
    for key in ("offered", "offered_total", "churn_deleted"):
        assert pr[key] == jr[key], key
    assert pr["gangs"]["offered_gangs"] == jr["gangs"]["offered_gangs"] > 0
    assert pr["gangs"]["partial_gangs"] == jr["gangs"]["partial_gangs"] == 0
    assert pr["spot"]["cohort_spot_pods"] == jr["spot"]["cohort_spot_pods"] > 0
    assert pr["config"] == jr["config"]
    assert pr["chaos_fired"] is jr["chaos_fired"] is None


def test_report_keys_equal(traffic):
    (jr, *_), (pr, *_) = traffic
    assert nested_keys(pr) == nested_keys(jr)


def test_store_ab_counts_equal():
    port = port_replay.store_ab(objects=3_000, minority=300, iters=8)
    jax = jax_replay.store_ab(objects=3_000, minority=300, iters=8)
    for key in ("objects", "minority_kind_objects", "iters", "gate"):
        assert port[key] == jax[key], key
    assert nested_keys(port) == nested_keys(jax)
    assert port["scan_speedup"] > 1.0 and port["list_speedup"] > 0.0
    assert port["striped"]["scan_p50_ms"] < port["naive"]["scan_p50_ms"]


def test_store_ab_fill_equal():
    """The A/B's fill gives both packages' stores the same objects."""
    stores = []
    for mod in (port_replay, jax_replay):
        store = mod.NaiveKubeCore()
        mod._fill_store(store, 50, 7)
        stores.append({kind: sorted(store.scan(kind, lambda o: (o.metadata.namespace,
                                                                o.metadata.name)))
                       for kind in ("Node", "Pod")})
    assert stores[0] == stores[1]
    assert len(stores[0]["Node"]) == 7 and len(stores[0]["Pod"]) == 43


# ---------------------------------------------------------------------------
# the reference's legs, on the port
# ---------------------------------------------------------------------------

class TestTinyReplay:
    def test_completes_with_zero_critical_sheds(self):
        cfg = port_replay.ReplayConfig(**TINY)
        report = port_replay.run_replay(cfg, device="cpu")
        assert report["completed"], report
        assert report["system_critical_shed"] == 0
        assert report["cohort_unbound"] == 0
        assert report["workers_healthy"]
        assert report["recovery_to_l0_s"] is not None
        assert report["offered_total"] >= 0.99 * cfg.pods_total
        assert set(report["offered"]) >= {"default", "low", "besteffort"}
        for q in report["pending_to_bound_s"].values():
            if q is not None:
                assert q["p99"] >= q["p50"] >= 0.0
        assert report["store_ops"]
        v = port_verdict.verdict({"replay": report, "store_ab": None})
        assert "PASS" in v and "FAIL" not in v, v

    def test_report_is_json_serializable(self):
        report = port_replay.run_replay(port_replay.ReplayConfig(
            pods_total=400, shards=1, tenants=1, seed=1, bound_cohort=20, churn_pods=40,
            max_depth=200, ticks=4, tick_sleep_s=0.05, burst_ticks=1, chaos=False,
            settle_s=30.0, flood_pool=32), device="cpu")
        text = json.loads(json.dumps(report))
        assert text["completed"] and text["chaos_fired"] is None


class TestSpotReplay:
    def test_spot_cohort_reclaim_rebinds(self):
        report = port_replay.run_replay(port_replay.ReplayConfig(
            **dict(TINY, tick_sleep_s=0.1, spot_fraction=0.5)), device="cpu")
        assert report["completed"], report
        assert report["system_critical_shed"] == 0
        spot = report["spot"]
        assert spot is not None and spot["cohort_spot_pods"] > 0, spot
        assert spot["interruptions"] >= 1, spot
        assert spot["rebound"] == spot["displaced"], spot
        assert "provider/reclaim/spot-interruption" in report["chaos_fired"]
        v = port_verdict.verdict({"replay": report, "store_ab": None})
        assert "PASS" in v and "FAIL" not in v and "spot=" in v, v


    def test_reclaimed_spot_pods_are_displaced_and_rebound(self):
        """Over 40 ticks capacity GC reaps the reclaimed instances' ghost
        Nodes, termination evicts their pods, and the harness re-offers
        them: some pods are displaced and every one binds again."""
        report = port_replay.run_replay(port_replay.ReplayConfig(
            **dict(TINY, tick_sleep_s=0.1, spot_fraction=0.5, ticks=40)), device="cpu")
        assert report["completed"], report
        spot = report["spot"]
        assert spot["instances_reclaimed"] >= 1 and spot["displaced"] >= 1, spot
        assert spot["rebound"] == spot["displaced"], spot


class TestReplaySlo:
    def test_clean_leg_zero_trips_bounded_and_parity(self):
        report = port_replay.run_replay(port_replay.ReplayConfig(
            pods_total=1_200, shards=1, tenants=1, seed=7, bound_cohort=60, churn_pods=60,
            max_depth=600, ticks=4, tick_sleep_s=0.05, burst_ticks=1, chaos=False,
            settle_s=30.0, flood_pool=32, slo_exact_check=True), device="cpu")
        assert report["completed"], report
        s = report["slo"]
        assert s["trips"] == 0 and s["burning"] == [], s
        assert s["bounded"] and s["records"] > 0, s
        assert report["slo_digest_parity"]["within_1pct"], report["slo_digest_parity"]
        from tools.slo_verdict import verdict as slo_verdict
        v = slo_verdict({"replay": report, "slo_chaos": None})
        assert "PASS" in v and "FAIL" not in v, v

    def test_chaos_probe_trips_with_band_and_stage(self):
        report = port_replay.run_replay(port_replay.ReplayConfig(
            pods_total=800, shards=1, tenants=1, seed=7, bound_cohort=40, churn_pods=40,
            max_depth=400, ticks=3, tick_sleep_s=0.05, burst_ticks=1, chaos=True,
            settle_s=30.0, flood_pool=32, slo_objectives={"default": 0.001}), device="cpu")
        assert report["completed"], report
        s = report["slo"]
        assert s["trips"] >= 1 and "default" in s["burning"], s
        tag = s["burn"]["last_trip"]
        assert tag["band"] == "default" and tag["stage"] == "e2e"
        assert tag["objective_s"] == 0.001
        # the objective map is restored after the run
        assert port_slo.sentinel().objectives["default"].threshold_s == 60.0


# ---------------------------------------------------------------------------
# the verdict
# ---------------------------------------------------------------------------

def report(**over):
    base = {"config": {"pods_total": 1000, "shards": 2, "chaos": True},
            "offered_total": 1000, "completed": True, "cohort_unbound": 0,
            "workers_healthy": True, "system_critical_shed": 0, "recovery_to_l0_s": 1.5,
            "peak_level": 2, "pending_to_bound_s": {
                "default": {"p50": 0.1, "p99": 0.7, "max": 1.0, "n": 10}},
            "gangs": {"offered_gangs": 0, "gang_size": 4, "gangs_fully_bound": 0,
                      "partial_gangs": 0}, "spot": None}
    base.update(over)
    return base


AB = {"scan_speedup": 33.2, "objects": 100_000}
SPOT_OK = {"cohort_spot_pods": 10, "interruptions": 2, "instances_reclaimed": 2,
           "displaced": 4, "rebound": 4, "spot_instances_live": 3}
VERDICT_TABLE = {
    "pass": {"replay": report(), "store_ab": AB},
    "incomplete": {"replay": report(completed=False, cohort_unbound=3,
                                    workers_healthy=False), "store_ab": AB},
    "offered_short": {"replay": report(offered_total=980), "store_ab": AB},
    "critical_shed": {"replay": report(system_critical_shed=3), "store_ab": AB},
    "no_recovery": {"replay": report(recovery_to_l0_s=None), "store_ab": AB},
    "partial_gangs": {"replay": report(gangs={"offered_gangs": 100, "gang_size": 4,
                                              "gangs_fully_bound": 98, "partial_gangs": 2}),
                      "store_ab": AB},
    "gangs_whole": {"replay": report(gangs={"offered_gangs": 100, "gang_size": 4,
                                            "gangs_fully_bound": 100, "partial_gangs": 0}),
                    "store_ab": AB},
    "spot_ok": {"replay": report(spot=SPOT_OK), "store_ab": AB},
    "spot_stuck": {"replay": report(spot=dict(SPOT_OK, rebound=3)), "store_ab": AB},
    "spot_vacuous": {"replay": report(spot=dict(SPOT_OK, interruptions=0, displaced=0,
                                                rebound=0)), "store_ab": AB},
    "spot_no_cohort": {"replay": report(spot=dict(SPOT_OK, cohort_spot_pods=0)),
                       "store_ab": AB},
    "no_ab": {"replay": report(), "store_ab": None},
    "no_ab_failing": {"replay": report(system_critical_shed=1), "store_ab": None},
    "slow_store": {"replay": report(), "store_ab": {"scan_speedup": 2.0, "objects": 100_000}},
    "no_report": {"replay": None, "store_ab": AB},
    "bench_line": {"metric": "config_9", "extra": {"config_9_million_pod_replay": {
        "replay": report(), "store_ab": AB}}},
    "bench_error": {"metric": "config_9", "extra": {"config_9_million_pod_replay": {
        "error": "boom"}}},
}


@pytest.mark.parametrize("case", sorted(VERDICT_TABLE))
def test_verdict_equals_the_reference(case):
    line = VERDICT_TABLE[case]
    got = port_verdict.verdict(line)
    assert got == jax_verdict.verdict(line)
    assert port_verdict._extract(line) == jax_verdict._extract(line)
    if case in ("pass", "gangs_whole", "spot_ok", "no_ab", "bench_line"):
        assert "PASS" in got and "FAIL" not in got, got
    elif case in ("no_report", "bench_error"):
        assert "NO VERDICT" in got, got
    else:
        assert "FAIL" in got, got


def test_gates_equal():
    assert (port_verdict.GATE_SCAN_SPEEDUP, port_verdict.GATE_OFFERED_FRACTION) == (
        jax_verdict.GATE_SCAN_SPEEDUP, jax_verdict.GATE_OFFERED_FRACTION)


@pytest.mark.parametrize("case", ["pass", "slow_store"])
def test_stdin_filter_passes_through(case):
    line = json.dumps(VERDICT_TABLE[case])
    text = "not json\n" + line + "\n\n"
    port = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.replay_verdict"],
                          input=text, capture_output=True, text=True, timeout=60)
    jax = subprocess.run([sys.executable, "tools/replay_verdict.py"], input=text,
                         capture_output=True, text=True, timeout=60)
    assert port.returncode == jax.returncode == 0
    assert port.stdout == jax.stdout == text
    assert port.stderr == jax.stderr
    assert port.stderr.strip() == port_verdict.verdict(VERDICT_TABLE[case])


def test_stdin_filter_without_a_report():
    proc = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.replay_verdict"],
                          input='{"other": 1}\n', capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1 and proc.stdout == '{"other": 1}\n'
    assert proc.stderr.strip() == "replay: no JSON line on stdin — NO VERDICT"


def test_cli_pipes_into_the_verdict():
    cli = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.replay", "--device", "cpu",
         "--pods-total", "1500", "--ticks", "4", "--settle-s", "30", "--no-chaos"],
        capture_output=True, text=True, timeout=120)
    assert cli.returncode == 0, cli.stderr[-2000:]
    lines = cli.stdout.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["store_ab"] is None and out["replay"]["completed"]
    assert out["replay"]["config"]["pods_total"] == 1500
    gate = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.replay_verdict"],
                          input=cli.stdout, capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0 and gate.stdout == cli.stdout
    assert "replay PASS" in gate.stderr, gate.stderr
