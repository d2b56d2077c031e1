"""Crash safety of the port against the JAX package's, on the CPU: the
journaled controllers, startup recovery and the kill-point soak.

Each package runs with the same draws: ``uuid.uuid4`` (intent ids, launch
nonces, pod uids) is one seeded sequence reset before each package runs,
and each fake provider's node-name counter restarts at 0, so the two runs
name the same nodes and stamp the same nonces. The JAX side runs the JAX
package's own crash-recovery harness (``tests/test_crash_recovery.py``);
the port side runs its copy, ``karpenter_tpu_torch.chaos.soak``, on the
plain versions of the kernels.

- **Every one of the 50 kill points**, seed 1, window 1: both packages crash
  at the point, recover and re-drive to the same canonical state, the same
  recovery stats and the same provider ledger, and the state equals the
  uncrashed reference run's (the carve and preempt points run the carve
  scenario and compare the recovered occupancy ledger too).
- **Every replay rule** of the JAX package's ``TestReplayRules`` and
  ``TestGcRecoveryHandoff``: the same stats, state and ledger.
- **The carve soak's durability cases**: a preempt intent across a
  rotation and a compaction, the recovered ledger equal to the pre-crash
  snapshot over two replays, a double replay that re-admits the victims
  once, a crash between the gang's ``bound`` append and its carve opens,
  a torn carve record.
- **A reference finding**: a crash in the consume stage of a multi-chunk
  window drains the pipeline, so the dead process still binds the chunks
  in flight; both packages bind the same.

Tolerance: exact (nothing here is float).
"""

import itertools
import json
import os
import random
import threading
import uuid
from types import SimpleNamespace

import pytest

import tests.test_crash_recovery as tcr
from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu.api import core as jax_core
from karpenter_tpu.chaos import inject as jax_inject
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.controllers.gc import GarbageCollection as JaxGC
from karpenter_tpu.controllers.recovery import RecoveryController as JaxRecovery
from karpenter_tpu.obs import flight as jax_flight
from karpenter_tpu.ops import global_solve as jax_gops
from karpenter_tpu.ops import topology as jax_topo
from karpenter_tpu.runtime import journal as jax_jr
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.chaos import inject as port_inject
from karpenter_tpu_torch.chaos import soak
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.controllers.gc import GarbageCollection as PortGC
from karpenter_tpu_torch.controllers.recovery import RecoveryController as PortRecovery
from karpenter_tpu_torch.obs import flight as port_flight
from karpenter_tpu_torch.ops import global_solve as port_gops
from karpenter_tpu_torch.ops import topology as port_topo
from karpenter_tpu_torch.runtime import journal as port_jr
from karpenter_tpu_torch.utils import clock as port_clock

JAX = SimpleNamespace(
    name="jax", h=tcr, inject=jax_inject, jr=jax_jr, fake=jax_fake, topo=jax_topo,
    Recovery=JaxRecovery, GC=JaxGC, clock=jax_clock, flight=jax_flight, core=jax_core,
    cluster=lambda d, carve=False: (tcr.carve_cluster(d) if carve else tcr.Cluster(d)))
PORT = SimpleNamespace(
    name="port", h=soak, inject=port_inject, jr=port_jr, fake=port_fake, topo=port_topo,
    Recovery=PortRecovery, GC=PortGC, clock=port_clock, flight=port_flight, core=port_core,
    cluster=lambda d, carve=False: (soak.carve_cluster(d, device="cpu") if carve
                                    else soak.Cluster(d, device="cpu")))
T0 = 1_700_000_000.0
GRACE = 60.0


@pytest.fixture(autouse=True)
def fresh_process_state(monkeypatch):
    """Both packages' process-wide state reset around each test: no plan
    installed, empty occupancy ledgers, fresh global-solve supports, a
    fresh JAX watchdog, quiet pressure monitors (no RSS watermark: this
    process holds both packages) and real clocks."""
    def reset():
        jax_inject.uninstall()
        port_inject.uninstall()
        jax_topo.LEDGER.reset()
        port_topo.LEDGER.reset()
        jax_gops.SUPPORT.reset()
        port_gops.SUPPORT.reset()
        jax_clock.DEFAULT.reset()
        port_clock.DEFAULT.reset()

    reset()
    monkeypatch.setattr(jax_solve_mod, "_WATCHDOG", jax_solve_mod._DeviceWatchdog())
    jax_pressure.set_monitor(jax_pressure.PressureMonitor(
        jax_pressure.PressureConfig(rss_watermark_bytes=0), breaker_fn=lambda: False))
    port_pressure.set_monitor(port_pressure.PressureMonitor(
        port_pressure.PressureConfig(rss_watermark_bytes=0)))
    yield
    reset()
    jax_pressure.set_monitor(None)
    port_pressure.set_monitor(None)


def same_draws(pkg, monkeypatch, seed=1):
    """The draws both packages make from here on: one seeded uuid4
    sequence and a node-name counter from 0."""
    rng = random.Random(seed)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
    monkeypatch.setattr(pkg.fake, "_name_counter", itertools.count())


def ledger_records(provider):
    return sorted((r.instance_id, r.provisioner_name, r.launch_nonce, r.zone,
                   r.instance_type, r.capacity_type) for r in provider.list_instances())


def name_free(records):
    return sorted(r[1:2] + r[3:] for r in records)


def both(fn, monkeypatch, seed=1):
    """``fn(pkg)`` on the JAX package, then on the port, each with the same
    draws and fresh ledgers; returns (jax, port)."""
    out = []
    for pkg in (JAX, PORT):
        same_draws(pkg, monkeypatch, seed)
        pkg.topo.LEDGER.reset()
        out.append(fn(pkg))
    return out


# -- the 50 kill points ------------------------------------------------------------

def soak_cell(pkg, root, kill_point, seed=1, window=1):
    """The crash-restart cell of the JAX package's soak, on ``pkg``: the
    uncrashed reference, the crashed run, the restart and the re-drive."""
    h = pkg.h
    carve = kill_point in soak.CARVE_KILL_POINTS
    scenario = h.run_carve_scenario if carve else h.run_scenario

    pkg.topo.LEDGER.reset()
    ref = pkg.cluster(os.path.join(root, "ref"), carve)
    ref_journal = ref.open_journal()
    scenario(ref, ref_journal)
    ref_out = {"state": h.canonical_state(ref), "ledger": h.canonical_ledger(),
               "capacity": name_free(ledger_records(ref.provider)),
               "open": sorted(i.kind for i in ref_journal.open_intents().values())}
    ref_journal.close_journal()

    pkg.topo.LEDGER.reset()
    c = pkg.cluster(os.path.join(root, "crash"), carve)
    journal = c.open_journal()
    pkg.inject.install(pkg.inject.FaultPlan(seed, [pkg.inject.FaultSpec(
        "journal", kill_point, "crash-point", 1)], window=window))
    crashed = None
    try:
        scenario(c, journal)
    except pkg.inject.SimulatedCrash as e:
        crashed = e.point
    finally:
        pkg.inject.uninstall()
        journal.close_journal()
    after_crash = {"open": sorted((i.kind, i.phase) for i in
                                  pkg.jr.IntentJournal(c.journal_dir, fsync=False)
                                  .open_intents().values())}
    pkg.topo.LEDGER.reset()
    journal2, stats = h.restart(c)
    scenario(c, journal2)
    if carve:
        h.assert_carve_invariants(c, journal2)
    else:
        h.assert_invariants(c)
    out = {"crashed": crashed, "after_crash": after_crash, "stats": stats,
           "state": h.canonical_state(c), "ledger": h.canonical_ledger(),
           "capacity": ledger_records(c.provider),
           "open": sorted(i.kind for i in journal2.open_intents().values()),
           "reference": ref_out}
    journal2.close_journal()
    return out


@pytest.mark.parametrize("kill_point", soak.LEGACY_KILL_POINTS + soak.CARVE_KILL_POINTS)
def test_kill_point_recovers_as_the_jax_package(kill_point, tmp_path, monkeypatch):
    j, p = both(lambda pkg: soak_cell(pkg, str(tmp_path / pkg.name), kill_point), monkeypatch)
    assert p["crashed"] == kill_point, "the point never fired"
    assert p == j
    assert p["stats"]["errors"] == 0
    assert p["state"] == p["reference"]["state"]
    assert p["ledger"] == p["reference"]["ledger"]
    assert name_free(p["capacity"]) == p["reference"]["capacity"]
    assert p["open"] == p["reference"]["open"]


def test_the_catalog_is_the_jax_catalog():
    assert port_jr.KILL_POINTS == jax_jr.KILL_POINTS
    assert soak.CARVE_KILL_POINTS == tcr.CARVE_KILL_POINTS
    assert soak.LEGACY_KILL_POINTS == tcr.LEGACY_KILL_POINTS
    assert len(soak.LEGACY_KILL_POINTS) + len(soak.CARVE_KILL_POINTS) == 50


# -- the replay rules ----------------------------------------------------------------

def leak_create(pkg, cluster, nonce, fault=True, bind=None):
    """One launch under ``nonce``; with ``fault`` the controller "dies"
    before the Node write (crash-before-bind)."""
    with pkg.jr.preassigned_nonce(nonce):
        if fault:
            pkg.inject.install(pkg.inject.FaultPlan(1, [pkg.inject.FaultSpec(
                "provider", "create", "crash-before-bind", 1)], window=1))
        try:
            cluster.provider.create(cluster.constraints, cluster.provider.catalog, 1,
                                    bind or (lambda n: None))
        finally:
            pkg.inject.uninstall()


def rule_fleet_launch_rollback(pkg, c):
    j = c.open_journal()
    nonce = pkg.jr.new_nonce()
    j.open_intent("fleet-launch", nonce=nonce, quantity=1)
    leak_create(pkg, c, nonce)
    j.close_journal()
    return pkg.h.restart(c)


def rule_fleet_launch_keeps_backed(pkg, c):
    j = c.open_journal()
    nonce = pkg.jr.new_nonce()
    j.open_intent("fleet-launch", nonce=nonce, quantity=1)
    leak_create(pkg, c, nonce, fault=False, bind=lambda n: c.kube.create(n) and None)
    j.close_journal()
    return pkg.h.restart(c)


def rule_fleet_launch_nothing_launched(pkg, c):
    j = c.open_journal()
    j.open_intent("fleet-launch", nonce=pkg.jr.new_nonce(), quantity=3)
    j.close_journal()
    return pkg.h.restart(c)


def rule_bind_rolls_forward(pkg, c):
    node = pkg.h.drain_target(c)
    done = pkg.h.ensure_pod(c.kube, "done-pod")
    c.kube.bind_pods([done], node.metadata.name)
    pkg.h.ensure_pod(c.kube, "missed-pod")
    j = c.open_journal()
    j.open_intent("bind", node=node.metadata.name,
                  pods=["default/done-pod", "default/missed-pod"])
    j.close_journal()
    return pkg.h.restart(c)


def rule_bind_node_never_landed(pkg, c):
    pkg.h.ensure_pod(c.kube, "orphan-pod")
    j = c.open_journal()
    j.open_intent("bind", node="never-created", pods=["default/orphan-pod"])
    j.close_journal()
    return pkg.h.restart(c)


def crash_gang(pkg, c, point):
    j = c.open_journal()
    worker = pkg.h.make_worker(c, j)
    pods = [pkg.h.ensure_pod(c.kube, n) for n in tcr.GANG_OK]
    pkg.inject.install(pkg.inject.FaultPlan(1, [pkg.inject.FaultSpec(
        "journal", point, "crash-point", 1)], window=1))
    try:
        pkg.h.launch_gang(worker, c, pods, key="gang-ok")
        raise AssertionError(f"{point} never fired")
    except pkg.inject.SimulatedCrash:
        pass
    finally:
        pkg.inject.uninstall()
    j.close_journal()
    return pkg.h.restart(c)


def rule_gang_unwind_from_nodes_created(pkg, c):
    return crash_gang(pkg, c, "gang-bind:nodes-created")


def rule_gang_bound_rolls_forward(pkg, c):
    return crash_gang(pkg, c, "gang-bind:bound")


def rule_gang_unwind_reaps_nonce_only_instance(pkg, c):
    j = c.open_journal()
    iid = j.open_intent("gang-bind", gang="g", members=["default/gang-ok-0"])
    nonce = pkg.jr.new_nonce()
    j.note(iid, nonces=[nonce])
    leak_create(pkg, c, nonce)
    j.close_journal()
    return pkg.h.restart(c)


def rule_drain_reissued(pkg, c):
    node = pkg.h.drain_target(c)
    j = c.open_journal()
    j.open_intent("drain", node=node.metadata.name, namespace="")
    j.close_journal()
    return pkg.h.restart(c)


def rule_drain_already_deleting(pkg, c):
    node = pkg.h.drain_target(c)
    c.kube.delete("Node", node.metadata.name, "")
    j = c.open_journal()
    j.open_intent("drain", node=node.metadata.name, namespace="")
    j.close_journal()
    return pkg.h.restart(c)


def rule_node_delete_strips_finalizer(pkg, c):
    node = pkg.h.drain_target(c)
    c.kube.delete("Node", node.metadata.name, "")
    j = c.open_journal()
    iid = j.open_intent("node-delete", node=node.metadata.name,
                        provider_id=node.spec.provider_id)
    c.provider.delete_instance([s for s in node.spec.provider_id.split("/") if s][1])
    j.advance(iid, "instance-deleted")
    j.close_journal()
    return pkg.h.restart(c)


def rule_node_delete_reaps_leftover(pkg, c):
    node = pkg.h.drain_target(c)
    j = c.open_journal()
    j.open_intent("node-delete", node=node.metadata.name, provider_id=node.spec.provider_id)

    def strip(live):
        live.metadata.finalizers = []

    c.kube.patch("Node", node.metadata.name, "", strip)
    c.kube.delete("Node", node.metadata.name, "")
    j.close_journal()
    return pkg.h.restart(c)


def rule_rollback_trips_flight(pkg, c, tmp_dir):
    pkg.flight.configure(tmp_dir, min_interval_s=0.0)
    try:
        out = rule_fleet_launch_rollback(pkg, c)
        dumps = sorted(os.listdir(tmp_dir))
        with open(os.path.join(tmp_dir, [d for d in dumps if "recovery-rollback" in d][0])) as f:
            tags = json.load(f)["tags"]
    finally:
        pkg.flight.configure("", min_interval_s=5.0)
    return out, tags


RULES = {
    "fleet-launch-rollback": (rule_fleet_launch_rollback,
                              {"forward": 0, "rollback": 1, "noop": 0, "errors": 0}),
    "fleet-launch-keeps-backed": (rule_fleet_launch_keeps_backed,
                                  {"forward": 1, "rollback": 0, "noop": 0, "errors": 0}),
    "fleet-launch-nothing-launched": (rule_fleet_launch_nothing_launched,
                                      {"forward": 0, "rollback": 0, "noop": 1, "errors": 0}),
    "bind-rolls-forward": (rule_bind_rolls_forward,
                           {"forward": 1, "rollback": 0, "noop": 0, "errors": 0}),
    "bind-node-never-landed": (rule_bind_node_never_landed,
                               {"forward": 0, "rollback": 0, "noop": 1, "errors": 0}),
    "gang-unwind-from-nodes-created": (rule_gang_unwind_from_nodes_created,
                                       {"forward": 0, "rollback": 1, "noop": 0, "errors": 0}),
    "gang-bound-rolls-forward": (rule_gang_bound_rolls_forward,
                                 {"forward": 1, "rollback": 0, "noop": 0, "errors": 0}),
    "gang-unwind-reaps-nonce-only": (rule_gang_unwind_reaps_nonce_only_instance,
                                     {"forward": 0, "rollback": 1, "noop": 0, "errors": 0}),
    "drain-reissued": (rule_drain_reissued,
                       {"forward": 1, "rollback": 0, "noop": 0, "errors": 0}),
    "drain-already-deleting": (rule_drain_already_deleting,
                               {"forward": 0, "rollback": 0, "noop": 1, "errors": 0}),
    "node-delete-strips-finalizer": (rule_node_delete_strips_finalizer,
                                     {"forward": 1, "rollback": 0, "noop": 0, "errors": 0}),
    "node-delete-reaps-leftover": (rule_node_delete_reaps_leftover,
                                   {"forward": 1, "rollback": 0, "noop": 0, "errors": 0}),
}


def cluster_view(pkg, c):
    return {"state": pkg.h.canonical_state(c), "capacity": ledger_records(c.provider),
            "nodes": sorted((n.metadata.name, n.metadata.deletion_timestamp is not None,
                             tuple(n.metadata.finalizers)) for n in c.kube.list("Node")),
            "deleted": sorted(c.provider.deleted)}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_replay_rule_equals_the_jax_recovery(rule, tmp_path, monkeypatch):
    fn, want = RULES[rule]

    def run(pkg):
        c = pkg.cluster(str(tmp_path / pkg.name))
        journal, stats = fn(pkg, c)
        out = {"stats": stats, "open": len(journal.open_intents()), **cluster_view(pkg, c)}
        journal.close_journal()
        return out

    j, p = both(run, monkeypatch)
    assert p == j
    assert p["stats"] == want
    assert p["open"] == 0


def test_rollback_trips_the_flight_recorder(tmp_path, monkeypatch):
    j, p = both(lambda pkg: rule_rollback_trips_flight(
        pkg, pkg.cluster(str(tmp_path / pkg.name)), str(tmp_path / f"flight-{pkg.name}")),
        monkeypatch)
    assert p[0][1] == j[0][1] == {"forward": 0, "rollback": 1, "noop": 0, "errors": 0}
    assert p[1] == j[1] == {"rollbacks": 1, "forward": 0, "noop": 0}


def test_recovery_errors_stay_open(tmp_path, monkeypatch):
    """A failing list_instances skips capacity-side rollback; a failing
    intent counts an error and stays open for the next restart."""
    def run(pkg):
        c = pkg.cluster(str(tmp_path / pkg.name))
        j = c.open_journal()
        nonce = pkg.jr.new_nonce()
        j.open_intent("fleet-launch", nonce=nonce, quantity=1)
        leak_create(pkg, c, nonce)
        j.open_intent("drain", node="gone", namespace="")
        j.close_journal()
        j2 = c.open_journal()

        def boom():
            raise RuntimeError("provider API down")

        real = c.provider.list_instances
        c.provider.list_instances = boom
        stats = pkg.Recovery(c.kube, c.provider, j2).run()
        c.provider.list_instances = real
        c.provider.delete_instance = lambda iid: "refused"
        j2.open_intent("fleet-launch", nonce=nonce, quantity=1)
        stats2 = pkg.Recovery(c.kube, c.provider, j2).run()
        return stats, stats2, sorted(i.kind for i in j2.open_intents().values())

    j, p = both(run, monkeypatch)
    assert p == j
    assert p[0] == {"forward": 0, "rollback": 0, "noop": 2, "errors": 0}
    assert p[1]["errors"] == 1 and p[2] == ["fleet-launch"]


def test_gc_skips_journal_covered_nonce(tmp_path, monkeypatch):
    def run(pkg):
        c = pkg.cluster(str(tmp_path / pkg.name))
        pkg.clock.DEFAULT.set(T0)
        j = c.open_journal()
        nonce = pkg.jr.new_nonce()
        iid = j.open_intent("fleet-launch", nonce=nonce, quantity=1)
        leak_create(pkg, c, nonce)
        (record,) = c.provider.list_instances()
        gc = pkg.GC(c.kube, c.provider, interval_seconds=0.01, grace_seconds=GRACE, journal=j)
        pkg.clock.DEFAULT.set(T0 + GRACE + 5)
        gc.reconcile("capacity-gc", "")
        kept = len(c.provider.list_instances())
        j.close(iid, outcome="abandoned")
        gc.reconcile("capacity-gc", "")
        return kept, ledger_records(c.provider), c.provider.deleted.count(record.instance_id)

    j, p = both(run, monkeypatch)
    assert p == j == (1, [], 1)


def test_recovery_terminates_once_beside_a_concurrent_gc(tmp_path, monkeypatch):
    def run(pkg):
        c = pkg.cluster(str(tmp_path / pkg.name))
        pkg.clock.DEFAULT.set(T0)
        j = c.open_journal()
        nonce = pkg.jr.new_nonce()
        j.open_intent("fleet-launch", nonce=nonce, quantity=1)
        leak_create(pkg, c, nonce)
        (record,) = c.provider.list_instances()
        j.close_journal()
        pkg.clock.DEFAULT.set(T0 + GRACE + 5)
        j2 = c.open_journal()
        recovery = pkg.Recovery(c.kube, c.provider, j2)
        gc = pkg.GC(c.kube, c.provider, interval_seconds=0.0, grace_seconds=GRACE, journal=j2)
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                gc.reconcile("capacity-gc", "")

        t = threading.Thread(target=loop)
        t.start()
        try:
            stats = recovery.run()
        finally:
            stop.set()
            t.join(timeout=10)
        gc.reconcile("capacity-gc", "")
        return stats, ledger_records(c.provider), c.provider.deleted.count(record.instance_id)

    j, p = both(run, monkeypatch)
    assert p == j
    assert p[0]["rollback"] == 1 and p[1] == [] and p[2] == 1


def test_recovering_gates_until_run_ends(tmp_path):
    c = PORT.cluster(str(tmp_path))
    j = c.open_journal()
    j.open_intent("fleet-launch", nonce=port_jr.new_nonce())
    j.close_journal()
    recovery = PortRecovery(c.kube, c.provider, c.open_journal())
    assert recovery.recovering() and not recovery.wait(0.0)
    assert (recovery.kind(), recovery.seeds(), recovery.reconcile("x")) == (None, [], None)
    recovery.run()
    assert not recovery.recovering() and recovery.wait(0.0)


# -- the carve soak's durability cases --------------------------------------------------

def carve_rotation_mid_preempt(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False, segment_max_records=2, auto_compact_closed=0)
    c1 = j.open_intent("carve", gang="lo", node="n1", grid=[4, 4], type="tpu-v5e-4x4", sig=[],
                       cells=[0, 1], band="low", pods=["d/a"])
    p1 = j.open_intent("preempt", gang="lo", node="n1", band="low", pods=["d/a"],
                       beneficiary="hi")
    j.advance(p1, "victims-unbound")
    c2 = j.open_intent("carve", gang="hi", node="n1", grid=[4, 4], type="tpu-v5e-4x4", sig=[],
                       cells=[4, 5], band="high", pods=["d/b"])
    j.close(c2, outcome="unwound")
    rotated = len([f for f in os.listdir(d) if f.endswith(".wal")])
    j.compact()
    j.close_journal()
    live = pkg.jr.IntentJournal(d, fsync=False).open_intents()
    raw = b"".join(open(os.path.join(d, f), "rb").read()
                   for f in sorted(os.listdir(d)) if f.endswith(".wal"))
    return {"rotated": rotated >= 2, "live": sorted(live) == sorted([c1, p1]),
            "phases": sorted((i.kind, i.phase, json.dumps(i.data, sort_keys=True))
                             for i in live.values()),
            "folded": c2.encode() not in raw}


def carve_recovered_equals_snapshot(pkg, d):
    c = pkg.cluster(d, carve=True)
    journal = c.open_journal()
    pkg.h.run_carve_scenario(c, journal)
    before = pkg.h.canonical_ledger()
    journal.close_journal()
    pkg.topo.LEDGER.reset()
    requeued, ledgers, stats = [], [], []
    j2 = c.open_journal()
    for _ in range(2):
        stats.append(pkg.Recovery(c.kube, c.provider, j2,
                                  requeue_displaced=requeued.extend).run())
        ledgers.append(pkg.h.canonical_ledger())
    pkg.h.assert_carve_invariants(c, j2)
    return {"before": before, "ledgers": ledgers, "stats": stats, "requeued": len(requeued)}


def carve_double_replay(pkg, d):
    c = pkg.cluster(d, carve=True)
    journal = c.open_journal()
    pkg.inject.install(pkg.inject.FaultPlan(1, [pkg.inject.FaultSpec(
        "journal", "pre:carve:closed", "crash-point", 1)], window=1))
    try:
        pkg.h.run_carve_scenario(c, journal)
        raise AssertionError("pre:carve:closed never fired")
    except pkg.inject.SimulatedCrash:
        pass
    finally:
        pkg.inject.uninstall()
    journal.close_journal()
    pkg.topo.LEDGER.reset()
    counts, stats = [], []
    j2 = c.open_journal()
    for _ in range(2):
        got = []
        stats.append(pkg.Recovery(c.kube, c.provider, j2, requeue_displaced=got.extend).run())
        counts.append(sorted(e[1] for e in got))
    return {"counts": counts, "stats": stats, "lo": pkg.h.ledger_rec("carve-lo") is None,
            "open": len(j2.open_intents()), "ledger": pkg.h.canonical_ledger()}


def carve_bound_before_open(pkg, d):
    c = pkg.cluster(d, carve=True)
    journal = c.open_journal()
    worker = pkg.h.make_worker(c, journal)
    lo = [pkg.h.ensure_pod(c.kube, n) for n in tcr.CARVE_VICTIM]
    prep = pkg.h.carve_prep(c, "carve-lo")
    placement = pkg.h.carve_placement(c, lo, "carve-lo", "low", tcr.VICTIM_CELLS)
    pkg.inject.install(pkg.inject.FaultPlan(1, [pkg.inject.FaultSpec(
        "journal", "gang-bind:bound", "crash-point", 1)], window=1))
    try:
        worker._launch_gang(prep, placement)
        raise AssertionError("gang-bind:bound never fired")
    except pkg.inject.SimulatedCrash:
        pass
    finally:
        pkg.inject.uninstall()
    seen = {"carve_intents_before": len(journal.open_of_kind("carve")),
            "ledger_before": pkg.h.canonical_ledger()}
    journal.close_journal()
    pkg.topo.LEDGER.reset()
    j2, stats = pkg.h.restart(c)
    seen.update(stats=stats, ledger=pkg.h.canonical_ledger(),
                carves=[json.dumps(i.data, sort_keys=True) for i in j2.open_of_kind("carve")])
    seen["stats2"] = pkg.Recovery(c.kube, c.provider, j2).run()
    seen["ledger2"] = pkg.h.canonical_ledger()
    seen["carves2"] = len(j2.open_of_kind("carve"))
    return seen


def carve_torn_record(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    c1 = j.open_intent("carve", gang="lo", node="torn-n1", grid=[4, 4], type="tpu-v5e-4x4",
                       sig=[], cells=[0, 1], band="low", pods=["d/a"])
    j.open_intent("carve", gang="hi", node="torn-n1", grid=[4, 4], type="tpu-v5e-4x4", sig=[],
                  cells=[4, 5], band="high", pods=["d/b"])
    j.close_journal()
    path = os.path.join(d, sorted(f for f in os.listdir(d) if f.endswith(".wal"))[-1])
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-7])
    c = pkg.cluster(os.path.join(d, "cluster"), carve=True)
    c.kube.create(pkg.core.Node(metadata=pkg.core.ObjectMeta(name="torn-n1", namespace="")))
    j2 = pkg.jr.IntentJournal(d, fsync=False)
    torn = j2.stats()["torn_records"]
    stats = pkg.Recovery(c.kube, c.provider, j2).run()
    return {"torn": torn, "stats": stats, "ledger": pkg.h.canonical_ledger(),
            "open": sorted(j2.open_intents()) == [c1]}


CARVE_CASES = [carve_rotation_mid_preempt, carve_recovered_equals_snapshot, carve_double_replay,
               carve_bound_before_open, carve_torn_record]


@pytest.mark.parametrize("case", CARVE_CASES, ids=lambda c: c.__name__[6:])
def test_carve_durability_equals_the_jax_package(case, tmp_path, monkeypatch):
    j, p = both(lambda pkg: case(pkg, str(tmp_path / pkg.name)), monkeypatch)
    assert p == j
    if case is carve_recovered_equals_snapshot:
        assert p["before"] and p["ledgers"] == [p["before"], p["before"]]
        assert p["requeued"] == 0
    if case is carve_double_replay:
        assert [len(c) for c in p["counts"]] == [len(tcr.CARVE_VICTIM), 0]
        assert p["lo"] and p["open"] == 0
    if case is carve_bound_before_open:
        assert p["carve_intents_before"] == 0 and p["ledger_before"] == []
        assert [r[4] for r in p["ledger"]] == ["carve-lo"] and len(p["carves"]) == 1
        assert p["ledger2"] == p["ledger"] and p["carves2"] == 1
    if case is carve_torn_record:
        assert p["torn"] == 1 and p["open"]
        assert p["ledger"] == [("tpu-v5e-4x4", (4, 4), (0, 1), "low", "lo", ("d/a",))]
    if case is carve_rotation_mid_preempt:
        assert p["rotated"] and p["live"] and p["folded"]


# -- a reference finding: the pipeline drains on a simulated death --------------------

def drained_window(pkg, d):
    """Six plain pods in chunks of two at depth 2, crashed at the first
    ``bind:bound``: the pipeline's BaseException handler drains, so the dead
    process still launches and binds the chunk in flight."""
    c = pkg.cluster(d)
    journal = c.open_journal()
    if pkg.name == "jax":
        from karpenter_tpu.controllers.provisioning import ProvisionerWorker
        from karpenter_tpu.scheduling.batcher import Batcher
        from karpenter_tpu.solver.pipeline import PipelineConfig
        kw = {}
    else:
        from karpenter_tpu_torch.controllers.provisioning import ProvisionerWorker
        from karpenter_tpu_torch.scheduling.batcher import Batcher
        from karpenter_tpu_torch.solver.pipeline import PipelineConfig
        kw = {"device": "cpu"}
    worker = ProvisionerWorker(
        c.prov, c.kube, c.provider, batcher=Batcher(idle_seconds=0.02, max_seconds=0.2),
        pipeline_config=PipelineConfig(depth=2, chunk_items=2, adaptive=False),
        journal=journal, **kw)
    pods = [pkg.h.ensure_pod(c.kube, f"drain-{i}", cpu="1500m") for i in range(6)]
    for p in pods:
        worker.add(p, key=(p.metadata.namespace, p.metadata.name))
    pkg.inject.install(pkg.inject.FaultPlan(1, [pkg.inject.FaultSpec(
        "journal", "bind:bound", "crash-point", 1)], window=1))
    try:
        worker.provision()
        raise AssertionError("bind:bound never fired")
    except pkg.inject.SimulatedCrash:
        pass
    finally:
        pkg.inject.uninstall()
    bound = sorted(p.metadata.name for p in c.kube.list("Pod") if p.spec.node_name)
    return {"bound": bound, "state": pkg.h.canonical_state(c),
            "open": sorted((i.kind, i.phase) for i in journal.open_intents().values())}


def test_a_crash_drains_the_pipeline_in_both_packages(tmp_path, monkeypatch):
    j, p = both(lambda pkg: drained_window(pkg, str(tmp_path / pkg.name)), monkeypatch)
    assert p == j
    # the crashed chunk's first node has its pods bound but its bind
    # intent open; the chunk in flight was launched and bound after the
    # "death"
    assert len(p["bound"]) == 4  # chunk 1 (crashed) and chunk 2 (in flight) of 3
    assert ("bind", "bound") in p["open"]
