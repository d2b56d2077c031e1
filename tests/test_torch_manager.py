"""The port's controller manager, leader election and logging-config
controller, with the JAX package's cases (tests/test_leader_ratelimit.py
less the token bucket, tests/test_races.py's work queue, tests/test_gc.py's
time-driven wiring, tests/test_chaos.py's mapped-pump retry and
tests/test_aux_controllers.py's logging cases), and the election held
against the JAX package's round by round on the same clock.

Every Manager a test starts is stopped in the test, and stop() must leave
none of its threads alive.
"""

import logging
import random
import sys
import threading
import time
import uuid

import pytest

from karpenter_tpu.runtime import kubecore as jax_kubecore
from karpenter_tpu.runtime import leaderelection as jax_le
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch.api.core import ConfigMap, Lease, ObjectMeta
from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider, instance_types
from karpenter_tpu_torch.controllers.gc import GarbageCollection
from karpenter_tpu_torch.controllers.logging_config import (
    LoggingConfigController, validate_config,
)
from karpenter_tpu_torch.runtime.kubecore import KubeCore
from karpenter_tpu_torch.runtime.leaderelection import LEASE_NAME, LeaderElector
from karpenter_tpu_torch.runtime.manager import Manager, _WorkQueue
from karpenter_tpu_torch.utils import clock
from tests.test_torch_controller import unschedulable_pod


def no_live(threads):
    return [t.name for t in threads if t.is_alive()]


class Recorder:
    """A controller that records its reconciles and can fail or requeue."""

    def __init__(self, kind="Pod", fail=0, requeue=None):
        self._kind = kind
        self.fail = fail
        self.requeue = requeue
        self.calls = []
        self.seen = threading.Event()

    def kind(self):
        return self._kind

    def reconcile(self, name, namespace="default"):
        self.calls.append((name, namespace))
        self.seen.set()
        if self.fail:
            self.fail -= 1
            raise RuntimeError("reconcile failed (injected)")
        return self.requeue


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class TestWorkQueue:
    def test_dedupes_pending_keys(self):
        wq = _WorkQueue()
        for _ in range(3):
            wq.add(("a", "default"))
        wq.add(("b", "default"))
        assert wq.get(0.1) == ("a", "default") and wq.get(0.1) == ("b", "default")
        assert wq.get(0.05) is None

    def test_re_add_while_processing_requeues_once_on_done(self):
        wq = _WorkQueue()
        wq.add(("a", "ns"))
        item = wq.get(0.1)
        wq.add(item)
        wq.add(item)
        assert wq.get(0.05) is None  # never handed to a second worker
        wq.done(item)
        assert wq.get(0.1) == item
        wq.done(item)
        assert wq.get(0.05) is None

    def test_add_after_delays_the_key(self):
        wq = _WorkQueue()
        t0 = time.monotonic()
        wq.add_after(("a", "ns"), 0.15)
        assert wq.get(0.05) is None
        assert wq.get(1.0) == ("a", "ns") and time.monotonic() - t0 >= 0.15

    def test_shutdown_wakes_a_waiting_get(self):
        wq = _WorkQueue()
        got = []
        t = threading.Thread(target=lambda: got.append(wq.get(5.0)))
        t.start()
        wq.shutdown()
        t.join(2.0)
        assert not t.is_alive() and got == [None]

    def test_processing_exclusivity_and_no_lost_dirty(self):
        wq = _WorkQueue()
        keys = [(f"k{i}", "default") for i in range(8)]
        in_flight, lock, errors = set(), threading.Lock(), []
        processed = {k: 0 for k in keys}
        stop = threading.Event()

        def adder(seed):
            rng = random.Random(seed)
            while not stop.is_set():
                wq.add(rng.choice(keys))
                time.sleep(rng.uniform(0.0, 0.002))

        def worker():
            try:
                while not stop.is_set():
                    item = wq.get(timeout=0.05)
                    if item is None:
                        continue
                    with lock:
                        assert item not in in_flight, f"{item} handed twice"
                        in_flight.add(item)
                    time.sleep(0.001)
                    with lock:
                        in_flight.discard(item)
                        processed[item] += 1
                    wq.done(item)
            except AssertionError as e:
                errors.append(repr(e))

        threads = [threading.Thread(target=adder, args=(s,)) for s in range(3)]
        threads += [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(5.0)
        assert not errors, errors[0]
        assert all(processed[k] > 0 for k in keys), processed


class TestManager:
    def test_watch_event_reconciles_and_stop_leaves_no_thread(self):
        kube = KubeCore()
        ctrl = Recorder()
        manager = Manager(kube)
        manager.register(ctrl, workers=3)
        manager.start()
        threads = manager.threads()
        assert {t.name for t in threads} == {"pump-Pod", "work-Pod-0", "work-Pod-1",
                                             "work-Pod-2"}
        try:
            kube.create(unschedulable_pod(name="p1"))
            assert ctrl.seen.wait(5.0)
            assert ctrl.calls[0] == ("p1", "default")
            assert manager.healthz()
        finally:
            manager.stop()
        assert no_live(threads) == []
        assert not manager.healthz()
        assert kube._watchers == []  # the pump's watch is unsubscribed

    def test_meta_only_primary_watch(self):
        """The primary pump subscribes meta-only: events carry MetaObj stubs,
        not deep copies."""
        from karpenter_tpu_torch.runtime.kubecore import MetaObj

        kube = KubeCore()
        kube.create(unschedulable_pod(name="before"))
        q = kube.watch("Pod", meta_only=True)
        kube.create(unschedulable_pod(name="after"))
        events = [q.get(timeout=1.0), q.get(timeout=1.0)]
        assert [type(e.obj) for e in events] == [MetaObj, MetaObj]
        assert [(e.type, e.obj.metadata.name) for e in events] == [("ADDED", "before"),
                                                                   ("ADDED", "after")]
        full = kube.watch("Pod")
        assert full.get(timeout=1.0).obj.spec is not None
        kube.unwatch(q)
        kube.unwatch(full)

    def test_failed_reconcile_is_retried(self):
        kube = KubeCore()
        ctrl = Recorder(fail=1)
        manager = Manager(kube)
        manager.register(ctrl)
        manager.start()
        try:
            kube.create(unschedulable_pod(name="p1"))
            assert wait_for(lambda: len(ctrl.calls) >= 2, 5.0)  # 1 s backoff
        finally:
            manager.stop()
        assert ctrl.calls[:2] == [("p1", "default")] * 2

    def test_requeue_after_reconciles_again(self):
        kube = KubeCore()
        ctrl = Recorder(requeue=0.05)
        manager = Manager(kube)
        manager.register(ctrl)
        manager.start()
        try:
            kube.create(unschedulable_pod(name="p1"))
            assert wait_for(lambda: len(ctrl.calls) >= 3, 5.0)
        finally:
            manager.stop()

    def test_seeded_time_driven_controller_reconciles_periodically(self):
        """A kind()=None controller runs from its seed key and keeps itself
        alive through its requeue interval (tests/test_gc.py)."""
        class CountingGC(GarbageCollection):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.runs = 0
                self.ran_twice = threading.Event()

            def reconcile(self, name, namespace="default"):
                out = super().reconcile(name, namespace)
                self.runs += 1
                if self.runs >= 2:
                    self.ran_twice.set()
                return out

        kube = KubeCore()
        gc = CountingGC(kube, FakeCloudProvider(catalog=instance_types(2)),
                        interval_seconds=0.05, grace_seconds=60.0)
        manager = Manager(kube)
        manager.register(gc)
        manager.start()
        try:
            assert gc.ran_twice.wait(10.0), f"time-driven GC ran {gc.runs}x"
            assert [t.name for t in manager.threads()] == ["work-CountingGC-0"]
        finally:
            manager.stop()

    def test_mapped_pump_retries_a_failing_mapping(self):
        """A transient mapping failure is retried with backoff, not dropped
        (tests/test_chaos.py)."""
        class FlakyMapped:
            def __init__(self):
                self.map_calls = 0
                self.reconciled = threading.Event()

            def kind(self):
                return "Node"

            def mappings(self):
                def map_pod(pod):
                    self.map_calls += 1
                    if self.map_calls <= 3:
                        raise ConnectionError("transport failure: timed out")
                    return [("mapped-target", "default")]
                return [("Pod", map_pod)]

            def reconcile(self, name, namespace="default"):
                if name == "mapped-target":
                    self.reconciled.set()

        kube = KubeCore()
        ctrl = FlakyMapped()
        manager = Manager(kube)
        manager.register(ctrl)
        manager.start()
        try:
            kube.create(unschedulable_pod(name="trigger"))
            assert ctrl.reconciled.wait(10.0), f"map_fn called {ctrl.map_calls}x"
            assert ctrl.map_calls >= 4
            assert "map-Pod-Node" in {t.name for t in manager.threads()}
        finally:
            manager.stop()
        assert no_live(manager.threads()) == []

    def test_node_controller_maps_pods_and_provisioners(self):
        from karpenter_tpu_torch.api import wellknown
        from karpenter_tpu_torch.api.core import Node, Pod, PodSpec
        from karpenter_tpu_torch.api.provisioner import Provisioner
        from karpenter_tpu_torch.controllers.node import NodeController

        kube = KubeCore()
        node = Node(metadata=ObjectMeta(name="n1", namespace="",
                                        labels={wellknown.PROVISIONER_NAME_LABEL: "p"}))
        kube.create(node)
        (pod_map, pod_fn), (prov_map, prov_fn) = NodeController(kube).mappings()
        assert (pod_map, prov_map) == ("Pod", "Provisioner")
        assert pod_fn(Pod(spec=PodSpec(node_name="n1"))) == [("n1", "")]
        assert pod_fn(Pod(spec=PodSpec())) == []
        assert prov_fn(Provisioner(metadata=ObjectMeta(name="p"))) == [("n1", "")]


class TestLeaderElection:
    def setup_method(self):
        clock.DEFAULT.set(3_000_000.0)
        jax_clock.DEFAULT.set(3_000_000.0)

    def teardown_method(self):
        clock.DEFAULT.reset()
        jax_clock.DEFAULT.reset()

    def test_rounds_match_the_jax_elector(self):
        """Two candidates in each package, the same rounds on the same
        clock: the same winners, and the same lease afterwards."""
        port_kube, jax_kube = KubeCore(), jax_kubecore.KubeCore()
        port = {n: LeaderElector(port_kube, identity=n, lease_duration=15) for n in "ab"}
        jax = {n: jax_le.LeaderElector(jax_kube, identity=n, lease_duration=15)
               for n in "ab"}
        script = [("a", 0), ("b", 0), ("a", 5), ("b", 5), ("b", 16), ("b", 0),
                  ("a", 0), ("a", 30), ("b", 0)]
        for who, advance in script:
            clock.DEFAULT.advance(advance)
            jax_clock.DEFAULT.advance(advance)
            assert port[who].try_acquire_or_renew() == jax[who].try_acquire_or_renew(), \
                (who, advance)
        pl, jl = port_kube.get("Lease", LEASE_NAME), jax_kube.get("Lease", jax_le.LEASE_NAME)
        assert (pl.spec.holder_identity, pl.spec.acquire_time, pl.spec.renew_time) == \
            (jl.spec.holder_identity, jl.spec.acquire_time, jl.spec.renew_time)

    def test_first_candidate_wins_second_waits(self):
        kube = KubeCore()
        a, b = LeaderElector(kube, identity="a"), LeaderElector(kube, identity="b")
        assert a.try_acquire_or_renew() is True
        assert b.try_acquire_or_renew() is False
        clock.DEFAULT.advance(5)
        assert a.try_acquire_or_renew() is True
        assert b.try_acquire_or_renew() is False

    def test_expired_lease_is_taken_over(self):
        kube = KubeCore()
        a = LeaderElector(kube, identity="a", lease_duration=15)
        b = LeaderElector(kube, identity="b", lease_duration=15)
        assert a.try_acquire_or_renew()
        clock.DEFAULT.advance(16)
        assert b.try_acquire_or_renew() is True
        assert kube.get("Lease", LEASE_NAME).spec.holder_identity == "b"
        assert a.try_acquire_or_renew() is False

    def test_release_on_stop_frees_lease(self):
        kube = KubeCore()
        a = LeaderElector(kube, identity="a")
        assert a.try_acquire_or_renew()
        a._leading = True
        a.stop()
        assert kube.get("Lease", LEASE_NAME).spec.holder_identity == ""
        assert LeaderElector(kube, identity="b").try_acquire_or_renew() is True

    def test_run_loop_transitions(self):
        kube = KubeCore()
        started = threading.Event()
        a = LeaderElector(kube, identity="a", renew_period=0.02,
                          on_started_leading=started.set)
        a.start()
        assert started.wait(5.0) and a.is_leader()
        a.stop()
        assert not a._thread.is_alive()
        assert isinstance(kube.get("Lease", LEASE_NAME), Lease)

    def test_api_error_demotes_instead_of_killing_thread(self):
        kube = KubeCore()
        stopped, started = threading.Event(), threading.Event()
        a = LeaderElector(kube, identity="a", renew_period=0.02,
                          on_stopped_leading=stopped.set, on_started_leading=started.set)
        a.start()
        assert started.wait(5.0)

        def boom(*args, **kw):
            raise OSError("api down")

        a.kube = type("K", (), {"get": boom, "create": boom, "update": boom, "patch": boom})()
        assert stopped.wait(5.0), "a leader must demote on an API failure"
        assert not a.is_leader() and a._thread.is_alive()
        a.kube = kube
        clock.DEFAULT.advance(60)
        started2 = threading.Event()
        a.on_started_leading = started2.set
        assert started2.wait(5.0)
        a.stop()

    def test_stop_does_not_strand_lease_on_dead_identity(self):
        kube = KubeCore()
        started = threading.Event()
        a = LeaderElector(kube, identity="a", renew_period=0.01,
                          on_started_leading=started.set)
        a.start()
        assert started.wait(5.0)
        a.stop()
        lease = kube.get("Lease", LEASE_NAME)
        assert lease.spec.holder_identity != "a" or lease.spec.renew_time is None
        assert LeaderElector(kube, identity="b").try_acquire_or_renew() is True

    def test_wait_for_leadership_timeout_is_wall_time(self):
        kube = KubeCore()
        assert LeaderElector(kube, identity="holder").try_acquire_or_renew()
        loser = LeaderElector(kube, identity="loser", renew_period=0.02)
        loser.start()
        assert loser.wait_for_leadership(timeout=0.3) is False
        loser.stop()

    def test_wait_for_leadership_honors_the_interrupt(self):
        kube = KubeCore()
        assert LeaderElector(kube, identity="holder").try_acquire_or_renew()
        loser = LeaderElector(kube, identity="loser", renew_period=0.02)
        loser.start()
        interrupt = threading.Event()
        threading.Timer(0.1, interrupt.set).start()
        t0 = time.monotonic()
        assert loser.wait_for_leadership(interrupt=interrupt) is False
        assert time.monotonic() - t0 < 5.0
        loser.stop()

    def test_update_rejects_a_stale_resource_version(self):
        from karpenter_tpu_torch.runtime.kubecore import Conflict

        kube = KubeCore()
        assert LeaderElector(kube, identity="a").try_acquire_or_renew()
        stale = kube.get("Lease", LEASE_NAME)
        kube.update(kube.get("Lease", LEASE_NAME))
        with pytest.raises(Conflict):
            kube.update(stale)


class TestLoggingConfig:
    def reconcile(self, data, namespace="default", own="default"):
        kube = KubeCore()
        root = f"karpenter-test-{uuid.uuid4().hex[:6]}"
        kube.create(ConfigMap(metadata=ObjectMeta(name="config-logging", namespace=namespace),
                              data=data))
        LoggingConfigController(kube, namespace=own, root_logger=root).reconcile(
            "config-logging", namespace)
        return root

    def test_sets_root_level_from_zap_config(self):
        root = self.reconcile({"zap-logger-config": '{"level": "debug"}'})
        assert logging.getLogger(root).level == logging.DEBUG

    def test_component_override(self):
        root = self.reconcile({"loglevel.solver": "error"})
        assert logging.getLogger(f"{root}.solver").level == logging.ERROR

    @pytest.mark.parametrize("raw", ["not json", '"debug"'])
    def test_invalid_config_ignored(self, raw):
        root = self.reconcile({"zap-logger-config": raw})
        assert logging.getLogger(root).level == logging.NOTSET

    def test_foreign_namespace_ignored_own_applied(self):
        root = self.reconcile({"zap-logger-config": '{"level": "debug"}'}, namespace="tenant")
        assert logging.getLogger(root).level == logging.NOTSET
        root = self.reconcile({"zap-logger-config": '{"level": "warn"}'}, namespace="karpenter",
                              own="karpenter")
        assert logging.getLogger(root).level == logging.WARNING

    def test_other_configmaps_ignored(self):
        kube = KubeCore()
        kube.create(ConfigMap(metadata=ObjectMeta(name="other"), data={}))
        assert LoggingConfigController(kube).reconcile("other") is None

    @pytest.mark.parametrize("data", [{"loglevel.x": "loud"},
                                      {"zap-logger-config": '{"level": "nope"}'},
                                      {"zap-logger-config": '{"level": "warn"}'},
                                      {"zap-logger-config": "[1]"},
                                      {"loglevel.solver": "debug"}])
    def test_validation_matches_the_jax_package(self, data):
        from karpenter_tpu.controllers.logging_config import validate_config as jax_validate

        assert validate_config(data) == jax_validate(data)

    def test_under_the_manager(self):
        """The controller watches ConfigMaps: creating the map under a
        running Manager applies it."""
        kube = KubeCore()
        root = f"karpenter-mgr-{uuid.uuid4().hex[:6]}"
        manager = Manager(kube)
        manager.register(LoggingConfigController(kube, root_logger=root))
        manager.start()
        try:
            kube.create(ConfigMap(metadata=ObjectMeta(name="config-logging"),
                                  data={"zap-logger-config": '{"level": "error"}'}))
            assert wait_for(lambda: logging.getLogger(root).level == logging.ERROR, 5.0)
        finally:
            manager.stop()


def test_pack_and_whatif_windows_at_once():
    """Under the Manager provisioning (the pack kernel's window, through the
    process DeviceRing) and consolidation (the what-if scan) reconcile on
    worker threads at once: two threads each run their path several times
    concurrently, and every answer equals the one the same call gives
    alone, with the executor counts of both."""
    from karpenter_tpu_torch.solver import batch_solve, pipeline, whatif
    from karpenter_tpu_torch.solver import solve as solve_mod
    from tests.test_torch_batch_solve import canonical, window
    from tests.test_torch_whatif import encodings

    probs = window("port", 21, 3, 60, 24, 20)
    cfg = solve_mod.SolverConfig(device_min_pods=0)
    enc = encodings(7)[1][0]
    want_batch = [canonical(r, p.pods)
                  for r, p in zip(batch_solve.solve_batch(probs, cfg, device="cpu"), probs)]
    solve_mod.reset_executor_counts()
    want_feasible, want_slots, want_executor = whatif.solve_window(enc, "cpu")
    per_window = solve_mod.solver_health()["executor_counts"]
    assert set(per_window) == {want_executor}
    pipeline.reset_ring()
    solve_mod.reset_executor_counts()
    got, errors = {"batch": [], "whatif": []}, []

    def run(kind):
        try:
            for _ in range(5):
                if kind == "batch":
                    rs = batch_solve.solve_batch(probs, cfg, device="cpu")
                    got["batch"].append([canonical(r, p.pods) for r, p in zip(rs, probs)])
                else:
                    got["whatif"].append(whatif.solve_window(enc, "cpu"))
        except Exception as e:  # reported on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in ("batch", "whatif", "batch")]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert got["batch"] == [want_batch] * 10
    for feasible, slots, executor in got["whatif"]:
        assert (feasible == want_feasible).all() and (slots == want_slots).all()
        assert executor == want_executor
    assert solve_mod.solver_health()["executor_counts"] == {
        "device-batch": 30, want_executor: 5 * per_window[want_executor]}
    ring = pipeline.get_ring().counters()
    assert ring["slots"] <= pipeline.get_ring().max_slots and ring["allocations"] >= 1
