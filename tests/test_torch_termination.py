"""The port's eviction subresource and TerminationController against the
JAX package's, on the CPU.

**evict_pod** (seeded): pods with app/tier labels, some unscheduled and some
already terminating, under a seeded set of PodDisruptionBudgets (integer
and percentage values, minAvailable or maxUnavailable or both, and two
budgets selecting one pod); a seeded sequence of evictions must raise the
same error class in both packages, or delete the same pod, and leave the
same store.

**Termination**: the same terminating node in both packages goes through
cordon, the do-not-evict block, the non-critical-before-critical order,
PDB rejections (429 and 500) retried with backoff, one provider delete and
the finalizer strip, and ends in the same state.
"""

import time

import numpy as np
import pytest

from tests.expectations import eventually
from tests.test_torch_whatif import BOTH, JAX, PORT

NS = ("default", "team-a")


def pdb_world(P, seed):
    """Seeded pods and PDBs in a new API server of package ``P``."""
    c = P.core
    rng = np.random.RandomState(seed)
    kube = P.kube.KubeCore()
    for i in range(14):
        ns = NS[rng.randint(2)]
        labels = {"app": "abc"[rng.randint(3)]}
        if rng.rand() < 0.3:
            labels["tier"] = "x"
        node = f"node-{rng.randint(3)}" if rng.rand() < 0.85 else ""
        finalizers = ["hold"] if rng.rand() < 0.15 else []
        kube.create(c.Pod(metadata=c.ObjectMeta(name=f"p{i}", namespace=ns, labels=labels,
                                                finalizers=finalizers),
                          spec=c.PodSpec(node_name=node, termination_grace_period_seconds=0)))
        if finalizers and rng.rand() < 0.5:
            kube.delete("Pod", f"p{i}", ns)  # terminating, held by its finalizer
    values = [0, 1, 2, 3, "0%", "25%", "50%", "100%", "33%"]
    for j in range(rng.randint(1, 4)):
        sel = {"app": "abc"[rng.randint(3)]} if rng.rand() < 0.7 else {"tier": "x"}
        kind = rng.randint(4)
        min_a = values[rng.randint(len(values))] if kind in (0, 2) else None
        max_u = values[rng.randint(len(values))] if kind in (1, 2) else None
        if kind == 3 and rng.rand() < 0.5:
            min_a = "bogus"
        kube.create(c.PodDisruptionBudget(
            metadata=c.ObjectMeta(name=f"pdb-{j}", namespace=NS[rng.randint(2)]),
            selector=c.LabelSelector(match_labels=sel),
            min_available=min_a, max_unavailable=max_u))
    return kube


def store(kube):
    return sorted((p.metadata.namespace, p.metadata.name, p.metadata.deletion_timestamp)
                  for p in kube.list("Pod"))


def evictions(P, seed):
    P.clock.DEFAULT.set(1_700_000_000.0)
    try:
        kube = pdb_world(P, seed)
        rng = np.random.RandomState(500 + seed)
        out = []
        for _ in range(20):
            name, ns = f"p{rng.randint(16)}", NS[rng.randint(2)]
            try:
                kube.evict_pod(name, ns)
                outcome = "deleted"
            except P.kube.ApiError as e:
                outcome = type(e).__name__
            out.append((ns, name, outcome, store(kube)))
        return out
    finally:
        P.clock.DEFAULT.reset()


class TestEvictPod:
    @pytest.mark.parametrize("seed", range(16))
    def test_same_outcome_and_store(self, seed):
        assert evictions(JAX, seed) == evictions(PORT, seed)

    def test_the_seeds_exercise_every_outcome(self):
        outcomes = {o for seed in range(16) for _, _, o, _ in evictions(PORT, seed)}
        assert outcomes == {"deleted", "NotFound", "TooManyRequests", "InternalError"}

    @pytest.mark.parametrize("value, expected, want", [
        (3, 10, 3), ("50%", 5, 3), ("33%", 10, 4), ("0%", 7, 0), ("100%", 7, 7)])
    def test_scaled_int_or_percent(self, value, expected, want):
        for P in BOTH:
            assert P.kube._scaled_int_or_percent(value, expected, "p") == want

    @pytest.mark.parametrize("value", [True, "x%", 1.5, "7"])
    def test_malformed_int_or_string_is_a_500(self, value):
        for P in BOTH:
            with pytest.raises(P.kube.InternalError):
                P.kube._scaled_int_or_percent(value, 4, "p")


# -- termination -------------------------------------------------------------

def terminating_node(P, kube, name="node-1"):
    c, wk = P.core, P.wk
    kube.create(c.Node(metadata=c.ObjectMeta(
        name=name, namespace="", labels={wk.PROVISIONER_NAME_LABEL: "default"},
        finalizers=[wk.TERMINATION_FINALIZER])))
    kube.delete("Node", name, "")


def pod_on(P, kube, node, name, annotations=None, priority="", labels=None,
           tolerate=False, static=False):
    c = P.core
    pod = c.Pod(metadata=c.ObjectMeta(name=name, annotations=dict(annotations or {}),
                                      labels=dict(labels or {})),
                spec=c.PodSpec(node_name=node, priority_class_name=priority))
    if tolerate:
        pod.spec.tolerations.append(c.Toleration(key="node.kubernetes.io/unschedulable",
                                                 operator="Exists", effect="NoSchedule"))
    if static:
        pod.metadata.owner_references.append(c.OwnerReference(kind="Node", name=node))
    kube.create(pod)


def controller(P, kube, provider):
    import importlib

    return importlib.import_module(P.root + ".controllers.termination") \
        .TerminationController(kube, provider)


def pods_left(kube):
    return sorted(p.metadata.name for p in kube.list("Pod"))


def node_gone(P, kube, name="node-1"):
    try:
        kube.get("Node", name, "")
        return False
    except P.kube.NotFound:
        return True


def drive(P, setup, between=None, timeout=15.0):
    """Reconcile node-1 until it is gone; returns (evicted pod order,
    whether it was cordoned at the first requeue, provider deletes)."""
    kube = P.kube.KubeCore()
    provider = P.fake.FakeCloudProvider()
    ctl = controller(P, kube, provider)
    terminating_node(P, kube)
    setup(P, kube)
    events = kube.watch("Pod")
    order, cordoned = [], None
    try:
        deadline = time.monotonic() + timeout
        while not node_gone(P, kube):
            assert time.monotonic() < deadline, f"{P.root}: node never terminated"
            requeue = ctl.reconcile("node-1", "")
            if cordoned is None and not node_gone(P, kube):
                cordoned = kube.get("Node", "node-1", "").spec.unschedulable
            if requeue is not None and between is not None:
                between(P, kube)
            while not events.empty():
                e = events.get_nowait()
                if e.type == "DELETED":
                    order.append(e.obj.metadata.name)
            time.sleep(0.02)
        while not events.empty():
            e = events.get_nowait()
            if e.type == "DELETED":
                order.append(e.obj.metadata.name)
    finally:
        ctl.stop_all()
    return order, cordoned, list(provider.deleted), pods_left(kube)


class TestTermination:
    def test_critical_after_non_critical_and_static_kept(self):
        def setup(P, kube):
            pod_on(P, kube, "node-1", "crit", priority="system-node-critical")
            pod_on(P, kube, "node-1", "work-a")
            pod_on(P, kube, "node-1", "work-b")
            pod_on(P, kube, "node-1", "static", static=True)
            pod_on(P, kube, "node-1", "tolerant", tolerate=True)
            pod_on(P, kube, "node-2", "elsewhere")
        results = [drive(P, setup) for P in BOTH]
        for order, cordoned, deleted, left in results:
            assert cordoned is True
            assert set(order[:2]) == {"work-a", "work-b"} and order[2:] == ["crit"]
            assert deleted == ["node-1"]
            assert left == ["elsewhere", "static", "tolerant"]
        assert [r[1:] for r in results[:1]] == [r[1:] for r in results[1:]]

    def test_do_not_evict_blocks_until_removed(self):
        for P in BOTH:
            kube = P.kube.KubeCore()
            provider = P.fake.FakeCloudProvider()
            ctl = controller(P, kube, provider)
            try:
                terminating_node(P, kube)
                pod_on(P, kube, "node-1", "pinned",
                       annotations={P.wk.DO_NOT_EVICT_ANNOTATION: "true"})
                pod_on(P, kube, "node-1", "work")
                for _ in range(3):
                    assert ctl.reconcile("node-1", "") == 1.0
                    time.sleep(0.05)
                assert pods_left(kube) == ["pinned", "work"]  # nothing evicted
                assert kube.get("Node", "node-1", "").spec.unschedulable
                assert provider.deleted == []
                kube.delete("Pod", "pinned", "default")

                def done():
                    ctl.reconcile("node-1", "")
                    assert node_gone(P, kube)
                eventually(done)
                assert provider.deleted == ["node-1"] and pods_left(kube) == []
            finally:
                ctl.stop_all()

    @pytest.mark.parametrize("misconfigured", [False, True])
    def test_pdb_rejections_back_off_then_release(self, misconfigured):
        def setup(P, kube):
            c = P.core
            pod_on(P, kube, "node-1", "guarded", labels={"app": "db"})
            pod_on(P, kube, "node-2", "peer", labels={"app": "db"})
            budgets = [dict(min_available=2)] if not misconfigured else \
                [dict(min_available=0), dict(max_unavailable="50%")]
            for i, kw in enumerate(budgets):
                kube.create(c.PodDisruptionBudget(
                    metadata=c.ObjectMeta(name=f"pdb-{i}"),
                    selector=c.LabelSelector(match_labels={"app": "db"}), **kw))

        state = {}

        def between(P, kube):
            # release the budget after a few rounds of backoff
            n = state[P.root] = state.get(P.root, 0) + 1
            if n == 8:
                kube.delete("PodDisruptionBudget", "pdb-0", "default")

        results = [drive(P, setup, between) for P in BOTH]
        for order, cordoned, deleted, left in results:
            assert order == ["guarded"] and deleted == ["node-1"] and left == ["peer"]
        assert state[JAX.root] >= 8 and state[PORT.root] >= 8

    def test_finalizer_stripped_and_delete_called_once(self):
        for P in BOTH:
            kube = P.kube.KubeCore()
            provider = P.fake.FakeCloudProvider()
            ctl = controller(P, kube, provider)
            try:
                terminating_node(P, kube)
                assert ctl.reconcile("node-1", "") is None
                assert node_gone(P, kube) and provider.deleted == ["node-1"]
                assert ctl.reconcile("node-1", "") is None
                assert provider.deleted == ["node-1"]
            finally:
                ctl.stop_all()

    def test_live_node_is_ignored(self):
        for P in BOTH:
            kube = P.kube.KubeCore()
            provider = P.fake.FakeCloudProvider()
            ctl = controller(P, kube, provider)
            try:
                kube.create(P.core.Node(metadata=P.core.ObjectMeta(
                    name="live", namespace="", finalizers=[P.wk.TERMINATION_FINALIZER])))
                assert ctl.reconcile("live", "") is None
                assert not kube.get("Node", "live", "").spec.unschedulable
                assert provider.deleted == []
            finally:
                ctl.stop_all()


def test_terminate_releases_the_node_carves_as_jax():
    """A terminated carved node leaves the occupancy ledger in both
    packages; another node's carves stay."""
    import importlib

    left = []
    for P in BOTH:
        topo = importlib.import_module(P.root + ".ops.topology")
        term = importlib.import_module(P.root + ".controllers.termination")
        topo.LEDGER.reset()
        kube = P.kube.KubeCore()
        terminating_node(P, kube, "carved-n1")
        node = kube.get("Node", "carved-n1", "")
        topo.LEDGER.commit("carved-n1", (4, 4), "tpu-v5e-4x4", ((), ()), ("ns", "g1"),
                           [0, 1, 4, 5], "default", [("ns", "p0")])
        topo.LEDGER.commit("other", (4, 4), "tpu-v5e-4x4", ((), ()), ("ns", "g2"),
                           [0, 1], "low", [("ns", "p1")])
        terminator = term.Terminator(kube, P.fake.FakeCloudProvider())
        try:
            terminator.terminate(node)
        finally:
            terminator.eviction_queue.stop()
        left.append([ng.node for ng in topo.LEDGER.snapshot()])
        topo.LEDGER.reset()
    assert left == [["other"], ["other"]]
