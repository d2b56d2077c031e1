"""The port's NodeController against the JAX package's, on the CPU.

Seeded node populations (ready or not, the not-ready taint, a missing
finalizer, ages, workload / DaemonSet / terminal pods, Provisioner TTLs)
are stored in each package's API server and reconciled under the same
clock trajectory (both packages' clocks set alike). After every reconcile
the requeue value and the node's state (taints, annotations, finalizers,
deletion time, or gone) must be equal. Between steps the same pods are
deleted or added, so emptiness stamps, clears and deletes.
"""

import numpy as np
import pytest

from tests.test_torch_whatif import BOTH, JAX, PORT

T0 = 1_000_000.0
# offsets on the clock, each with a pod event before the reconcile pass:
# ("drop", k) deletes the k-th workload pod, ("add", k) binds a new one
TRAJECTORY = [(0.0, None), (29.0, ("drop", 0)), (31.0, None), (61.0, ("add", 1)),
              (95.0, ("drop", 1)), (130.0, None), (601.0, None), (901.0, None),
              (1500.0, None)]


@pytest.fixture(autouse=True)
def pinned_clocks():
    yield
    JAX.clock.DEFAULT.reset()
    PORT.clock.DEFAULT.reset()


def set_clocks(t):
    for P in BOTH:
        P.clock.DEFAULT.set(t)


def populate(P, seed, n_nodes=10):
    """Seeded nodes and pods in a new API server of package ``P``."""
    c, wk = P.core, P.wk
    rng = np.random.RandomState(seed)
    kube = P.kube.KubeCore()
    ttl_empty = [None, 30, 60][rng.randint(3)]
    ttl_expire = [None, 600, 1200][rng.randint(3)]
    kube.create(P.prov.Provisioner(
        metadata=c.ObjectMeta(name="default"),
        spec=P.prov.ProvisionerSpec(ttl_seconds_after_empty=ttl_empty,
                                    ttl_seconds_until_expired=ttl_expire)))
    workloads = []
    for i in range(n_nodes):
        ready = rng.rand() < 0.75
        reason = ["", "NodeStatusNeverUpdated", "KubeletNotReady"][rng.randint(3)]
        cond = c.NodeCondition(type="Ready", status="True" if ready else
                               ["False", "Unknown"][rng.randint(2)],
                               reason="KubeletReady" if ready else reason)
        taints = [c.Taint(key=wk.NOT_READY_TAINT_KEY, effect="NoSchedule")] \
            if rng.rand() < 0.6 else []
        if rng.rand() < 0.3:
            taints.append(c.Taint(key="other", value="v", effect="NoSchedule"))
        labels = {wk.PROVISIONER_NAME_LABEL: "default"} if rng.rand() < 0.9 else {}
        node = c.Node(
            metadata=c.ObjectMeta(
                name=f"node-{i}", namespace="", labels=labels,
                finalizers=[wk.TERMINATION_FINALIZER] if rng.rand() < 0.8 else [],
                creation_timestamp=T0 - float(rng.choice([0, 100, 700, 1000]))),
            spec=c.NodeSpec(taints=taints),
            status=c.NodeStatus(conditions=[cond] if rng.rand() < 0.9 else []))
        kube.create(node)
        for j in range(rng.randint(3)):
            kind = rng.randint(3)  # workload, daemonset, terminal
            pod = c.Pod(metadata=c.ObjectMeta(name=f"p-{i}-{j}"),
                        spec=c.PodSpec(node_name=f"node-{i}"))
            if kind == 1:
                pod.metadata.owner_references.append(c.OwnerReference(kind="DaemonSet",
                                                                      name="ds"))
            if kind == 2:
                pod.status.phase = "Succeeded"
            kube.create(pod)
            if kind == 0:
                workloads.append(pod.metadata.name)
    return kube, workloads


def node_state(kube, name, P):
    try:
        n = kube.get("Node", name, "")
    except P.kube.NotFound:
        return "gone"
    return ([(t.key, t.value, t.effect) for t in n.spec.taints],
            sorted(n.metadata.annotations.items()), list(n.metadata.finalizers),
            n.metadata.deletion_timestamp)


def trajectory(P, seed):
    import importlib

    set_clocks(T0)
    kube, workloads = populate(P, seed)
    ctl = importlib.import_module(P.root + ".controllers.node").NodeController(kube)
    names = sorted(n.metadata.name for n in kube.list("Node"))
    out = []
    added = 0
    for offset, event in TRAJECTORY:
        set_clocks(T0 + offset)
        if event is not None and workloads:
            op, k = event
            if op == "drop":
                name = workloads[k % len(workloads)]
                try:
                    kube.delete("Pod", name, "default")
                except P.kube.NotFound:
                    pass
            else:
                node = names[k % len(names)]
                kube.create(P.core.Pod(metadata=P.core.ObjectMeta(name=f"late-{added}"),
                                       spec=P.core.PodSpec(node_name=node)))
                added += 1
        for name in names:
            out.append((offset, name, ctl.reconcile(name, ""), node_state(kube, name, P)))
    return out


class TestNodeControllerParity:
    @pytest.mark.parametrize("seed", range(12))
    def test_same_requeues_patches_and_deletes(self, seed):
        assert trajectory(JAX, seed) == trajectory(PORT, seed)

    def test_the_seeds_exercise_every_sub_reconciler(self):
        # stamps, deletes, finalizer re-adds and taint removal all happen
        seen = set()
        for seed in range(12):
            first = {}
            for offset, name, requeue, state in trajectory(PORT, seed):
                if state == "gone":
                    continue
                taints, annotations, finalizers, deleted = state
                if any(k == PORT.wk.EMPTINESS_TIMESTAMP_ANNOTATION for k, _ in annotations):
                    seen.add("stamp")
                if deleted is not None:
                    seen.add("delete")
                if name not in first:
                    first[name] = state
                    if PORT.wk.TERMINATION_FINALIZER in finalizers:
                        seen.add("finalizer")
                    if not any(t[0] == PORT.wk.NOT_READY_TAINT_KEY for t in taints):
                        seen.add("ready")
        assert seen == {"stamp", "delete", "finalizer", "ready"}


class TestSubReconcilers:
    def _one(self, P, **node_kw):
        import importlib

        c, wk = P.core, P.wk
        kube = P.kube.KubeCore()
        kube.create(P.prov.Provisioner(metadata=c.ObjectMeta(name="default"),
                                       spec=P.prov.ProvisionerSpec(ttl_seconds_after_empty=30)))
        kube.create(c.Node(
            metadata=c.ObjectMeta(name="n", namespace="",
                                  labels={wk.PROVISIONER_NAME_LABEL: "default"},
                                  creation_timestamp=T0),
            spec=c.NodeSpec(taints=[c.Taint(key=wk.NOT_READY_TAINT_KEY, effect="NoSchedule")]),
            status=c.NodeStatus(conditions=[c.NodeCondition(type="Ready", status="True",
                                                            reason="KubeletReady")])))
        ctl = importlib.import_module(P.root + ".controllers.node").NodeController(kube)
        return kube, ctl

    def test_empty_ready_node_lifecycle(self):
        for P in BOTH:
            set_clocks(T0)
            kube, ctl = self._one(P)
            assert ctl.reconcile("n", "") == 30.0
            n = kube.get("Node", "n", "")
            assert n.spec.taints == []
            assert P.wk.TERMINATION_FINALIZER in n.metadata.finalizers
            assert n.metadata.annotations[P.wk.EMPTINESS_TIMESTAMP_ANNOTATION] == repr(T0)
            set_clocks(T0 + 29)
            ctl.reconcile("n", "")
            assert kube.get("Node", "n", "").metadata.deletion_timestamp is None
            set_clocks(T0 + 31)
            ctl.reconcile("n", "")
            assert kube.get("Node", "n", "").metadata.deletion_timestamp == T0 + 31
