"""The port's in-memory API server against the JAX package's.

**Differential** (seeds 1, 7 and 42): a seeded trace of a few hundred
operations — create, get, read, list (by namespace, label selector and the
spec.nodeName index), patch, delete (with and without finalizers) and
bind_pods — is applied to the JAX package's ``KubeCore`` and to the
port's in the same order, with both packages' clocks pinned. After every
operation the outcome (the returned value's canonical form, or the
exception's class name) and the whole store state must be equal, exactly.

**Alone:** the port's fast copy equals ``copy.deepcopy`` on every object
kind the controllers store, and the watch semantics under striping (the
copy-on-write watcher list, no object lost across registration, the
world watch, events as isolated copies).
"""

import copy
import queue
import random
import threading

import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.runtime import kubecore as jax_kube
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.runtime import kubecore as port_kube
from karpenter_tpu_torch.utils import clock as port_clock
from karpenter_tpu_torch.utils.fastcopy import deep_copy
from karpenter_tpu_torch.utils.resources import parse_resource_list

NAMESPACES = ("default", "team-a")
POD_NAMES = [f"pod-{i}" for i in range(12)]
NODE_NAMES = [f"node-{i}" for i in range(4)]
PINNED = 1_700_000_000.0


@pytest.fixture(autouse=True)
def pinned_clocks():
    jax_clock.DEFAULT.set(PINNED)
    port_clock.DEFAULT.set(PINNED)
    yield
    jax_clock.DEFAULT.reset()
    port_clock.DEFAULT.reset()


def make_obj(core, kind, name, ns, labels=None, finalizers=None):
    meta = core.ObjectMeta(name=name, namespace=ns, labels=dict(labels or {}),
                           finalizers=list(finalizers or []))
    if kind == "Pod":
        return core.Pod(metadata=meta, spec=core.PodSpec())
    return core.Node(metadata=meta)


def canon(obj):
    """The fields a store operation can change, as plain tuples."""
    if obj is None or isinstance(obj, (str, bool, int)):
        return obj
    if isinstance(obj, list):
        return [canon(o) for o in obj]
    m = obj.metadata
    node = getattr(obj.spec, "node_name", None)
    return (obj.kind, m.namespace, m.name, m.resource_version, m.uid, m.creation_timestamp,
            m.deletion_timestamp, tuple(m.finalizers), tuple(sorted(m.labels.items())), node)


def state(store):
    objs = []
    for kind in ("Pod", "Node"):
        objs += store.list(kind)
    by_node = {n: sorted(p.metadata.name for p in store.pods_on_node(n)) for n in NODE_NAMES}
    return sorted(canon(objs)), by_node


def random_op(rng):
    kind = rng.choice(("Pod", "Pod", "Node"))
    ns = rng.choice(NAMESPACES) if kind == "Pod" else "default"
    name = rng.choice(POD_NAMES if kind == "Pod" else NODE_NAMES)
    op = rng.choice(("create", "create", "get", "read", "list", "patch", "delete",
                     "bind_pods", "bind_pods", "unfinalize"))
    labels = {"app": rng.choice(("web", "db"))}
    finalizers = ["f"] if rng.random() < 0.3 else []
    node = rng.choice(NODE_NAMES)
    names = rng.sample(POD_NAMES, 3)
    return op, kind, ns, name, labels, finalizers, node, names


def apply(pkg, store, op_args):
    core = jax_core if pkg == "jax" else port_core
    op, kind, ns, name, labels, finalizers, node, names = op_args
    if op == "create":
        return store.create(make_obj(core, kind, name, ns, labels, finalizers))
    if op == "get":
        return store.get(kind, name, ns)
    if op == "read":
        return store.read(kind, name, ns, lambda o: o.metadata.resource_version)
    if op == "list":
        sel = core.LabelSelector(match_labels=labels)
        return store.list(kind, namespace=ns, label_selector=sel)
    if op == "patch":
        return store.patch(kind, name, ns, lambda o: o.metadata.labels.update(labels))
    if op == "delete":
        return store.delete(kind, name, ns)
    if op == "unfinalize":
        return store.patch(kind, name, ns, lambda o: o.metadata.finalizers.clear())
    return store.bind_pods([make_obj(core, "Pod", n, ns) for n in names], node)


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_serialized_trace_matches_the_jax_store(seed):
    rng = random.Random(seed)
    jax_store, port_store = jax_kube.KubeCore(), port_kube.KubeCore()
    for step in range(300):
        op_args = random_op(rng)
        outcomes = []
        for pkg, store in (("jax", jax_store), ("port", port_store)):
            try:
                outcomes.append(("ok", canon(apply(pkg, store, op_args))))
            except jax_kube.ApiError as e:
                outcomes.append(("raise", type(e).__name__))
            except port_kube.ApiError as e:
                outcomes.append(("raise", type(e).__name__))
        assert outcomes[0] == outcomes[1], f"step {step}: {op_args}"
        assert state(jax_store) == state(port_store), f"step {step}: {op_args}"


def full_pod():
    c = port_core
    req = c.NodeSelectorRequirement(key="k", operator="In", values=["a", "b"])
    return c.Pod(
        metadata=c.ObjectMeta(name="p", labels={"app": "web"}, finalizers=["f"],
                              owner_references=[c.OwnerReference(kind="DaemonSet", name="d")]),
        spec=c.PodSpec(
            node_selector={"zone": "z1"},
            containers=[c.Container(resources=c.ResourceRequirements.make(
                requests={"cpu": "1", "memory": "1Gi"}, limits={"nvidia.com/gpu": "1"}))],
            tolerations=[c.Toleration(key="t", operator="Exists")],
            affinity=c.Affinity(
                node_affinity=c.NodeAffinity(
                    required=[c.NodeSelectorTerm(match_expressions=[req])],
                    preferred=[c.PreferredSchedulingTerm(weight=3, preference=c.NodeSelectorTerm(
                        match_expressions=[req]))]),
                pod_affinity=c.PodAffinity(required=[c.PodAffinityTerm(
                    topology_key="zone", label_selector=c.LabelSelector(match_labels={"a": "b"}))])),
            topology_spread_constraints=[c.TopologySpreadConstraint(topology_key="zone")],
            priority=7),
        status=c.PodStatus(conditions=[c.PodCondition(type="PodScheduled", reason="Unschedulable")]))


def full_objects():
    c = port_core
    pod = full_pod()
    pod.__dict__["_torch_marshal"] = ((1, 2), 0)  # a cache entry rides along
    node = c.Node(metadata=c.ObjectMeta(name="n"), spec=c.NodeSpec(taints=[c.Taint(key="t")]),
                  status=c.NodeStatus(capacity=parse_resource_list({"cpu": "4"}),
                                      conditions=[c.NodeCondition(type="Ready", status="True")]))
    ds = c.DaemonSet(metadata=c.ObjectMeta(name="d"), spec=c.DaemonSetSpec(
        template=c.PodTemplateSpec(spec=full_pod().spec)))
    prov = Provisioner(metadata=c.ObjectMeta(name="default"))
    prov.spec.constraints = Constraints(labels={"a": "b"})
    return [pod, node, ds, prov]


@pytest.mark.parametrize("obj", full_objects(), ids=lambda o: o.kind)
def test_fast_copy_equals_deepcopy(obj):
    fast, slow = deep_copy(obj), copy.deepcopy(obj)
    # repr, not ==: Requirements (in a Provisioner) compares by identity
    assert repr(fast) == repr(slow) and fast.__dict__.keys() == slow.__dict__.keys()
    assert fast is not obj and fast.metadata is not obj.metadata
    fast.metadata.labels["mutated"] = "yes"
    assert "mutated" not in obj.metadata.labels


def test_fast_copy_rebuilds_every_list():
    """Value lists are copied inline (atoms are not recursed into): the copy
    shares no list with the original."""
    pod = full_pod()
    fast = deep_copy(pod)
    req, fast_req = (p.spec.affinity.node_affinity.required[0].match_expressions[0]
                     for p in (pod, fast))
    assert fast_req.values == req.values and fast_req.values is not req.values
    fast_req.values.append("extra")
    assert "extra" not in req.values
    assert fast.spec.containers is not pod.spec.containers


def test_watchers_list_is_copy_on_write():
    core = port_kube.KubeCore()
    q1 = core.watch("Pod")
    snapshot = core._watchers
    content = list(snapshot)
    q2 = core.watch("Node")
    assert core._watchers is not snapshot and snapshot == content
    core.unwatch(q1)
    assert snapshot == content
    core.unwatch(q2)
    assert core._watchers == []


def test_registration_never_loses_an_object():
    """Every object lands in the replay XOR as a later ADDED."""
    core = port_kube.KubeCore()
    total = 300
    started = threading.Event()

    def creator():
        started.set()
        for i in range(total):
            core.create(make_obj(port_core, "Pod", f"storm-{i}", "default"))

    t = threading.Thread(target=creator)
    t.start()
    started.wait()
    q = core.watch("Pod")
    t.join(timeout=30.0)
    assert not t.is_alive()
    seen = []
    while True:
        try:
            seen.append(q.get_nowait().obj.metadata.name)
        except queue.Empty:
            break
    assert len(seen) == len(set(seen)) == total
    core.unwatch(q)


def test_world_watch_replays_every_kind_and_isolates_events():
    core = port_kube.KubeCore()
    core.create(make_obj(port_core, "Pod", "p", "default", labels={"k": "v"}))
    core.create(make_obj(port_core, "Node", "n", "default"))
    q = core.watch(None)
    replay = [q.get_nowait() for _ in range(2)]
    assert {e.obj.kind for e in replay} == {"Pod", "Node"}
    core.create(port_core.DaemonSet(metadata=port_core.ObjectMeta(name="d")))
    ev = q.get(timeout=2.0)
    assert ev.type == "ADDED" and ev.obj.kind == "DaemonSet"
    pod_ev = next(e for e in replay if e.obj.kind == "Pod")
    pod_ev.obj.metadata.labels["k"] = "mutated"
    assert core.read("Pod", "p", "default", lambda p: p.metadata.labels["k"]) == "v"
    core.unwatch(q)
