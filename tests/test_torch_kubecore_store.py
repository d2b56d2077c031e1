"""The port's two store layouts against each other and against the JAX
package's single-lock store.

**Three-way differential** (seeds 1, 7 and 42): one seeded trace of a few
hundred operations — create (with and without a finalizer), get, read,
list (by namespace and label selector), scan, ``pods_on_node``, update
(some stale), patch (some dropping the finalizer), delete (with and
without a resourceVersion precondition), bind, bulk bind, eviction under
PodDisruptionBudgets (minAvailable, a percentage maxUnavailable, both
set) and watch registrations mid-trace — is applied in the same order to
the port's ``NaiveKubeCore``, the port's striped ``KubeCore`` and the JAX
package's ``NaiveKubeCore``, with both packages' clocks pinned. After
every operation the outcome (the canonical value or the exception's class
name), the whole store state and every watcher's events (full copies and
``meta_only`` stubs, for one kind and for every kind) must be equal.

**The legs of the JAX package's store suite, on the port**: concurrent
binders, evictors and creators on the striped store converge to the naive
store's serial result; concurrent evictions respect a PDB atomically;
every cross-stripe operation class at once never deadlocks; the watch
semantics (copy-on-write watcher list, no torn object, no lost object,
world replays with stubs, events as isolated copies) hold in both
layouts.
"""

import queue
import random
import threading

import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.runtime import kubecore as jax_kube
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.runtime import kubecore as port_kube
from karpenter_tpu_torch.utils import clock as port_clock

KINDS = ("Pod", "Node", "PodDisruptionBudget")
NAMESPACES = ("default", "team-a")
POD_NAMES = [f"pod-{i}" for i in range(16)]
NODE_NAMES = [f"node-{i}" for i in range(5)]
PDB_NAMES = [f"pdb-{i}" for i in range(3)]
WATCHES = [("Pod", False), ("Pod", True), (None, False), (None, True)]
PINNED = 1_000_000.0
LAYOUTS = ("port-naive", "port-striped", "jax-naive")


@pytest.fixture(autouse=True)
def pinned_clocks():
    jax_clock.DEFAULT.set(PINNED)
    port_clock.DEFAULT.set(PINNED)
    yield
    jax_clock.DEFAULT.reset()
    port_clock.DEFAULT.reset()


def new_store(layout):
    return {"port-naive": port_kube.NaiveKubeCore, "port-striped": port_kube.KubeCore,
            "jax-naive": jax_kube.NaiveKubeCore}[layout]()


def api_of(layout):
    return jax_core if layout.startswith("jax") else port_core


def kube_of(layout):
    return jax_kube if layout.startswith("jax") else port_kube


def make_pod(c, name, ns, labels=None, finalizers=None):
    return c.Pod(metadata=c.ObjectMeta(name=name, namespace=ns, labels=dict(labels or {}),
                                       finalizers=list(finalizers or [])),
                 spec=c.PodSpec())


def make_node(c, name):
    return c.Node(metadata=c.ObjectMeta(name=name, namespace="default"))


def make_pdb(c, name, ns, app, min_available=None, max_unavailable=None):
    return c.PodDisruptionBudget(
        metadata=c.ObjectMeta(name=name, namespace=ns),
        selector=c.LabelSelector(match_labels={"app": app}),
        min_available=min_available, max_unavailable=max_unavailable)


def canon(obj):
    """What a store operation can change, as plain tuples; lists sorted
    (list and scan order is a layout artifact, not API contract)."""
    if obj is None or isinstance(obj, (str, bool, int, tuple)):
        return obj
    if isinstance(obj, list):
        return sorted((canon(o) for o in obj), key=repr)
    m = obj.metadata
    spec = getattr(obj, "spec", None)
    return (obj.kind, m.namespace, m.name, m.resource_version, m.uid, m.creation_timestamp,
            m.deletion_timestamp, tuple(m.finalizers), tuple(sorted(m.labels.items())),
            getattr(spec, "node_name", None))


def canon_event(ev, meta_only):
    if meta_only:
        assert type(ev.obj).__name__ == "MetaObj", ev.obj
        return (ev.type, ev.obj.kind, ev.obj.metadata.namespace, ev.obj.metadata.name)
    return (ev.type, canon(ev.obj))


def dump(store):
    state = {kind: canon(store.list(kind)) for kind in KINDS}
    state["by_node"] = {n: canon(store.pods_on_node(n)) for n in NODE_NAMES}
    return state


def trace(rng, n_ops):
    """A seeded trace of op descriptors, with no store or package in it."""
    ops = []
    for i in range(n_ops):
        kind = rng.choice(
            ["create_pod", "create_pod", "create_node", "create_pdb", "get", "read", "list",
             "scan", "pods_on_node", "update", "patch", "delete", "delete_precond", "bind",
             "bulk_bind", "evict", "evict", "watch"])
        ns = rng.choice(NAMESPACES)
        pod = rng.choice(POD_NAMES)
        if kind == "create_pod":
            ops.append((kind, pod, ns, f"app-{rng.randrange(3)}", rng.random() < 0.2))
        elif kind == "create_node":
            ops.append((kind, rng.choice(NODE_NAMES)))
        elif kind == "create_pdb":
            ops.append((kind, rng.choice(PDB_NAMES), ns, f"app-{rng.randrange(3)}",
                        rng.randrange(4)))
        elif kind in ("get", "read", "evict", "delete"):
            ops.append((kind, pod, ns))
        elif kind == "list":
            ops.append((kind, rng.choice(KINDS), rng.choice([None, ns]), rng.random() < 0.3,
                        rng.randrange(3)))
        elif kind in ("scan", "watch"):
            ops.append((kind, rng.choice(KINDS + (None,)) if kind == "watch"
                        else rng.choice(KINDS), rng.random() < 0.5))
        elif kind == "pods_on_node":
            ops.append((kind, rng.choice(NODE_NAMES)))
        elif kind in ("update", "patch"):
            ops.append((kind, pod, ns, i, rng.random() < 0.25))
        elif kind == "delete_precond":
            ops.append((kind, pod, ns, rng.random() < 0.5))
        elif kind == "bind":
            ops.append((kind, pod, ns, rng.choice(NODE_NAMES)))
        else:
            ops.append((kind, tuple(rng.sample(POD_NAMES, 3)), ns, rng.choice(NODE_NAMES)))
    return ops


def apply(layout, store, op):
    """One descriptor on one store: ("ok", canonical value) or ("err", the
    ApiError subclass's name)."""
    c, kind = api_of(layout), op[0]
    try:
        if kind == "create_pod":
            _, name, ns, app, fin = op
            return ("ok", canon(store.create(make_pod(
                c, name, ns, {"app": app}, ["test/finalizer"] if fin else []))))
        if kind == "create_node":
            return ("ok", canon(store.create(make_node(c, op[1]))))
        if kind == "create_pdb":
            _, name, ns, app, style = op
            kwargs = [{}, {"min_available": 1}, {"max_unavailable": "50%"},
                      {"min_available": 1, "max_unavailable": 1}][style]
            return ("ok", canon(store.create(make_pdb(c, name, ns, app, **kwargs))))
        if kind == "get":
            return ("ok", canon(store.get("Pod", op[1], op[2])))
        if kind == "read":
            return ("ok", store.read("Pod", op[1], op[2],
                                     lambda p: (p.metadata.name, p.spec.node_name or "")))
        if kind == "list":
            _, k, ns, use_sel, app_i = op
            sel = c.LabelSelector(match_labels={"app": f"app-{app_i}"}) if use_sel else None
            return ("ok", canon(store.list(k, namespace=ns, label_selector=sel)))
        if kind == "scan":
            return ("ok", sorted(store.scan(op[1], lambda o: (o.metadata.namespace,
                                                              o.metadata.name))))
        if kind == "pods_on_node":
            return ("ok", canon(store.pods_on_node(op[1])))
        if kind == "update":
            _, name, ns, i, stale = op
            obj = store.get("Pod", name, ns)
            obj.metadata.labels["updated"] = str(i)
            if stale:
                obj.metadata.resource_version -= 1
            return ("ok", canon(store.update(obj)))
        if kind == "patch":
            _, name, ns, i, drop = op

            def fn(o):
                o.metadata.labels["patched"] = str(i)
                if drop:
                    o.metadata.finalizers = []
            return ("ok", canon(store.patch("Pod", name, ns, fn)))
        if kind == "delete":
            return ("ok", canon(store.delete("Pod", op[1], op[2])))
        if kind == "delete_precond":
            _, name, ns, mismatch = op
            rv = "999999" if mismatch else str(store.read(
                "Pod", name, ns, lambda p: p.metadata.resource_version))
            return ("ok", canon(store.delete("Pod", name, ns, precondition_rv=rv)))
        if kind == "bind":
            _, name, ns, node = op
            return ("ok", store.bind_pod(make_pod(c, name, ns), node))
        if kind == "bulk_bind":
            _, names, ns, node = op
            return ("ok", store.bind_pods([make_pod(c, n, ns) for n in names], node))
        if kind == "evict":
            return ("ok", store.evict_pod(op[1], op[2]))
        raise AssertionError(f"unknown op {kind}")
    except kube_of(layout).ApiError as e:
        return ("err", type(e).__name__)


def drain(q, meta_only):
    out = []
    while True:
        try:
            out.append(canon_event(q.get_nowait(), meta_only))
        except queue.Empty:
            return out


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_three_layouts_agree_on_a_seeded_trace(seed):
    """The port's naive and striped stores and the JAX package's naive
    store: the same outcome, state and events after every operation
    (resourceVersions, uids and timestamps included)."""
    rng = random.Random(seed)
    stores = {layout: new_store(layout) for layout in LAYOUTS}
    watchers = {layout: [(store.watch(kind, meta_only=m), m) for kind, m in WATCHES]
                for layout, store in stores.items()}
    outcomes = {"ok": 0, "err": 0}
    for step, op in enumerate(trace(rng, 400)):
        if op[0] == "watch":
            # a registration mid-trace replays what exists as ADDED; the
            # replay's order across kinds is a layout artifact
            _, kind, m = op
            replays = {}
            for layout, store in stores.items():
                q = store.watch(kind, meta_only=m)
                replays[layout] = sorted(drain(q, m), key=repr)
                store.unwatch(q)
            assert replays["port-naive"] == replays["port-striped"] == replays["jax-naive"], \
                f"seed={seed} step={step}: {op}"
            continue
        got = {layout: apply(layout, store, op) for layout, store in stores.items()}
        assert got["port-naive"] == got["port-striped"] == got["jax-naive"], \
            f"seed={seed} step={step}: {op}: {got}"
        outcomes[got["port-naive"][0]] += 1
        states = {layout: dump(store) for layout, store in stores.items()}
        assert states["port-naive"] == states["port-striped"] == states["jax-naive"], \
            f"seed={seed} step={step}: state diverged after {op}"
        events = {layout: [drain(q, m) for q, m in ws] for layout, ws in watchers.items()}
        assert events["port-naive"] == events["port-striped"] == events["jax-naive"], \
            f"seed={seed} step={step}: events diverged after {op}"
    assert outcomes["ok"] and outcomes["err"], outcomes
    assert len(stores["port-striped"]._stripes) > 1
    assert list(stores["port-naive"]._stripes) == [""]
    for layout, store in stores.items():
        for q, _ in watchers[layout]:
            store.unwatch(q)


def test_naive_layout_filters_by_kind():
    """One stripe holds every kind; scan, list and the eviction's two
    kinds all resolve to it."""
    c = port_core
    store = port_kube.NaiveKubeCore()
    for i in range(5):
        store.create(make_node(c, f"n-{i}"))
    for i in range(20):
        store.create(make_pod(c, f"p-{i}", "default", {"app": "a"}))
    store.create(make_pdb(c, "b", "default", "a", min_available=0))
    assert list(store._stripes) == [""]
    assert sorted(store.scan("Node", lambda n: n.metadata.name)) == [f"n-{i}" for i in range(5)]
    assert len(store.list("Pod")) == 20 and len(store.list("PodDisruptionBudget")) == 1
    store.bind_pods([make_pod(c, "p-0", "default")], "n-0")
    assert [p.metadata.name for p in store.pods_on_node("n-0")] == ["p-0"]
    assert store.scan_pods_on_node("n-0", lambda p: p.metadata.name) == ["p-0"]
    store.evict_pod("p-0", "default")
    assert store.pods_on_node("n-0") == [] and len(store.list("Pod")) == 19


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_concurrent_bind_evict_converges_to_the_naive_serial_result(seed):
    """Racing binders, evictors and creators on the striped store reach the
    state the naive store reaches serially: the op sets are disjoint, so
    only the order of resourceVersions and uids may differ."""
    c = port_core
    rng = random.Random(seed)
    striped, naive = port_kube.KubeCore(), port_kube.NaiveKubeCore()
    base = [f"race-{i}" for i in range(60)]
    for name in base:
        for store in (striped, naive):
            store.create(make_pod(c, name, "default", {"app": "race"}))
    bind_a, bind_b, evict = base[:20], base[20:40], base[40:60]
    extra = [f"late-{i}" for i in range(20)]
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — surfaced by the assert below
            errors.append(e)

    def ops(store):
        return [
            lambda: [store.bind_pods([make_pod(c, n, "default") for n in bind_a[i:i + 4]],
                                     "node-a") for i in range(0, 20, 4)],
            lambda: [store.bind_pod(make_pod(c, n, "default"), "node-b") for n in bind_b],
            lambda: [store.evict_pod(n, "default") for n in evict],
            lambda: [store.create(make_node(c, n)) for n in extra],
        ]

    threads = [threading.Thread(target=run, args=(fn,)) for fn in ops(striped)]
    rng.shuffle(threads)
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive(), f"seed={seed}: a thread deadlocked"
    assert not errors, f"seed={seed}: {errors}"
    for fn in ops(naive):
        fn()

    def state(store):
        return {kind: sorted((o.kind, o.metadata.namespace, o.metadata.name, o.spec.node_name
                              if kind == "Pod" else None) for o in store.list(kind))
                for kind in KINDS}

    assert state(striped) == state(naive), f"seed={seed}"
    for node, names in (("node-a", bind_a), ("node-b", bind_b)):
        assert sorted(p.metadata.name for p in striped.pods_on_node(node)) == sorted(names)


@pytest.mark.parametrize("layout", ["port-striped", "port-naive"])
@pytest.mark.parametrize("seed", [1, 7, 42])
def test_concurrent_evictions_respect_a_pdb_atomically(layout, seed):
    """10 healthy pods under minAvailable=8: of 6 concurrent evictions
    exactly 2 pass, in either layout."""
    c = port_core
    store = new_store(layout)
    store.create(make_pdb(c, "guard", "default", "guarded", min_available=8))
    names = [f"guarded-{i}" for i in range(10)]
    for n in names:
        store.create(make_pod(c, n, "default", {"app": "guarded"}))
        store.bind_pod(make_pod(c, n, "default"), "node-x")
    outcomes, lock = [], threading.Lock()

    def evict(name):
        try:
            store.evict_pod(name, "default")
            ok = True
        except port_kube.ApiError:
            ok = False
        with lock:
            outcomes.append(ok)

    threads = [threading.Thread(target=evict, args=(n,))
               for n in random.Random(seed).sample(names, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive(), "an eviction deadlocked"
    assert sum(outcomes) == 2, f"seed={seed}: {sum(outcomes)} evictions passed"
    assert sum(store.scan("Pod", lambda p: bool(p.spec.node_name))) == 8


@pytest.mark.parametrize("layout", ["port-striped", "port-naive"])
def test_cross_stripe_operations_never_deadlock(layout):
    """Evictions (two kinds), world watches (the guard and every stripe),
    creates of new kinds (the guard), scans and lists at once: every thread
    finishes."""
    c = port_core
    store = new_store(layout)
    store.create(make_pdb(c, "pdb", "default", "app", min_available=0))
    for i in range(30):
        store.create(make_pod(c, f"p-{i}", "default", {"app": "app"}))
    stop, errors, i = threading.Event(), [], [0]

    def loop(fn):
        try:
            while not stop.is_set():
                fn()
        except Exception as e:  # noqa: BLE001 — surfaced by the assert below
            errors.append(e)

    def new_kind():
        i[0] += 1
        store.create(make_node(c, f"n-{i[0]}"))

    def world_watch():
        store.unwatch(store.watch(None))

    def evict():
        try:
            store.evict_pod(f"p-{i[0] % 30}", "default")
        except port_kube.ApiError:
            pass

    threads = [threading.Thread(target=loop, args=(fn,)) for fn in (
        new_kind, world_watch, evict, lambda: store.scan("Pod", lambda p: p.metadata.name),
        lambda: store.list("PodDisruptionBudget"))]
    for t in threads:
        t.start()
    timer = threading.Timer(1.0, stop.set)
    timer.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive(), "a cross-stripe operation deadlocked"
    timer.cancel()
    assert not errors, errors


@pytest.mark.parametrize("layout", ["port-striped", "port-naive"])
def test_mid_write_watcher_sees_pre_or_post_never_torn(layout):
    c = port_core
    store = new_store(layout)
    store.create(make_pod(c, "flip", "default", {"v": "a", "check": "a"}))
    stop = threading.Event()

    def writer():
        v = "b"
        while not stop.is_set():
            def fn(o, v=v):
                o.metadata.labels["v"] = v
                o.metadata.labels["check"] = v
            store.patch("Pod", "flip", "default", fn)
            v = "a" if v == "b" else "b"

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(100):
            q = store.watch("Pod")
            for _ in range(5):
                try:
                    labels = q.get_nowait().obj.metadata.labels
                except queue.Empty:
                    break
                assert labels["v"] == labels["check"], f"torn object: {labels}"
            store.unwatch(q)
    finally:
        stop.set()
        t.join(timeout=10.0)
    assert not t.is_alive()


@pytest.mark.parametrize("layout", ["port-striped", "port-naive"])
def test_registration_never_loses_an_object(layout):
    c = port_core
    store, total = new_store(layout), 300
    started = threading.Event()

    def creator():
        started.set()
        for i in range(total):
            store.create(make_pod(c, f"storm-{i}", "default"))

    t = threading.Thread(target=creator)
    t.start()
    started.wait()
    q = store.watch("Pod", meta_only=True)
    t.join(timeout=30.0)
    assert not t.is_alive()
    seen = [name for _, _, _, name in drain(q, True)]
    assert len(seen) == len(set(seen)), "duplicate watch delivery"
    assert set(seen) == {f"storm-{i}" for i in range(total)}
    store.unwatch(q)


@pytest.mark.parametrize("layout", ["port-striped", "port-naive"])
def test_world_watch_stubs_and_isolated_copies(layout):
    c = port_core
    store = new_store(layout)
    store.create(make_pod(c, "p", "default", {"k": "v"}))
    store.create(make_node(c, "n"))
    stubs = store.watch(None, meta_only=True)
    replay = [stubs.get_nowait() for _ in range(2)]
    assert {e.obj.kind for e in replay} == {"Pod", "Node"}
    assert all(isinstance(e.obj, port_kube.MetaObj) for e in replay)
    store.create(make_pdb(c, "pdb", "default", "x"))
    ev = stubs.get(timeout=2.0)
    assert ev.type == "ADDED" and ev.obj.kind == "PodDisruptionBudget"
    copies = store.watch("Pod")
    ev = copies.get(timeout=2.0)
    ev.obj.metadata.labels["k"] = "mutated"
    assert store.read("Pod", "p", "default", lambda p: p.metadata.labels["k"]) == "v"
    store.unwatch(stubs)
    store.unwatch(copies)
