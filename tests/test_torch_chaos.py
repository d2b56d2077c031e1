"""The port's fault injection against the JAX package's, on the CPU.

- **The plan.** For the same (seed, specs, window) the two packages' plans
  decide the same fault at every call of every stream, in any interleaving
  of the streams; they fire, count and leave pending the same triggers, and
  refuse the same overfull streams.
- **The boundaries.** The same plan through each package's shims gives the
  same outcome: ``ChaosKube`` (conflict, timeout, slow-apiserver, a dropped
  Pod MODIFIED event), the fake provider's ``create`` (ice,
  crash-before-bind leaking a ledger entry, spot-interruption reclaiming
  the oldest spot instance) and the pressure monitor's samples
  (memory-pressure, queue-flood). Exact throughout.
- **The flight recorder.** A fired fault trips ``chaos-fault`` with the
  JAX package's tags.
"""

import itertools
import random
from types import SimpleNamespace

import pytest

from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wk
from karpenter_tpu.api.constraints import Constraints as JaxConstraints
from karpenter_tpu.api.requirements import Requirements as JaxRequirements
from karpenter_tpu.chaos import inject as jax_inject
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.runtime import kubecore as jax_kube
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wk
from karpenter_tpu_torch.api.constraints import Constraints as PortConstraints
from karpenter_tpu_torch.api.requirements import Requirements as PortRequirements
from karpenter_tpu_torch.chaos import inject as port_inject
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.obs import flight as port_flight
from karpenter_tpu_torch.runtime import kubecore as port_kube

JAX = SimpleNamespace(name="jax", inject=jax_inject, core=jax_core, wk=jax_wk, fake=jax_fake,
                      kube=jax_kube, pressure=jax_pressure, Constraints=JaxConstraints,
                      Requirements=JaxRequirements)
PORT = SimpleNamespace(name="port", inject=port_inject, core=port_core, wk=port_wk,
                       fake=port_fake, kube=port_kube, pressure=port_pressure,
                       Constraints=PortConstraints, Requirements=PortRequirements)
STREAMS = [("kube", "create"), ("kube", "patch"), ("provider", "create"),
           ("journal", "bind:bound"), ("pressure", "rss")]


@pytest.fixture(autouse=True)
def _clean_plans():
    yield
    jax_inject.uninstall()
    port_inject.uninstall()


def plan_specs(seed):
    rng = random.Random(seed)
    kinds = ["conflict", "timeout", "ice", "crash-point", "memory-pressure", "drop"]
    return [(b, o, rng.choice(kinds), rng.randint(1, 3)) for b, o in STREAMS for _ in range(2)]


def make_plan(pkg, seed, specs, window):
    return pkg.inject.FaultPlan(seed, [pkg.inject.FaultSpec(*s) for s in specs], window=window)


@pytest.mark.parametrize("seed", [1, 7, 42, 20260805])
@pytest.mark.parametrize("window", [8, 32])
def test_plan_decides_as_the_jax_plan(seed, window):
    specs = plan_specs(seed)
    j, p = make_plan(JAX, seed, specs, window), make_plan(PORT, seed, specs, window)
    order = random.Random(seed + 1)
    for _ in range(6 * window):
        b, o = STREAMS[order.randrange(len(STREAMS))]
        assert p.decide(b, o) == j.decide(b, o)
    assert [tuple(vars(f).values()) for f in p.fired()] == \
        [tuple(vars(f).values()) for f in j.fired()]
    assert p.fired_counts() == j.fired_counts()
    assert p.pending() == j.pending()
    assert [p.calls(b, o) for b, o in STREAMS] == [j.calls(b, o) for b, o in STREAMS]


@pytest.mark.parametrize("seed", [3, 11])
def test_interleaving_does_not_change_a_stream(seed):
    """Per stream, the decisions are a function of (seed, specs) alone."""
    specs = plan_specs(seed)
    seqs = []
    for order_seed in (0, 1):
        plan = make_plan(PORT, seed, specs, 16)
        order = random.Random(order_seed)
        per = {s: [] for s in STREAMS}
        for _ in range(200):
            s = STREAMS[order.randrange(len(STREAMS))]
            per[s].append(plan.decide(*s))
        seqs.append({s: v[:16] for s, v in per.items()})
    assert seqs[0] == seqs[1]


def test_window_overflow_and_pending():
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            make_plan(pkg, 1, [("kube", "create", "conflict", 5)], 4)
    j = make_plan(JAX, 9, [("kube", "create", "conflict", 3), ("kube", "patch", "timeout", 2)], 8)
    p = make_plan(PORT, 9, [("kube", "create", "conflict", 3), ("kube", "patch", "timeout", 2)], 8)
    for _ in range(8):
        assert p.decide("kube", "create") == j.decide("kube", "create")
    assert p.pending() == j.pending() == 2


def test_global_hook_and_crash_point():
    assert port_inject.installed() is None and port_inject.active_fault("kube", "create") is None
    port_inject.crash_point("drain:open")  # no plan: nothing happens
    plan = make_plan(PORT, 1, [("journal", "drain:open", "crash-point", 1)], 1)
    port_inject.install(plan)
    assert port_inject.installed() is plan
    with pytest.raises(port_inject.SimulatedCrash) as e:
        port_inject.crash_point("drain:open")
    assert e.value.point == "drain:open" and not isinstance(e.value, Exception)
    port_inject.uninstall()
    assert port_inject.installed() is None


def test_fired_fault_trips_the_flight_recorder():
    port_flight.reset()
    plan = make_plan(PORT, 4, [("provider", "create", "ice", 1)], 1)
    plan.decide("provider", "create")
    trips = [r for r in port_flight.recent() if r["trigger"] == "chaos-fault"]
    assert len(trips) == 1
    assert trips[0]["tags"] == {"kind": "ice", "boundary": "provider", "op": "create",
                                "index": 0, "seed": 4}
    port_flight.reset()


# -- the kube shim -------------------------------------------------------------

def pod(pkg, name):
    c = pkg.core
    return c.Pod(metadata=c.ObjectMeta(name=name, namespace="default"),
                 spec=c.PodSpec(containers=[c.Container(
                     resources=c.ResourceRequirements.make(requests={"cpu": "1"}))]))


def kube_outcomes(pkg, seed):
    """Creates, patches, binds and deletes through ChaosKube under a plan
    of conflicts, timeouts and slow writes; each op's outcome and the
    store's pods afterwards."""
    pkg.inject.install(make_plan(pkg, seed, [
        ("kube", "create", "conflict", 2), ("kube", "create", "timeout", 1),
        ("kube", "patch", "timeout", 1), ("kube", "patch", "slow-apiserver", 1),
        ("kube", "bind_pods", "conflict", 1),
        ("kube", "delete", "conflict", 1)], 6))
    inner = pkg.kube.KubeCore()
    kube = pkg.inject.ChaosKube(inner)
    kube.SLOW_APISERVER_STALL_S = 0.0
    out = []

    def attempt(fn):
        try:
            fn()
            out.append("ok")
        except pkg.kube.Conflict:
            out.append("conflict")
        except pkg.kube.ApiError:
            out.append("api-error")

    for i in range(6):
        attempt(lambda i=i: kube.create(pod(pkg, f"p{i}")))
    names = sorted(p.metadata.name for p in inner.list("Pod"))

    def label(obj):
        obj.metadata.labels["x"] = "1"

    for n in names:
        attempt(lambda n=n: kube.patch("Pod", n, "default", label))
    attempt(lambda: kube.bind_pods([inner.get("Pod", names[0])], "node-a"))
    attempt(lambda: kube.bind_pods([inner.get("Pod", names[0])], "node-a"))
    for n in names[:2]:
        attempt(lambda n=n: kube.delete("Pod", n, "default"))
    pkg.inject.uninstall()
    state = sorted((p.metadata.name, p.spec.node_name, dict(p.metadata.labels))
                   for p in inner.list("Pod"))
    return out, state


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chaos_kube_equals_the_jax_shim(seed):
    assert kube_outcomes(PORT, seed) == kube_outcomes(JAX, seed)


def test_dropping_watch_drops_pod_modified_only():
    seen = {}
    for pkg in (JAX, PORT):
        inner = pkg.kube.KubeCore()
        kube = pkg.inject.ChaosKube(inner)
        q = kube.watch("Pod")
        pkg.inject.install(make_plan(pkg, 5, [("kube", "watch", "drop", 2)], 3))
        p = pod(pkg, "w")
        kube.create(p)
        for v in range(3):
            kube.patch("Pod", "w", "default", lambda o, v=v: o.metadata.labels.update(v=str(v)))
        kube.delete("Pod", "w", "default")
        events = []
        while True:
            try:
                ev = q.get(timeout=0.05)
            except Exception:
                break
            events.append((ev.type, ev.obj.metadata.labels.get("v")))
        pkg.inject.uninstall()
        kube.unwatch(q)
        seen[pkg.name] = events
    assert seen["port"] == seen["jax"]
    assert [t for t, _ in seen["port"]].count("MODIFIED") == 1
    assert seen["port"][0][0] == "ADDED" and seen["port"][-1][0] == "DELETED"


# -- the provider shim -----------------------------------------------------------

def constraints(pkg, capacity_types):
    wk, c = pkg.wk, pkg.core
    return pkg.Constraints(
        labels={wk.PROVISIONER_NAME_LABEL: "chaos"},
        requirements=pkg.Requirements([
            c.NodeSelectorRequirement(key=wk.LABEL_TOPOLOGY_ZONE, operator="In",
                                      values=["test-zone-1"]),
            c.NodeSelectorRequirement(key=wk.LABEL_CAPACITY_TYPE, operator="In",
                                      values=list(capacity_types))]))


def provider_outcomes(pkg, monkeypatch, seed):
    """Launches under ice, crash-before-bind and spot-interruption faults:
    per unit the error or the bound node, and the capacity ledger after."""
    monkeypatch.setattr(pkg.fake, "_name_counter", itertools.count())
    nonces = iter(f"nonce-{i}" for i in range(100))
    monkeypatch.setattr(pkg.fake.uuid, "uuid4", lambda: SimpleNamespace(hex=next(nonces)))
    prov = pkg.fake.FakeCloudProvider(catalog=pkg.fake.instance_types(3))
    prov.insufficient_capacity.add(("fake-it-1", "test-zone-1", "on-demand"))
    pkg.inject.install(make_plan(pkg, seed, [
        ("provider", "create", "ice", 2), ("provider", "create", "crash-before-bind", 2),
        ("provider", "create", "spot-interruption", 2)], 12))
    out = []
    for it_index, cts in ((0, ["spot"]), (0, ["on-demand"]), (1, ["on-demand"]), (2, ["spot"])):
        errs = prov.create(constraints(pkg, cts), [prov.catalog[it_index]], 3,
                           lambda node: None)
        out.append(errs)
    pkg.inject.uninstall()
    ledger = sorted((r.instance_id, r.provisioner_name, r.launch_nonce, r.zone,
                     r.instance_type, r.capacity_type) for r in prov.list_instances())
    return out, ledger, sorted(prov.deleted), [n.metadata.name for n in prov.created]


@pytest.mark.parametrize("seed", [1, 8])
def test_fake_provider_faults_equal_the_jax_provider(seed, monkeypatch):
    j = provider_outcomes(JAX, monkeypatch, seed)
    p = provider_outcomes(PORT, monkeypatch, seed)
    assert p == j
    errs = [e for errs in p[0] for e in errs if e]
    assert any("insufficient capacity" in e for e in errs)
    assert any("injected crash before bind" in e for e in errs)


def test_preassigned_nonce_wins_and_delete_clears_the_ledger():
    from karpenter_tpu_torch.runtime import journal as jr

    prov = port_fake.FakeCloudProvider(catalog=port_fake.instance_types(2))
    made = []
    with jr.preassigned_nonce("journaled"):
        prov.create(constraints(PORT, ["on-demand"]), [prov.catalog[0]], 2,
                    lambda node: made.append(node))
    assert {r.launch_nonce for r in prov.list_instances()} == {"journaled"}
    assert prov.delete(made[0]) is None
    assert prov.delete_instance(made[1].metadata.name) is None
    assert prov.delete_instance("never-launched") is None
    assert prov.list_instances() == []


# -- the pressure shim ------------------------------------------------------------

def monitor(pkg):
    config = pkg.pressure.PressureConfig(rss_watermark_bytes=1 << 30, max_depth=1000)
    if pkg.name == "jax":
        return jax_pressure.PressureMonitor(config, breaker_fn=lambda: False,
                                            rss_fn=lambda: 0)
    return port_pressure.PressureMonitor(config, rss_fn=lambda: 0)


@pytest.mark.parametrize("specs", [
    [("pressure", "rss", "memory-pressure", 1)],
    [("pressure", "depth", "queue-flood", 1)],
    [("pressure", "rss", "memory-pressure", 2), ("pressure", "depth", "queue-flood", 3)],
])
def test_pressure_faults_equal_the_jax_monitor(specs):
    levels = {}
    for pkg in (JAX, PORT):
        m = monitor(pkg)
        pkg.inject.install(make_plan(pkg, 6, specs, 4))
        levels[pkg.name] = [int(m.evaluate()) for _ in range(4)]
        pkg.inject.uninstall()
    assert levels["port"] == levels["jax"]
    assert max(levels["port"]) == 2
