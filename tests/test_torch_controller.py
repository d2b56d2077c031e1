"""The port's provisioning controller against the JAX package's, and alone.

**Differential.** The same windows go through the JAX package's
``ProvisionerWorker`` and the port's ``ProvisionerWorker(device="cpu")``,
driven as tests/test_pipeline.py drives them: ``worker.add`` for every pod,
then one ``worker.provision()`` on the test's thread, never
``worker.start()``. Pods and catalogs are built separately in each package
from the same seeded numbers (``random.Random``), with the same names and
fields. Every ``_bind`` call is recorded as (the node's instance type, the
sorted pod names), and the two packages' records must be equal, in order:
no tolerance, binds are compared exactly. The JAX package solves its
batched windows on its device path (``device_min_pods=1``) and its global
relaxation with the jitted XLA program (``device_min_cells=0``), as
tests/test_torch_global_solve.py holds it; the port runs the plain PyTorch
versions on the CPU. The windows:

- (a) config_12-like: pods in 8 required-node-affinity groups (capacity
  type, zones, instance-type names) over a 24-type catalog, backend
  ``"ffd"``, pipeline depth 1 and 2, ``chunk_items`` cutting the window
  into 4 chunks, seeds 1, 7 and 42;
- (b) config_14-like: 12 priced groups on backend ``"global"``, with at
  least one schedule accepted in both packages;
- (c) the kill switch ``KARPENTER_GLOBAL_SOLVE=0``, which gives (b)'s
  ``"ffd"`` binds in both packages;
- (d) an error injected into the port's global leg (the program at
  dispatch, the rounding at fetch): the port binds the FFD plans, counts
  ``global_errors == 1`` and no ``"device-global"`` executor;
- (e) the pressure monitor held at level 1: the window split into chunks,
  the FFD backend although ``"global"`` is configured, binds equal to the
  JAX package's under the same level;
- (f) a pod-(anti-)affinity window: replicas with required hostname
  anti-affinity, cohorts with required zone affinity to a pinned anchor,
  cohorts with a preferred zone affinity (steered at launch), an
  unsatisfiable pod and a lonely term, at depth 1 and 2, under the
  default and the interruption-priced policy. Binds carry the node's zone
  and capacity type here; hostname domains are random in both packages,
  so the binds compare as partitions of pod names (never as hostnames).

**Alone**, through the port's ``ProvisioningController`` and
``SelectionController`` as tests/test_provisioning.py drives the JAX
package's, with worker threads: nodes provisioned, pods grouped, daemon
sets, zone selectors, taints, deleted pods, limits, first match, status
conditions, bind errors, both deployment shapes, and the pods the port's
scheduler sheds (an unsatisfiable affinity term), beside a complete gang
that binds through the co-pack window. Every test stops every
worker it made; the process-wide state both packages keep (the support
controllers, the JAX watchdog, the pressure monitors, the executor counts)
is reset before and after each test.
"""

import functools
import random
import time
import uuid

import numpy as np
import pytest

from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wellknown
from karpenter_tpu.api.provisioner import Provisioner as JaxProvisioner
from karpenter_tpu.api.provisioner import ProvisionerSpec as JaxProvisionerSpec
from karpenter_tpu.cloudprovider import spi as jax_spi
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.controllers import provisioning as jax_prov
from karpenter_tpu.ops import global_solve as jax_gops
from karpenter_tpu.runtime import kubecore as jax_kube
from karpenter_tpu.scheduling import batcher as jax_batcher
from karpenter_tpu.solver import global_solve as jax_gs
from karpenter_tpu.solver import pipeline as jax_pipeline
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch.api.constraints import Constraints, Limits, Taints
from karpenter_tpu_torch.api.provisioner import Provisioner as PortProvisioner
from karpenter_tpu_torch.api.provisioner import ProvisionerSpec as PortProvisionerSpec
from karpenter_tpu_torch.api.provisioner import get_condition
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.cloudprovider import spi as port_spi
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.controllers import provisioning as port_prov
from karpenter_tpu_torch.controllers.selection import SelectionController
from karpenter_tpu_torch.ops import global_solve as port_gops
from karpenter_tpu_torch.runtime import kubecore as port_kube
from karpenter_tpu_torch.scheduling import batcher as port_batcher
from karpenter_tpu_torch.solver import global_solve as port_gs
from karpenter_tpu_torch.solver import pipeline as port_pipeline
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.utils.resources import parse_resource_list

SEEDS = (1, 7, 42)
ZONES = ("z1", "z2", "z3")
CAPACITY_TYPES = ("on-demand", "spot")
SHAPES = [("250m", "256Mi"), ("500m", "512Mi"), ("1", "1Gi"), ("1500m", "2Gi"),
          ("2", "4Gi"), ("750m", "1536Mi")]
# config_14's six priced types and four shapes (bench.py:1554-1616)
PRICED_TYPES = [("gw-small-8", 8, 0.40), ("gw-small-12", 12, 0.66), ("gw-mid-16", 16, 1.92),
                ("gw-mid-24", 24, 3.36), ("gw-big-32", 32, 6.40), ("gw-big-48", 48, 10.56)]
PRICED_SHAPES = [("1", "2Gi"), ("2", "4Gi"), ("500m", "1Gi"), ("4", "8Gi")]


class Pkg:
    """One package's API, so each window is built the same way in both."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.core = jax_core if jax else port_core
        self.wellknown = jax_wellknown if jax else port_wellknown
        self.spi = jax_spi if jax else port_spi
        self.fake = jax_fake if jax else port_fake
        self.prov = jax_prov if jax else port_prov
        self.kube = jax_kube if jax else port_kube
        self.batcher = jax_batcher if jax else port_batcher
        self.pipeline = jax_pipeline if jax else port_pipeline
        self.solve = jax_solve_mod if jax else port_solve_mod
        self.gs = jax_gs if jax else port_gs
        self.pressure = jax_pressure if jax else port_pressure
        self.Provisioner = JaxProvisioner if jax else PortProvisioner
        self.ProvisionerSpec = JaxProvisionerSpec if jax else PortProvisionerSpec

    def universe(self, catalog):
        if self.name == "jax":
            return jax_prov.universe_constraints(catalog)
        return port_solve_mod.universe_constraints(catalog)


JAX, PORT = Pkg("jax"), Pkg("port")


@pytest.fixture(autouse=True)
def fresh_process_state(monkeypatch):
    """Both packages' support controllers at the strict corner, a fresh JAX
    watchdog, no process-wide pressure monitor and no executor counts; the
    same again after the test."""
    def reset():
        jax_gops.SUPPORT.reset()
        port_gops.SUPPORT.reset()
        jax_pressure.set_monitor(None)
        port_pressure.set_monitor(None)
        port_solve_mod.reset_executor_counts()

    reset()
    monkeypatch.setattr(jax_solve_mod, "_WATCHDOG", jax_solve_mod._DeviceWatchdog())
    monkeypatch.delenv("KARPENTER_GLOBAL_SOLVE", raising=False)
    yield
    reset()


class HeldMonitor:
    """A pressure monitor held at one level, for either package's batcher:
    level() never moves, whatever the signals say."""

    def __init__(self, pkg: Pkg, level: int, **config):
        self.config = pkg.pressure.PressureConfig(**config)
        self._level = level

    def level(self):
        return self._level

    evaluate = level

    def note_depth(self, source, depth):
        pass

    def forget_source(self, source):
        pass

    def note_window(self, seconds):
        pass


def quiet_monitor(pkg: Pkg):
    """A real monitor whose signals cannot rise in a test: no RSS watermark
    (the test process holds both packages) and, for the JAX package, no
    breaker."""
    config = pkg.pressure.PressureConfig(rss_watermark_bytes=0)
    if pkg.name == "jax":
        return jax_pressure.PressureMonitor(config, breaker_fn=lambda: False)
    return port_pressure.PressureMonitor(config)


# -- windows -------------------------------------------------------------------

def affinity_pod(pkg: Pkg, name, cpu, mem, exprs):
    """A pending, unschedulable pod whose required node affinity is
    ``exprs``: (key, values) pairs, all In."""
    c = pkg.core
    na = c.NodeAffinity(required=[c.NodeSelectorTerm(match_expressions=[
        c.NodeSelectorRequirement(key=k, operator="In", values=list(v)) for k, v in exprs])]) \
        if exprs else None
    return c.Pod(
        metadata=c.ObjectMeta(name=name, namespace="default", uid=f"uid-{name}"),
        spec=c.PodSpec(containers=[c.Container(resources=c.ResourceRequirements.make(
            requests={"cpu": cpu, "memory": mem}))],
            affinity=c.Affinity(node_affinity=na) if na else None),
        status=c.PodStatus(phase="Pending", conditions=[c.PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable")]))


def config12_catalog(pkg: Pkg):
    """24 types, cpu 1-12 at memory ratios 2 and 4, offered on demand and
    spot in three zones, priced per cpu."""
    offerings = [pkg.spi.Offering(ct, z) for z in ZONES for ct in CAPACITY_TYPES]
    return [pkg.fake.make_instance_type(
        name=f"t{i:02d}-{cpu}x{ratio}", cpu=str(cpu), memory=f"{cpu * ratio}Gi",
        pods=str(min(110, cpu * 15)), offerings=offerings, price=0.05 * cpu * (1 + 0.1 * ratio))
        for i, (cpu, ratio) in enumerate((c, r) for r in (2, 4) for c in range(1, 13))]


def config12_groups(catalog_names):
    """8 (capacity types, zones, type names) keys, as config_12's variants:
    capacity type rotated, one zone dropped, a rotating prefix of names
    dropped."""
    names = sorted(catalog_names)
    return [(CAPACITY_TYPES if v % 4 else CAPACITY_TYPES[:1],
             tuple(z for j, z in enumerate(ZONES) if j != v % len(ZONES)),
             tuple(names[(v * 3) % 8:])) for v in range(8)]


def config12_window(pkg: Pkg, seed, n=200):
    """``n`` pods over config12_groups, interleaved and shaped by ``seed``."""
    catalog = config12_catalog(pkg)
    groups = config12_groups([it.name for it in catalog])
    rng = random.Random(seed)
    wk = pkg.wellknown
    pods = []
    for i in range(n):
        cts, zones, names = groups[rng.randrange(len(groups))]
        cpu, mem = rng.choice(SHAPES)
        pods.append(affinity_pod(pkg, f"pod-s{seed}-{i:03d}", cpu, mem, [
            (wk.LABEL_CAPACITY_TYPE, cts), (wk.LABEL_TOPOLOGY_ZONE, zones),
            (wk.LABEL_INSTANCE_TYPE, names)]))
    return catalog, pods


def priced_catalog(pkg: Pkg):
    return [pkg.fake.make_instance_type(
        name=name, cpu=str(cpu), memory=f"{cpu * 4}Gi", pods=str(min(110, cpu * 15)),
        offerings=[pkg.spi.Offering("on-demand", z) for z in ZONES], price=price)
        for name, cpu, price in PRICED_TYPES]


def priced_groups():
    """12 distinct required node-affinity keys that keep the cheap types:
    one zone each, and all six types or all but one of the three dearest."""
    names = [n for n, _, _ in PRICED_TYPES]
    type_lists = [names] + [[n for n in names if n != drop] for drop in names[3:]]
    return [((ZONES[b % 3],), tuple(type_lists[b // 3])) for b in range(12)]


def priced_window(pkg: Pkg):
    """config_14's window through node affinity: group b holds 10 + 7b mod
    26 pods of shape b mod 4 (270 pods)."""
    wk = pkg.wellknown
    pods = []
    for b, (zones, names) in enumerate(priced_groups()):
        cpu, mem = PRICED_SHAPES[b % len(PRICED_SHAPES)]
        pods += [affinity_pod(pkg, f"gw{b}-{j:02d}", cpu, mem, [
            (wk.LABEL_TOPOLOGY_ZONE, zones), (wk.LABEL_INSTANCE_TYPE, names)])
            for j in range(10 + (b * 7) % 26)]
    return priced_catalog(pkg), pods


# -- one worker pass -------------------------------------------------------------

def run_worker(pkg: Pkg, window, backend="ffd", depth=1, chunk_items=0, monitor=None,
               policy="cheapest", zones=False):
    """One worker pass over ``window`` = (catalog, pods) under packing
    ``policy``; returns the binds (instance type, sorted pod names; with
    ``zones`` also the node's zone and capacity type) in call order, and
    the worker."""
    catalog, pods = window
    kube = pkg.kube.KubeCore()
    provider = pkg.fake.FakeCloudProvider(catalog=catalog)
    provisioner = pkg.Provisioner(
        metadata=pkg.core.ObjectMeta(name="default", namespace="default"),
        spec=pkg.ProvisionerSpec(constraints=pkg.universe(catalog)))
    kube.create(provisioner)
    batcher = pkg.batcher.Batcher(idle_seconds=0.01, max_seconds=5.0,
                                  monitor=monitor or quiet_monitor(pkg))
    pipeline_config = pkg.pipeline.PipelineConfig(depth=depth, chunk_items=chunk_items,
                                                  adaptive=False)
    if pkg.name == "jax":
        worker = jax_prov.ProvisionerWorker(
            provisioner, kube, provider, batcher=batcher, pipeline_config=pipeline_config,
            solver_config=jax_solve_mod.SolverConfig(window_backend=backend, device_min_pods=1,
                                                     packing_policy=policy))
    else:
        worker = port_prov.ProvisionerWorker(
            provisioner, kube, provider, batcher=batcher, pipeline_config=pipeline_config,
            solver_config=port_solve_mod.SolverConfig(window_backend=backend, device_min_pods=0,
                                                      packing_policy=policy), device="cpu")
    binds = []
    orig_bind = worker._bind
    label = pkg.wellknown.LABEL_INSTANCE_TYPE

    wk = pkg.wellknown

    def recording_bind(node, node_pods):
        record = (node.metadata.labels[label], tuple(sorted(p.metadata.name for p in node_pods)))
        if zones:
            record += (node.metadata.labels[wk.LABEL_TOPOLOGY_ZONE],
                       node.metadata.labels[wk.LABEL_CAPACITY_TYPE])
        binds.append(record)
        return orig_bind(node, node_pods)

    worker._bind = recording_bind
    try:
        for pod in pods:
            kube.create(pod)
            assert worker.add(pod, key=(pod.metadata.namespace, pod.metadata.name)) is not None
        worker.provision()
    finally:
        worker.stop()
    bound = [n for bind in binds for n in bind[1]]
    assert len(bound) == len(set(bound)), "a pod was bound twice"
    return binds, worker


@pytest.fixture()
def global_handles(monkeypatch):
    """Each package's global-leg handles, recorded as the controllers
    dispatch them; the JAX controller's leg on its jitted XLA program at any
    window size (its default sends windows under 4,096 cells to the numpy
    mirror, which sums in another order)."""
    handles = {"jax": [], "port": []}

    def recording(pkg, dispatch):
        def wrapped(*args, **kwargs):
            handle = dispatch(*args, **kwargs)
            handles[pkg].append(handle)
            return handle
        return wrapped

    monkeypatch.setattr(jax_gs, "dispatch_global_window", recording("jax", functools.partial(
        jax_gs.dispatch_global_window, config=jax_gs.GlobalConfig(device_min_cells=0))))
    monkeypatch.setattr(port_gs, "dispatch_global_window",
                        recording("port", port_gs.dispatch_global_window))
    return handles


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("seed", SEEDS)
def test_config12_window_binds_as_the_jax_controller(seed, depth):
    want, _ = run_worker(JAX, config12_window(JAX, seed), depth=depth, chunk_items=50)
    port_solve_mod.reset_executor_counts()
    got, worker = run_worker(PORT, config12_window(PORT, seed), depth=depth, chunk_items=50)
    assert got == want
    assert sum(len(g) for _, g in got) == 200
    chunks = worker.last_window["chunks"]
    assert [c["pods"] for c in chunks] == [50, 50, 50, 50]
    assert worker.last_window["pipeline"]["depth"] == depth
    assert all(not c["global"] for c in chunks)
    counts = port_solve_mod.solver_health()["executor_counts"]
    assert set(counts) <= {"device-batch", "device"}
    assert sum(counts.values()) == sum(c["problems"] for c in chunks)


def test_depth2_binds_as_depth1():
    serial, _ = run_worker(PORT, config12_window(PORT, 7), depth=1, chunk_items=50)
    piped, _ = run_worker(PORT, config12_window(PORT, 7), depth=2, chunk_items=50)
    assert piped == serial


def test_priced_window_on_global_binds_as_the_jax_controller(global_handles):
    want, _ = run_worker(JAX, priced_window(JAX), backend="global")
    got, worker = run_worker(PORT, priced_window(PORT), backend="global")
    assert got == want
    assert port_gops.SUPPORT.rate == jax_gops.SUPPORT.rate
    (jax_plan,), (port_plan,) = ([h.fetch() for h in global_handles[k]] for k in ("jax", "port"))
    assert jax_plan.executor == port_plan.executor == "device-global"
    assert [i.reason for i in port_plan.infos] == [i.reason for i in jax_plan.infos]
    assert port_plan.accepted == jax_plan.accepted >= 1
    assert worker.global_errors == 0
    counts = port_solve_mod.solver_health()["executor_counts"]
    assert counts.get("device-global") == 12
    # at least one schedule took the relaxation's cheaper plan: its binds
    # differ from the FFD backend's
    port_gops.SUPPORT.reset()
    ffd, _ = run_worker(PORT, priced_window(PORT), backend="ffd")
    assert got != ffd
    assert sorted(n for _, g in got for n in g) == sorted(n for _, g in ffd for n in g)


def test_kill_switch_gives_ffd_binds(monkeypatch, global_handles):
    monkeypatch.setenv("KARPENTER_GLOBAL_SOLVE", "0")
    want, _ = run_worker(JAX, priced_window(JAX), backend="global")
    got, worker = run_worker(PORT, priced_window(PORT), backend="global")
    assert got == want
    assert "device-global" not in port_solve_mod.solver_health()["executor_counts"]
    assert all(not c["global"] for c in worker.last_window["chunks"])
    assert global_handles == {"jax": [], "port": []}
    monkeypatch.delenv("KARPENTER_GLOBAL_SOLVE")
    ffd, _ = run_worker(PORT, priced_window(PORT), backend="ffd")
    assert got == ffd


@pytest.mark.parametrize("target", ["run_program", "_round_window"])
def test_global_leg_error_binds_the_ffd_plans(monkeypatch, target):
    """run_program fails inside dispatch_global_window, _round_window
    inside GlobalHandle.fetch(): either way the chunk binds dispatch_batch's
    plans and the worker counts the error."""
    ffd, _ = run_worker(PORT, priced_window(PORT), backend="ffd")
    port_solve_mod.reset_executor_counts()

    def broken(*args, **kwargs):
        raise RuntimeError("injected global-leg failure")

    monkeypatch.setattr(port_gs, target, broken)
    got, worker = run_worker(PORT, priced_window(PORT), backend="global")
    assert got == ffd
    assert worker.global_errors == 1
    counts = port_solve_mod.solver_health()["executor_counts"]
    assert "device-global" not in counts and counts


def test_batch_error_is_not_caught(monkeypatch):
    """An error of dispatch_batch propagates out of the pass: no host
    oracle answers the window, nothing is bound."""
    def broken(*args, **kwargs):
        raise RuntimeError("injected batch failure")

    monkeypatch.setattr(port_prov, "dispatch_batch", broken)
    with pytest.raises(RuntimeError, match="injected batch failure"):
        run_worker(PORT, config12_window(PORT, 1, n=40), chunk_items=20)


def test_pressure_level_1_splits_and_takes_ffd(global_handles):
    want, _ = run_worker(JAX, priced_window(JAX), backend="global",
                         monitor=HeldMonitor(JAX, 1, split_items=100))
    got, worker = run_worker(PORT, priced_window(PORT), backend="global",
                             monitor=HeldMonitor(PORT, 1, split_items=100))
    assert got == want
    chunks = worker.last_window["chunks"]
    assert [c["pods"] for c in chunks] == [100, 100, 70]
    assert all(not c["global"] for c in chunks)
    assert worker.last_window["pipeline"]["depth"] == 1
    assert worker.last_window["pressure_level"] == 1
    assert global_handles == {"jax": [], "port": []}
    assert "device-global" not in port_solve_mod.solver_health()["executor_counts"]


def pod_affinity_pod(pkg: Pkg, name, labels, cpu="500m", mem="512Mi", aff=(), anti=(),
                     preferred=(), zone=None):
    """A pending pod with required pod-(anti-)affinity terms ``aff`` /
    ``anti`` and ``preferred`` (weight, term) pairs, each term a (topology
    key, match_labels) pair; ``zone`` pins it by node selector."""
    c = pkg.core

    def term(key, ml):
        return c.PodAffinityTerm(topology_key=key,
                                 label_selector=c.LabelSelector(match_labels=dict(ml)))

    p = affinity_pod(pkg, name, cpu, mem, [])
    p.metadata.labels = dict(labels)
    if zone:
        p.spec.node_selector = {pkg.wellknown.LABEL_TOPOLOGY_ZONE: zone}
    if aff or anti or preferred:
        p.spec.affinity = c.Affinity(
            pod_affinity=c.PodAffinity(
                required=[term(*t) for t in aff],
                preferred=[c.WeightedPodAffinityTerm(weight=w, term=term(*t))
                           for w, t in preferred]) if aff or preferred else None,
            pod_anti_affinity=c.PodAffinity(required=[term(*t) for t in anti]) if anti else None)
    return p


def pod_affinity_window(pkg: Pkg, seed, cohorts=3, per=6, replicas=12):
    """config12_catalog with (a) ``replicas`` app=cache pods with required
    hostname anti-affinity against app=cache; (b) ``cohorts`` cohorts of
    ``per`` app=web-k pods with required zone affinity to app=db-k, whose
    2 anchors are pinned to a zone; (c) as many cohorts with a preferred
    zone affinity (weight 50) to the same anchors; (d) a pod whose
    affinity and anti-affinity conflict inside its component; (e) a pod
    with a lonely required term; shuffled by ``seed``."""
    wk = pkg.wellknown
    host, zone = wk.LABEL_HOSTNAME, wk.LABEL_TOPOLOGY_ZONE
    pods = [pod_affinity_pod(pkg, f"cache-{i:02d}", {"app": "cache"}, cpu="1500m", mem="2Gi",
                             anti=[(host, {"app": "cache"})]) for i in range(replicas)]
    for k in range(cohorts):
        db, z = {"app": f"db-{k}"}, ZONES[k % len(ZONES)]
        pods += [pod_affinity_pod(pkg, f"db-{k}-{j}", db, zone=z) for j in range(2)]
        pods += [pod_affinity_pod(pkg, f"web-{k}-{j}", {"app": f"web-{k}"}, aff=[(zone, db)])
                 for j in range(per)]
        pods += [pod_affinity_pod(pkg, f"soft-{k}-{j}", {"app": f"soft-{k}"},
                                  preferred=[(50, (zone, db))]) for j in range(per)]
    pods.append(pod_affinity_pod(pkg, "conflict", {"app": "solo"},
                                 aff=[(host, {"app": "solo"})], anti=[(host, {"app": "solo"})]))
    pods.append(pod_affinity_pod(pkg, "partner", {"app": "solo"}, aff=[(host, {"app": "solo"})]))
    pods.append(pod_affinity_pod(pkg, "lonely", {"app": "x"}, aff=[(zone, {"app": "nobody"})]))
    random.Random(seed).shuffle(pods)
    return config12_catalog(pkg), pods


@pytest.mark.parametrize("policy", ["cheapest", "interruption-priced"])
@pytest.mark.parametrize("depth", [1, 2])
def test_pod_affinity_window_binds_as_the_jax_controller(depth, policy):
    """(f): the same binds (zone and capacity type included) as the JAX
    controller; the cache replicas on distinct nodes, every required and
    preferred cohort in its anchor's zone, the unsatisfiable pods left
    out."""
    chunk_items = 0 if depth == 1 else 40
    want, _ = run_worker(JAX, pod_affinity_window(JAX, depth), depth=depth,
                         chunk_items=chunk_items, policy=policy, zones=True)
    got, worker = run_worker(PORT, pod_affinity_window(PORT, depth), depth=depth,
                             chunk_items=chunk_items, policy=policy, zones=True)
    assert got == want
    node_of_pod = {n: (i, b[2]) for i, b in enumerate(got) for n in b[1]}
    assert {"conflict", "partner", "lonely"}.isdisjoint(node_of_pod)
    caches = [node_of_pod[n][0] for n in node_of_pod if n.startswith("cache-")]
    assert len(set(caches)) == len(caches)
    if chunk_items == 0:
        # one chunk holds every cohort with its anchors (in chunks of 40 a
        # follower without its anchor in the chunk is a lonely term in both
        # packages)
        assert len(node_of_pod) == 12 + 3 * (2 + 6 + 6)
        for k in range(3):
            anchor = {node_of_pod[f"db-{k}-{j}"][1] for j in range(2)}
            assert anchor == {ZONES[k]}
            for j in range(6):
                assert node_of_pod[f"web-{k}-{j}"][1] == ZONES[k]
                assert node_of_pod[f"soft-{k}-{j}"][1] == ZONES[k]
    assert all(chunk["gang"] is None for chunk in worker.last_window["chunks"])


def spread_window(pkg: Pkg, seed, n=90):
    """config12_window's pods, a third of them (three apps) with a zone
    topology spread of max skew 1 against their app's pods, the rest with a
    hostname spread of max skew 4: the spread goes through Topology.inject
    (the columnar allowed-domain sets)."""
    catalog, pods = config12_window(pkg, seed, n)
    wk = pkg.wellknown
    for i, p in enumerate(pods):
        app = f"app-{i % 3}"
        p.metadata.labels = {"app": app}
        key, skew = (wk.LABEL_TOPOLOGY_ZONE, 1) if i % 3 == 0 else (wk.LABEL_HOSTNAME, 4)
        p.spec.topology_spread_constraints = [pkg.core.TopologySpreadConstraint(
            max_skew=skew, topology_key=key,
            label_selector=pkg.core.LabelSelector(match_labels={"app": app}))]
    return catalog, pods


def partition(binds):
    """Binds as (type, zone, capacity type, pods), sorted: hostname domains
    are random draws in both packages, so nodes compare as a partition."""
    return sorted((b[0], b[2], b[3], b[1]) for b in binds)


WINDOWS = {"config12": config12_window, "affinity": pod_affinity_window,
           "spread": spread_window}


@pytest.mark.parametrize("window,seed", [("config12", s) for s in SEEDS]
                         + [("spread", s) for s in SEEDS] + [("affinity", 1)])
def test_columnar_controller_binds_as_the_scalar_path_and_jax(window, seed, monkeypatch):
    """The columnar engine (the port's default: the scheduler's memoized
    schedule_entry, the topology spread's allowed_domain sets) binds what
    the JAX controller binds and what the port's scalar path binds on the
    same pods (compile_constraints patched to give None: validate_pod and
    tighten per pod), at depth 2 over chunks of 40."""
    from karpenter_tpu_torch.ops import feasibility as port_feas

    make = WINDOWS[window]
    entries = []
    real_entry = port_feas.CompiledConstraints.schedule_entry

    def counting_entry(self, pod):
        entries.append(1)
        return real_entry(self, pod)

    monkeypatch.setattr(port_feas.CompiledConstraints, "schedule_entry", counting_entry)
    port_feas.reset_heals()
    kw = dict(depth=2, chunk_items=40, zones=True)
    want, _ = run_worker(JAX, make(JAX, seed), **kw)
    columnar, _ = run_worker(PORT, make(PORT, seed), **kw)
    assert entries, "the scheduler did not take the columnar engine"
    assert port_feas.heal_counts() == {}
    monkeypatch.setattr(port_feas, "compile_constraints", lambda c: None)
    del entries[:]
    scalar, _ = run_worker(PORT, make(PORT, seed), **kw)
    assert not entries
    if window == "config12":
        assert columnar == scalar == want
    else:
        assert partition(columnar) == partition(scalar) == partition(want)
    assert sum(len(b[1]) for b in columnar) > 0


# -- gang windows: co-pack, torus carving and preemption ----------------------------

def gang_pod(pkg: Pkg, gang, size, i, slice_=None, priority=0, cpu="1", mem="1Gi"):
    pod = affinity_pod(pkg, f"{gang}-m{i}", cpu, mem, [])
    wk = pkg.wellknown
    pod.metadata.labels[wk.POD_GROUP_LABEL] = gang
    pod.metadata.labels[wk.POD_GROUP_SIZE_LABEL] = str(size)
    if slice_ is not None:
        pod.metadata.labels[wk.POD_GROUP_SLICE_LABEL] = slice_
    pod.spec.priority = priority
    return pod


def gang_waves(pkg: Pkg):
    """Wave 1: slice gangs of three shapes (2-D and 3-D), a plain gang and
    plain pods in one window; wave 2: more slices, the first of which
    reuses a partly carved node of wave 1 (a seed serves the window's
    first gang schedule of its type and signature only, ROADMAP §C)."""
    wave1 = ([gang_pod(pkg, f"sq{g}", 4, i, "v5e-2x2") for g in range(3) for i in range(4)]
             + [gang_pod(pkg, f"cube{g}", 2, i, "v4-2x2x2") for g in range(2) for i in range(2)]
             + [gang_pod(pkg, "big", 8, i, "v5e-4x4", cpu="2") for i in range(8)]
             + [gang_pod(pkg, "plain", 3, i, cpu="3") for i in range(3)]
             + [affinity_pod(pkg, f"solo-{i}", "500m", "512Mi", []) for i in range(6)])
    wave2 = ([gang_pod(pkg, f"late{g}", 2, i, "v5e-2x2") for g in range(2) for i in range(2)]
             + [gang_pod(pkg, "zcube", 2, i, "v4-2x2x2") for i in range(2)])
    return [wave1, wave2]


def preemption_waves(pkg: Pkg):
    """A low-band gang fills a whole 4x4 torus; a high-band gang then wants
    a 2x2 carve there: displacing the low gang (its members refit on a
    $1/h node) is cheaper than a fresh $4/h torus."""
    low = [gang_pod(pkg, "low-res", 2, i, "v5e-4x4", priority=-5, cpu="2") for i in range(2)]
    high = [gang_pod(pkg, "high-pri", 2, i, "v5e-2x2", priority=10, cpu="2") for i in range(2)]
    return [low, high]


def run_gang_worker(pkg: Pkg, waves, carve=True):
    """Each wave through one worker pass (``worker.add``, then
    ``worker.provision()`` on this thread), then passes until the batcher
    holds nothing (a displaced gang comes back through it). Returns the
    bound partition ((instance type, sorted pod names) per node), the
    ledger (node's pods, grid, occupancy, carves by gang) and the worker."""
    topo = __import__(f"{pkg.prov.__name__.rsplit('.', 2)[0]}.ops.topology",
                      fromlist=["LEDGER"])
    topo.LEDGER.reset()
    catalog = pkg.fake.tpu_catalog()
    kube = pkg.kube.KubeCore()
    provider = pkg.fake.FakeCloudProvider(catalog=catalog)
    provisioner = pkg.Provisioner(
        metadata=pkg.core.ObjectMeta(name="default", namespace="default"),
        spec=pkg.ProvisionerSpec(constraints=pkg.universe(catalog)))
    kube.create(provisioner)
    batcher = pkg.batcher.Batcher(idle_seconds=0.01, max_seconds=5.0, monitor=quiet_monitor(pkg))
    pipeline_config = pkg.pipeline.PipelineConfig(depth=1, chunk_items=0, adaptive=False)
    if pkg.name == "jax":
        worker = jax_prov.ProvisionerWorker(
            provisioner, kube, provider, batcher=batcher, pipeline_config=pipeline_config,
            solver_config=jax_solve_mod.SolverConfig(window_backend="ffd", device_min_pods=1))
    else:
        worker = port_prov.ProvisionerWorker(
            provisioner, kube, provider, batcher=batcher, pipeline_config=pipeline_config,
            solver_config=port_solve_mod.SolverConfig(window_backend="ffd", device_min_pods=0),
            device="cpu")
    try:
        for wave in waves:
            for pod in wave:
                kube.create(pod)
                assert worker.add(pod, key=(pod.metadata.namespace, pod.metadata.name))
            worker.provision()
            while worker.batcher.depth():
                worker.provision()
    finally:
        worker.stop()
    label = pkg.wellknown.LABEL_INSTANCE_TYPE
    pods_of = {n.metadata.name: tuple(sorted(p.metadata.name
                                             for p in kube.pods_on_node(n.metadata.name)))
               for n in kube.list("Node")}
    partition = sorted((n.metadata.labels[label], pods_of[n.metadata.name])
                       for n in kube.list("Node"))
    ledger = sorted((pods_of[ng.node], ng.dims, ng.occ.tolist(),
                     sorted((str(k), r.band, tuple(int(c) for c in r.cells), sorted(r.pods))
                            for k, r in ng.carves.items()))
                    for ng in topo.LEDGER.snapshot())
    topo.LEDGER.reset()
    return partition, ledger, worker


def test_gang_waves_bind_as_the_jax_controller():
    """Both controllers bind the same node partition, commit the same
    carves and reuse the same partly carved nodes; every gang is whole on
    its nodes and every carve is a placement-mask row of its slice."""
    from karpenter_tpu_torch.ops import topology as port_topo

    want = run_gang_worker(JAX, gang_waves(JAX))
    got = run_gang_worker(PORT, gang_waves(PORT))
    assert got[:2] == want[:2]
    partition, ledger, worker = got
    bound = [p for _, pods in partition for p in pods]
    assert len(bound) == len(set(bound)) == sum(len(w) for w in gang_waves(PORT))
    chunks = [ch for ch in worker.last_window["chunks"] if ch["gang"]]
    assert chunks and chunks[-1]["gang"]["executor"] == "device-gang"
    assert chunks[-1]["gang"]["carve"] and chunks[-1]["gang"]["placed"] == 3
    # wave 2 reused a partly carved node of wave 1
    shared = [pods for _, pods in partition if "late0-m0" in pods][0]
    assert any(p.startswith("sq") for p in shared)
    for pods, dims, occ, carves in ledger:
        for _key, _band, cells, _members in carves:
            slice_dims = {4: (2, 2), 8: (2, 2, 2), 16: (4, 4)}[len(cells)]
            masks = port_topo.placement_masks(dims, slice_dims)
            row = np.zeros(len(occ), bool)
            row[list(cells)] = True
            assert any(np.array_equal(m, row) for m in masks)


def test_gang_preemption_lifecycle_as_the_jax_controller():
    """The high gang displaces the low one on its torus; the low gang is
    requeued and binds again elsewhere, in both packages alike."""
    want = run_gang_worker(JAX, preemption_waves(JAX))
    got = run_gang_worker(PORT, preemption_waves(PORT))
    assert got[:2] == want[:2]
    partition, ledger, worker = got
    nodes = {p: i for i, (_, pods) in enumerate(partition) for p in pods}
    assert nodes["high-pri-m0"] == nodes["high-pri-m1"]
    assert nodes["low-res-m0"] != nodes["high-pri-m0"]
    assert worker.preempt_budget.in_cooldown(("default", "low-res"))


def test_gang_carve_switch_off_binds_as_the_jax_controller(monkeypatch):
    """KARPENTER_TOPOLOGY_CARVE=0 in both packages: shape-only windows,
    no ledger, the same partition."""
    monkeypatch.setenv("KARPENTER_TOPOLOGY_CARVE", "0")
    want = run_gang_worker(JAX, gang_waves(JAX))
    got = run_gang_worker(PORT, gang_waves(PORT))
    assert got[:2] == want[:2] and got[1] == []


# -- the port alone, through the controllers ----------------------------------------

def unschedulable_pod(requests=None, node_selector=None, tolerations=None, name=None,
                      labels=None, **spec_kwargs):
    c = port_core
    return c.Pod(
        metadata=c.ObjectMeta(name=name or f"pod-{uuid.uuid4().hex[:8]}",
                              uid=uuid.uuid4().hex, labels=dict(labels or {})),
        spec=c.PodSpec(node_selector=node_selector or {}, tolerations=tolerations or [],
                       containers=[c.Container(resources=c.ResourceRequirements.make(
                           requests=requests or {"cpu": "1", "memory": "512Mi"}))],
                       **spec_kwargs),
        status=c.PodStatus(phase="Pending", conditions=[c.PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable")]))


def make_provisioner(name="default", constraints=None, **spec_kwargs):
    return PortProvisioner(metadata=port_core.ObjectMeta(name=name, namespace="default"),
                           spec=PortProvisionerSpec(constraints=constraints or Constraints(),
                                                    **spec_kwargs))


@pytest.fixture()
def env():
    kube = port_kube.KubeCore()
    provider = port_fake.FakeCloudProvider(catalog=port_fake.instance_types(10))
    monitor = quiet_monitor(PORT)
    provisioning = port_prov.ProvisioningController(
        kube, provider, device="cpu",
        batcher_factory=lambda: port_batcher.Batcher(idle_seconds=0.02, max_seconds=2.0,
                                                     monitor=monitor))
    selection = SelectionController(kube, provisioning)
    yield kube, provider, provisioning, selection
    workers = list(provisioning.workers.values())
    provisioning.stop_all(timeout=10.0)
    assert not any(w._thread.is_alive() for w in workers)


def setup_provisioner(kube, provisioning, **kwargs):
    provisioner = make_provisioner(**kwargs)
    kube.create(provisioner)
    provisioning.reconcile(provisioner.metadata.name)
    return provisioner


def expect_provisioned(kube, selection, provisioning, pods, timeout=30.0):
    """Create the pods, reconcile each through selection, then wait until
    every worker that received work has flushed every item added so far."""
    for pod in pods:
        kube.create(pod)
    for pod in pods:
        selection.reconcile(pod.metadata.name, pod.metadata.namespace)
    deadline = time.monotonic() + timeout
    for worker in list(provisioning.workers.values()):
        b = worker.batcher
        target = b.added_total
        while b.processed_total < target:
            assert time.monotonic() < deadline, "batched pods never processed"
            with b._lock:
                gate = b._gate
                if b.processed_total >= target:
                    break
            gate.wait(timeout=0.2)
    return [kube.get("Pod", p.metadata.name, p.metadata.namespace) for p in pods]


def node_of(kube, pod):
    return kube.get("Pod", pod.metadata.name, pod.metadata.namespace).spec.node_name


def test_default_device_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        port_prov.ProvisioningController(port_kube.KubeCore(), port_fake.FakeCloudProvider())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_prov.ProvisionerWorker(make_provisioner(), port_kube.KubeCore(),
                                    port_fake.FakeCloudProvider())


def test_provisions_nodes(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    pods = [unschedulable_pod() for _ in range(5)]
    expect_provisioned(kube, selection, provisioning, pods)
    assert all(node_of(kube, p) for p in pods)
    node = kube.get("Node", provider.created[0].metadata.name, "")
    wk = port_wellknown
    assert wk.TERMINATION_FINALIZER in node.metadata.finalizers
    assert any(t.key == wk.NOT_READY_TAINT_KEY for t in node.spec.taints)
    assert node.metadata.labels[wk.PROVISIONER_NAME_LABEL] == "default"
    worker = provisioning.workers["default"]
    assert worker._thread.name == "provisioner-default"


def test_the_default_monitor_admits_a_window():
    """The controller as deployed (the default Batcher and the process-wide
    monitor with its default config) stays at L0 over a small window in a
    process that holds both packages: the RSS signal counts the growth
    since the monitor was made, not the libraries' footprint."""
    kube = port_kube.KubeCore()
    provisioning = port_prov.ProvisioningController(
        kube, port_fake.FakeCloudProvider(catalog=port_fake.instance_types(10)), device="cpu")
    selection = SelectionController(kube, provisioning)
    try:
        setup_provisioner(kube, provisioning)
        pods = [unschedulable_pod() for _ in range(20)]
        expect_provisioned(kube, selection, provisioning, pods)
        assert all(node_of(kube, p) for p in pods)
        assert int(port_pressure.get_monitor().level()) == 0
        assert provisioning.workers["default"].last_window["pressure_level"] == 0
    finally:
        workers = list(provisioning.workers.values())
        provisioning.stop_all(timeout=10.0)
        assert not any(w._thread.is_alive() for w in workers)


def test_groups_pods_onto_shared_nodes(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    pods = [unschedulable_pod(requests={"cpu": "100m", "memory": "64Mi"}) for _ in range(20)]
    expect_provisioned(kube, selection, provisioning, pods)
    nodes = {node_of(kube, p) for p in pods}
    assert "" not in nodes and 1 <= len(nodes) < 10


def test_ignores_daemonset_owned_pods(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    pod = unschedulable_pod()
    pod.metadata.owner_references.append(port_core.OwnerReference(kind="DaemonSet", name="ds"))
    kube.create(pod)
    assert selection.reconcile(pod.metadata.name) is None
    assert node_of(kube, pod) == "" and provider.created == []


@pytest.mark.parametrize("with_daemon", [False, True])
def test_daemonset_overhead_is_counted(env, with_daemon):
    """A 3-cpu pod fits fake-it-3 (4 cpu) alone; with a 1-cpu daemon set on
    every node it needs fake-it-4."""
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    if with_daemon:
        c = port_core
        kube.create(c.DaemonSet(metadata=c.ObjectMeta(name="logging"), spec=c.DaemonSetSpec(
            template=c.PodTemplateSpec(spec=c.PodSpec(containers=[c.Container(
                resources=c.ResourceRequirements.make(requests={"cpu": "1", "memory": "256Mi"}))])))))
    pods = [unschedulable_pod(requests={"cpu": "3", "memory": "512Mi"})]
    expect_provisioned(kube, selection, provisioning, pods)
    node = kube.get("Node", node_of(kube, pods[0]), "")
    want = "fake-it-4" if with_daemon else "fake-it-3"
    assert node.metadata.labels[port_wellknown.LABEL_INSTANCE_TYPE] == want


def test_respects_node_selector_zone(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    pods = [unschedulable_pod(node_selector={port_wellknown.LABEL_TOPOLOGY_ZONE: "test-zone-2"})]
    expect_provisioned(kube, selection, provisioning, pods)
    node = kube.get("Node", node_of(kube, pods[0]), "")
    assert node.metadata.labels[port_wellknown.LABEL_TOPOLOGY_ZONE] == "test-zone-2"


def test_rejects_unknown_node_selector(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    pod = unschedulable_pod(node_selector={"unknown-label": "x"})
    expect_provisioned(kube, selection, provisioning, [pod])
    assert node_of(kube, pod) == "" and provider.created == []
    assert not provisioning.workers["default"].pending(("default", pod.metadata.name))


def test_taints_block_intolerant_pods(env):
    kube, provider, provisioning, selection = env
    taint = port_core.Taint(key="dedicated", value="ml", effect="NoSchedule")
    setup_provisioner(kube, provisioning, constraints=Constraints(taints=Taints([taint])))
    intolerant = unschedulable_pod()
    tolerant = unschedulable_pod(tolerations=[port_core.Toleration(
        key="dedicated", operator="Equal", value="ml", effect="NoSchedule")])
    expect_provisioned(kube, selection, provisioning, [intolerant, tolerant])
    assert node_of(kube, intolerant) == ""
    node = kube.get("Node", node_of(kube, tolerant), "")
    assert any(t.key == "dedicated" for t in node.spec.taints)


def test_deleted_pod_not_provisioned(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    pod = unschedulable_pod()
    kube.create(pod)
    kube.delete("Pod", pod.metadata.name, pod.metadata.namespace)
    assert selection.reconcile(pod.metadata.name) is None
    # deleted while it sat in a window: the provisionability re-read drops it
    worker = provisioning.workers["default"]
    ghost = unschedulable_pod()
    assert not worker._is_provisionable(ghost)
    assert provider.created == []


def test_limits_cap_provisioning(env):
    kube, provider, provisioning, selection = env
    provisioner = make_provisioner(limits=Limits(resources=parse_resource_list({"cpu": "1"})))
    provisioner.status.resources = parse_resource_list({"cpu": "10"})
    kube.create(provisioner)
    provisioning.reconcile(provisioner.metadata.name)
    pods = [unschedulable_pod()]
    expect_provisioned(kube, selection, provisioning, pods)
    assert node_of(kube, pods[0]) == "" and provider.created == []


def test_first_matching_provisioner_wins(env):
    kube, provider, provisioning, selection = env
    taint = port_core.Taint(key="a", value="1", effect="NoSchedule")
    setup_provisioner(kube, provisioning, name="tainted",
                      constraints=Constraints(taints=Taints([taint])))
    setup_provisioner(kube, provisioning, name="open")
    pods = [unschedulable_pod()]
    expect_provisioned(kube, selection, provisioning, pods)
    node = kube.get("Node", node_of(kube, pods[0]), "")
    assert node.metadata.labels[port_wellknown.PROVISIONER_NAME_LABEL] == "open"


def test_sharded_deployment_routes_each_provisioner(env):
    """shards=2: the provisioners' engines live on shard workers and every
    pod still lands on a node of its own provisioner."""
    kube, provider, _, _ = env
    monitor = quiet_monitor(PORT)
    provisioning = port_prov.ProvisioningController(
        kube, provider, shards=2, device="cpu",
        batcher_factory=lambda: port_batcher.Batcher(idle_seconds=0.02, max_seconds=2.0,
                                                     monitor=monitor))
    selection = SelectionController(kube, provisioning)
    try:
        names = ["alpha", "beta", "gamma"]
        for name in names:
            label = port_core.NodeSelectorRequirement(key="team", operator="In", values=[name])
            setup_provisioner(kube, provisioning, name=name, constraints=Constraints(
                labels={"team": name}, requirements=Requirements([label])))
        assert set(provisioning.workers) <= {"shard-0", "shard-1"}
        assert [p.metadata.name for p, _ in provisioning.targets()] == [
            n for w in provisioning.workers.values() for n in
            [e.provisioner.metadata.name for e in w.engines()]]
        pods = [unschedulable_pod(node_selector={"team": names[i % 3]}) for i in range(9)]
        expect_provisioned(kube, selection, provisioning, pods)
        for i, pod in enumerate(pods):
            node = kube.get("Node", node_of(kube, pod), "")
            assert node.metadata.labels[port_wellknown.PROVISIONER_NAME_LABEL] == names[i % 3]
        kube.delete("Provisioner", "beta", "default")
        provisioning.reconcile("beta")
        assert "beta" not in [p.metadata.name for p, _ in provisioning.targets()]
    finally:
        workers = list(provisioning.workers.values())
        provisioning.stop_all(timeout=10.0)
        assert not any(w._thread.is_alive() for w in workers)


def test_spec_change_restarts_the_worker(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    first = provisioning.workers["default"]
    provisioning.reconcile("default")
    assert provisioning.workers["default"] is first

    def relabel(p):
        p.spec.constraints.labels["tier"] = "gold"

    kube.patch("Provisioner", "default", "default", relabel)
    provisioning.reconcile("default")
    assert provisioning.workers["default"] is not first
    first._thread.join(10.0)
    assert not first._thread.is_alive()


def test_status_conditions_set_and_name_the_executor(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    p = kube.get("Provisioner", "default")
    active = get_condition(p.status.conditions, "Active")
    assert active.status == "True" and active.reason == "WorkerRunning"
    solver = get_condition(p.status.conditions, "SolverHealthy")
    # the last executor is process-wide: an earlier test may have set it
    assert solver.status == "True" and solver.reason == "ExecutorRingsNominal"
    expect_provisioned(kube, selection, provisioning, [unschedulable_pod() for _ in range(3)])
    provisioning.reconcile("default")
    solver = get_condition(kube.get("Provisioner", "default").status.conditions, "SolverHealthy")
    # three pods are under the default gate (device_min_pods=512): the
    # native host ring answers them, as in the JAX package
    assert solver.message == "last solve: executor=native"


def test_condition_refresh_does_not_loop(env):
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    rv1 = kube.get("Provisioner", "default").metadata.resource_version
    provisioning.reconcile("default")
    assert kube.get("Provisioner", "default").metadata.resource_version == rv1
    expect_provisioned(kube, selection, provisioning, [unschedulable_pod() for _ in range(2)])
    provisioning.reconcile("default")
    rv3 = kube.get("Provisioner", "default").metadata.resource_version
    provisioning.reconcile("default")
    assert kube.get("Provisioner", "default").metadata.resource_version == rv3


def bind_worker(kube):
    return port_prov.ProvisionerWorker(make_provisioner(), kube,
                                       port_fake.FakeCloudProvider(port_fake.instance_types(4)),
                                       device="cpu")


def test_bind_error_propagates_joined():
    kube = port_kube.KubeCore()
    worker = bind_worker(kube)
    ghost = port_core.Pod(metadata=port_core.ObjectMeta(name="never-created"))
    err = worker._bind(port_core.Node(metadata=port_core.ObjectMeta(name="n1", namespace="")),
                       [ghost])
    assert err is not None and "not found" in err
    assert "1 pod(s)" in err and "n1" in err


def test_already_bound_pod_is_success():
    kube = port_kube.KubeCore()
    worker = bind_worker(kube)
    pod = unschedulable_pod(name="bound-once")
    kube.create(pod)
    kube.bind_pods([pod], "elsewhere")
    err = worker._bind(port_core.Node(metadata=port_core.ObjectMeta(name="n2", namespace="")),
                       [pod])
    assert err is None
    assert kube.get("Pod", "bound-once").spec.node_name == "elsewhere"


@pytest.mark.parametrize("case", ["cheapest", "pinned", "unpinned"])
def test_chunk_solver_config_prices_the_repack(case):
    """Only interruption-priced with no pinned repack price prices the
    chunk: with no ready node to refit on, the cheapest on-demand price of
    the chunk's catalog; the throughput table rides along."""
    from karpenter_tpu_torch.solver.policy import PolicyContext

    catalog = config12_catalog(PORT)
    policy = "cheapest" if case == "cheapest" else "interruption-priced"
    ctx = PolicyContext(repack_cost_per_hour=1.5 if case == "pinned" else 0.0,
                        throughput={"t00-1x2": 2.0})
    worker = port_prov.ProvisionerWorker(
        make_provisioner(constraints=PORT.universe(catalog)), port_kube.KubeCore(),
        port_fake.FakeCloudProvider(catalog=catalog), device="cpu",
        solver_config=port_solve_mod.SolverConfig(packing_policy=policy, policy_context=ctx))
    prep = worker._prepare_chunk([affinity_pod(PORT, f"p{i}", "500m", "512Mi", [])
                                  for i in range(3)])
    if case != "unpinned":
        assert prep.solver_config is None
        return
    cfg = prep.solver_config
    assert cfg.policy_context.repack_cost_per_hour == min(it.price for it in catalog)
    assert dict(cfg.policy_context.throughput) == {"t00-1x2": 2.0}
    assert cfg.packing_policy == "interruption-priced"


def test_steer_narrows_a_copy_to_the_voted_zone():
    """A schedule with zone votes launches in the voted zone, on a copy of
    its constraints; without votes the schedule's own constraints go to
    the launch."""
    from karpenter_tpu_torch.scheduling.scheduler import Schedule
    from karpenter_tpu_torch.solver.solve import Packing

    catalog = config12_catalog(PORT)
    worker = bind_worker(port_kube.KubeCore())
    constraints = PORT.universe(catalog)
    packing = Packing(pods=[[]], instance_type_options=catalog[:3])
    plain = Schedule(constraints=constraints)
    assert worker._steer(plain, packing) is constraints
    zone = port_wellknown.LABEL_TOPOLOGY_ZONE
    voted = Schedule(constraints=constraints, soft_affinity={(zone, "z2"): 50})
    steered = worker._steer(voted, packing)
    assert steered is not constraints
    assert steered.requirements.zones() == {"z2"}
    assert constraints.requirements.zones() == set(ZONES)


def test_affinity_and_gang_pods_are_held_out(env, caplog):
    """A pod with a lonely required zone-affinity term is proven
    unsatisfiable by the affinity injection (the JAX package's rule): it
    stays Pending with ``_affinity_unsat`` and is counted as
    ``reason=affinity``. The members of a complete gang are no longer held
    out: they go through the chunk's co-pack window and bind together,
    beside a plain pod of the same window."""
    kube, provider, provisioning, selection = env
    setup_provisioner(kube, provisioning)
    c, wk = port_core, port_wellknown
    term = c.PodAffinityTerm(topology_key=wk.LABEL_TOPOLOGY_ZONE,
                             label_selector=c.LabelSelector(match_labels={"app": "web"}))
    affine = unschedulable_pod(affinity=c.Affinity(pod_affinity=c.PodAffinity(required=[term])))
    gang = [unschedulable_pod(labels={wk.POD_GROUP_LABEL: "train", wk.POD_GROUP_SIZE_LABEL: "2"})
            for _ in range(2)]
    plain = unschedulable_pod()
    worker = provisioning.workers["default"]
    seen = []
    orig_prepare = worker._prepare_chunk

    def recording_prepare(pods):
        prep = orig_prepare(pods)
        seen.extend(pods)
        return prep

    worker._prepare_chunk = recording_prepare
    with caplog.at_level("INFO", logger="karpenter.scheduler"):
        expect_provisioned(kube, selection, provisioning, [affine, *gang, plain])
    assert node_of(kube, plain) != ""
    assert node_of(kube, affine) == ""
    gang_nodes = {node_of(kube, pod) for pod in gang}
    assert "" not in gang_nodes and node_of(kube, plain) not in gang_nodes
    marks = {p.metadata.name: p.__dict__ for p in seen}
    assert marks[affine.metadata.name]["_affinity_unsat"] is True
    assert all("_gang_unsat" not in marks[p.metadata.name] for p in gang)
    assert any("reason=affinity: 1," in r.getMessage() for r in caplog.records)
    chunk_gangs = [ch["gang"] for ch in worker.last_window["chunks"] if ch["gang"]]
    assert chunk_gangs[0]["placed"] == 1 and chunk_gangs[0]["executor"] == "device-gang"
    assert len(provider.created) == 1 + len(gang_nodes)


# -- validate_pod: the verdicts selection and the scheduler route by ------------

VALIDATE_KEYS = (port_wellknown.LABEL_TOPOLOGY_ZONE, "failure-domain.beta.kubernetes.io/zone",
                 port_wellknown.LABEL_INSTANCE_TYPE, port_wellknown.LABEL_CAPACITY_TYPE,
                 "kubernetes.io/arch", "custom")


def validate_case(rng, core, constraints_cls, requirements_cls):
    """A provisioner's requirements and a pod (node selector, one required
    node-affinity term of In and NotIn expressions) in either package, from
    ``rng``'s draws: keys with beta aliases, empty value lists included."""
    values = ["a", "b", "c", "d", "e"]

    def reqs(n):
        return [core.NodeSelectorRequirement(
            key=rng.choice(VALIDATE_KEYS), operator=rng.choice(["In", "In", "NotIn"]),
            values=rng.sample(values, rng.randint(0, 3))) for _ in range(n)]

    provisioner = constraints_cls(requirements=requirements_cls(reqs(rng.randint(0, 4))))
    selector = {rng.choice(VALIDATE_KEYS): rng.choice(values) for _ in range(rng.randint(0, 2))}
    terms = [core.NodeSelectorTerm(match_expressions=reqs(rng.randint(0, 3)))]
    affinity = (core.Affinity(node_affinity=core.NodeAffinity(required=terms))
                if rng.random() < 0.8 else None)
    pod = core.Pod(metadata=core.ObjectMeta(name="p"),
                   spec=core.PodSpec(node_selector=selector, affinity=affinity))
    return provisioner, pod


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_validate_pod_verdicts_equal_the_jax_package(seed):
    """500 seeded (provisioner, pod) pairs: the port's Constraints.validate_pod
    returns the JAX package's verdict, error text included, exactly."""
    from karpenter_tpu.api.constraints import Constraints as JaxConstraints
    from karpenter_tpu.api.requirements import Requirements as JaxRequirements

    rng = random.Random(seed)
    verdicts = set()
    for _ in range(500):
        draw = rng.random()
        jax_prov_c, jax_pod = validate_case(random.Random(draw), jax_core, JaxConstraints,
                                            JaxRequirements)
        port_prov_c, port_pod = validate_case(random.Random(draw), port_core, Constraints,
                                              Requirements)
        want = jax_prov_c.validate_pod(jax_pod)
        assert port_prov_c.validate_pod(port_pod) == want
        verdicts.add(want is None)
    assert verdicts == {True, False}  # both kinds of verdict were drawn
