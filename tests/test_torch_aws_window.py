"""A controller window over the AWS provider, the port against the JAX
package, on the CPU.

- A config_12-like window (pods in required-node-affinity groups over
  capacity types, zones and instance-type names) through each package's
  ``ProvisionerWorker`` (the port's on ``device="cpu"``) over its own
  ``AWSCloudProvider`` on its own ``FakeEC2API``: the same nodes (instance
  type, zone, capacity type) holding the same pods, the same CreateFleet
  requests (overrides, strategies, tags, the nonce from one seeded
  ``uuid4``), every pod bound once; and the catalog interned across the
  window's discoveries.
- The four ``ChaosEC2`` faults (``ice``, ``throttle``, ``partial``,
  ``crash-before-bind``) on one launch: the same errors, nodes, instances
  and offerings after.
- An ``ice`` on a window's first CreateFleet: the pool poisoned, the
  failed pods bound elsewhere by the next window, in both packages alike.
- ``crash-before-bind`` leaks an instance that the GC controller spares
  inside its grace period and reaps after it, in both packages.
- The EBS CSI zone label normalizes alike once both providers are
  imported.

Every comparison is exact.
"""

import dataclasses
import itertools
import random
import uuid

import pytest

from karpenter_tpu.api.constraints import Constraints as JaxConstraints
from karpenter_tpu.api.requirements import Requirements as JaxRequirements
from karpenter_tpu.chaos import inject as jax_inject
from karpenter_tpu.cloudprovider.aws import provider as jax_aws
from karpenter_tpu.cloudprovider.aws.fake import ec2api as jax_ec2api
from karpenter_tpu.cloudprovider.aws.fake import ssmapi as jax_ssmapi
from karpenter_tpu.controllers import gc as jax_gc
from karpenter_tpu.controllers import provisioning as jax_prov
from karpenter_tpu.metrics.registry import DEFAULT as JAX_REGISTRY
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch.api import wellknown as port_wk
from karpenter_tpu_torch.api.constraints import Constraints as PortConstraints
from karpenter_tpu_torch.api.requirements import Requirements as PortRequirements
from karpenter_tpu_torch.chaos import inject as port_inject
from karpenter_tpu_torch.cloudprovider.aws import provider as port_aws
from karpenter_tpu_torch.cloudprovider.aws.fake import ec2api as port_ec2api
from karpenter_tpu_torch.cloudprovider.aws.fake import ssmapi as port_ssmapi
from karpenter_tpu_torch.controllers import gc as port_gc
from karpenter_tpu_torch.controllers import provisioning as port_prov
from karpenter_tpu_torch.metrics.registry import DEFAULT as PORT_REGISTRY
from karpenter_tpu_torch.ops import encode as port_encode
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.utils import clock as port_clock
from tests.test_torch_controller import (  # noqa: F401 — fresh_process_state is autouse
    JAX, PORT, SHAPES, affinity_pod, fresh_process_state, quiet_monitor,
)

AWS = {"jax": (jax_aws, jax_ec2api, jax_ssmapi, jax_inject, jax_clock, jax_gc, JAX_REGISTRY),
       "port": (port_aws, port_ec2api, port_ssmapi, port_inject, port_clock, port_gc,
                PORT_REGISTRY)}
ZONES = ("test-zone-1a", "test-zone-1b", "test-zone-1c")
CAPACITY_TYPES = ("on-demand", "spot")
SEEDS = (1, 7, 42)
T0 = 1_700_000_000.0
GRACE = 60.0
GC_COUNTERS = ("gc_instances_terminated_total", "gc_nodes_removed_total")
PROVIDER_BLOCK = {"instanceProfile": "nodes", "subnetSelector": {"Name": "*"},
                  "securityGroupSelector": {"Name": "*"}}
CONSTRAINTS = {"jax": (JaxConstraints, JaxRequirements),
               "port": (PortConstraints, PortRequirements)}


def constraints(pkg, zones=ZONES, capacity_types=CAPACITY_TYPES, provider=True):
    """A launch's constraints: the zones and capacity types required, the
    provisioner's name label and (with ``provider``) the AWS block."""
    cls, reqs = CONSTRAINTS[pkg.name]
    wk = pkg.wellknown
    return cls(labels={wk.PROVISIONER_NAME_LABEL: "default"}, requirements=reqs([
        pkg.core.NodeSelectorRequirement(key=key, operator="In", values=list(values))
        for key, values in ((wk.LABEL_TOPOLOGY_ZONE, zones),
                            (wk.LABEL_CAPACITY_TYPE, capacity_types)) if values]),
        provider=dict(PROVIDER_BLOCK) if provider else None)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both fakes' id counters from 1, both clocks at T0, no fault plan;
    after the test the same, with the clocks released."""
    for name in AWS:
        _, ec2api, _, inject, clock, _, _ = AWS[name]
        monkeypatch.setattr(ec2api, "_counter", itertools.count(1))
        clock.DEFAULT.set(T0)
    yield
    for name in AWS:
        AWS[name][3].uninstall()
        AWS[name][4].DEFAULT.reset()


@pytest.fixture()
def draws():
    """One seeded uuid4 sequence, restarted for each package's run."""
    real = uuid.uuid4

    def restart():
        rng = random.Random(5)
        uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)

    yield restart
    uuid.uuid4 = real


def catalog_infos(pkg):
    """24 types, cpu 1-12 at memory ratios 2 and 4 (config_12's window in
    small), both usage classes, priced per cpu; 2 ENIs of 15 addresses."""
    _, ec2api, _, _, _, _, _ = AWS[pkg.name]
    sdk = ec2api.sdk
    return [sdk.InstanceTypeInfo(
        instance_type=f"m5.t{i:02d}-{cpu}x{ratio}", vcpus=cpu, memory_mib=cpu * ratio * 1024,
        maximum_network_interfaces=2, ipv4_addresses_per_interface=15,
        price_per_hour=0.05 * cpu * (1 + 0.1 * ratio))
        for i, (cpu, ratio) in enumerate((c, r) for r in (2, 4) for c in range(1, 13))]


def aws_env(pkg, chaos=False):
    aws, ec2api, ssmapi, inject, _, _, _ = AWS[pkg.name]
    ec2 = ec2api.FakeEC2API(ec2api.EC2Behavior(describe_instance_types_output=catalog_infos(pkg)))
    api = inject.ChaosEC2(ec2) if chaos else ec2
    provider = aws.AWSCloudProvider(api, ssmapi.FakeSSMAPI(), cluster_name="window",
                                    cluster_endpoint="https://window", describe_retry_delay=0.0)
    return ec2, provider


def window_pods(pkg, names, seed, n=160):
    """``n`` pods over 8 config_12-like groups: capacity type rotated, one
    zone dropped, a rotating prefix of the names dropped."""
    names = sorted(names)
    groups = [(CAPACITY_TYPES if v % 4 else CAPACITY_TYPES[:1],
               tuple(z for j, z in enumerate(ZONES) if j != v % 3),
               tuple(names[(v * 3) % 8:])) for v in range(8)]
    rng = random.Random(seed)
    wk = pkg.wellknown
    pods = []
    for i in range(n):
        cts, zones, group_names = groups[rng.randrange(len(groups))]
        cpu, mem = rng.choice(SHAPES)
        pods.append(affinity_pod(pkg, f"pod-s{seed}-{i:03d}", cpu, mem, [
            (wk.LABEL_CAPACITY_TYPE, cts), (wk.LABEL_TOPOLOGY_ZONE, zones),
            (wk.LABEL_INSTANCE_TYPE, group_names)]))
    return pods


def make_worker(pkg, provider, kube):
    catalog = provider.get_instance_types(constraints(pkg))
    universe = pkg.universe(catalog)
    universe.provider = dict(PROVIDER_BLOCK)
    provisioner = pkg.Provisioner(
        metadata=pkg.core.ObjectMeta(name="default", namespace="default"),
        spec=pkg.ProvisionerSpec(constraints=universe))
    kube.create(provisioner)
    batcher = pkg.batcher.Batcher(idle_seconds=0.01, max_seconds=5.0,
                                  monitor=quiet_monitor(pkg))
    pipeline_config = pkg.pipeline.PipelineConfig(depth=1, chunk_items=0, adaptive=False)
    if pkg.name == "jax":
        worker = jax_prov.ProvisionerWorker(
            provisioner, kube, provider, batcher=batcher, pipeline_config=pipeline_config,
            solver_config=pkg.solve.SolverConfig(window_backend="ffd", device_min_pods=1))
    else:
        worker = port_prov.ProvisionerWorker(
            provisioner, kube, provider, batcher=batcher, pipeline_config=pipeline_config,
            solver_config=pkg.solve.SolverConfig(window_backend="ffd", device_min_pods=0),
            device="cpu")
    binds = []
    orig_bind = worker._bind
    wk = pkg.wellknown

    def recording_bind(node, node_pods):
        labels = node.metadata.labels
        binds.append((labels[wk.LABEL_INSTANCE_TYPE], labels[wk.LABEL_TOPOLOGY_ZONE],
                      labels[wk.LABEL_CAPACITY_TYPE],
                      tuple(sorted(p.metadata.name for p in node_pods))))
        return orig_bind(node, node_pods)

    worker._bind = recording_bind
    return worker, binds, catalog


def provision(worker, kube, pods):
    """Add the pods not bound yet and run one window on this thread."""
    todo = [p for p in pods if not kube.get("Pod", p.metadata.name,
                                            p.metadata.namespace).spec.node_name]
    for pod in todo:
        assert worker.add(pod, key=(pod.metadata.namespace, pod.metadata.name)) is not None
    worker.provision()
    return len(todo)


def run_window(pkg, seed, draws, chaos=None):
    """The window through ``pkg``'s worker; with ``chaos`` a fault on the
    first CreateFleet and a second window for the pods it left."""
    draws()
    inject = AWS[pkg.name][3]
    ec2, provider = aws_env(pkg, chaos=chaos is not None)
    kube = pkg.kube.KubeCore()
    worker, binds, catalog = make_worker(pkg, provider, kube)
    pods = window_pods(pkg, [it.name for it in catalog], seed)
    for pod in pods:
        kube.create(pod)
    if chaos:
        inject.install(inject.FaultPlan(seed, [inject.FaultSpec(
            "ec2", "create_fleet", chaos, 1)], window=1))
    passes, cuts = [], []
    try:
        passes.append(provision(worker, kube, pods))
        cuts.append(len(binds))
        if chaos:
            passes.append(provision(worker, kube, pods))
        again = provider.get_instance_types(constraints(pkg))
    finally:
        worker.stop()
        inject.uninstall()
    bound = [n for b in binds for n in b[3]]
    assert len(bound) == len(set(bound)), "a pod was bound twice"
    return {"binds": sorted(binds), "passes": passes,
            "retried": sorted(binds[cuts[0]:]),
            "fleets": [dataclasses.asdict(r) for r in ec2.calls["create_fleet"]],
            "unbound": sorted(p.metadata.name for p in kube.list("Pod") if not p.spec.node_name),
            "interned": [a is b for a, b in zip(again, catalog)]}


@pytest.mark.parametrize("seed", SEEDS)
def test_window_over_the_aws_provider_binds_as_the_jax_controller(seed, draws):
    want = run_window(JAX, seed, draws)
    port_solve_mod.reset_executor_counts()
    rebuilds = port_encode.CATALOG_REBUILDS
    got = run_window(PORT, seed, draws)
    assert got == want
    assert got["unbound"] == [] and sum(len(b[3]) for b in got["binds"]) == 160
    assert {b[2] for b in got["binds"]} == set(CAPACITY_TYPES)
    assert all(got["interned"]) and len(got["interned"]) == 24
    assert port_encode.CATALOG_REBUILDS - rebuilds <= 1
    assert set(port_solve_mod.solver_health()["executor_counts"]) <= {"device-batch", "device"}


def test_an_iced_fleet_is_retried_elsewhere_as_the_jax_controller(draws):
    want = run_window(JAX, 1, draws, chaos="ice")
    got = run_window(PORT, 1, draws, chaos="ice")
    assert got == want
    assert got["unbound"] == [] and got["passes"][1] > 0
    first = got["fleets"][0]
    iced = {(o["instance_type"], o["availability_zone"], first["default_target_capacity_type"])
            for c in first["launch_template_configs"] for o in c["overrides"]}
    # no node of the retry took an offering the fault poisoned (the first
    # window's later fleets may: their options were solved before the ICE)
    assert got["retried"] and not {(b[0], b[1], b[2]) for b in got["retried"]} & iced


# -- ChaosEC2 on one launch --------------------------------------------------------

def chaos_launch(pkg, kind, quantity):
    _, ec2api, _, inject, _, _, _ = AWS[pkg.name]
    ec2, provider = aws_env(pkg, chaos=True)
    c = constraints(pkg)
    catalog = provider.get_instance_types(c)
    catalog.sort(key=lambda it: (it.cpu.value(), it.memory.value()))
    plan = inject.FaultPlan(3, [inject.FaultSpec("ec2", "create_fleet", kind, 1)], window=1)
    inject.install(plan)
    bound = []
    try:
        errs = provider.create(c, catalog[:4], quantity, lambda n: bound.append(n) or None)
    finally:
        inject.uninstall()
    after = {it.name: sorted((o.capacity_type, o.zone) for o in it.offerings)
             for it in provider.get_instance_types(c)}
    return {"errs": errs, "fired": sorted(plan.fired_counts().items()),
            "nodes": [(n.metadata.labels[pkg.wellknown.LABEL_INSTANCE_TYPE],
                       n.metadata.labels[pkg.wellknown.LABEL_TOPOLOGY_ZONE],
                       n.metadata.labels[pkg.wellknown.LABEL_CAPACITY_TYPE],
                       n.spec.provider_id) for n in bound],
            "instances": sorted((i.instance_id, i.instance_type, i.availability_zone,
                                 sorted(i.tags.items())) for i in ec2._instances.values()),
            "offerings": after}


@pytest.mark.parametrize("quantity", [1, 3])
@pytest.mark.parametrize("kind", ["ice", "throttle", "partial", "crash-before-bind"])
def test_chaos_ec2_faults_as_the_jax_package(kind, quantity, draws):
    draws()
    want = chaos_launch(JAX, kind, quantity)
    draws()
    got = chaos_launch(PORT, kind, quantity)
    assert got == want
    assert got["fired"] == [(("ec2", "create_fleet", kind), 1)]
    launched = {"ice": 0, "throttle": 0, "partial": quantity - 1,
                "crash-before-bind": quantity}[kind]
    if kind == "partial" and quantity == 1:
        launched = 0
    assert len(got["instances"]) == launched
    assert len(got["nodes"]) == (launched if kind != "crash-before-bind" else 0)


# -- capacity GC of a crash-before-bind leak ----------------------------------------

def gc_leak(pkg):
    _, _, _, inject, clock, gc_mod, registry = AWS[pkg.name]
    ec2, provider = aws_env(pkg, chaos=True)
    kube = pkg.kube.KubeCore()
    gc = gc_mod.GarbageCollection(kube, provider, interval_seconds=0.05, grace_seconds=GRACE)

    def counts():
        return {n: sum(registry.counter(n).collect().values()) for n in GC_COUNTERS}

    before = counts()
    c = constraints(pkg, capacity_types=("on-demand",))
    inject.install(inject.FaultPlan(1, [inject.FaultSpec("ec2", "create_fleet",
                                                         "crash-before-bind", 1)], window=1))
    try:
        errs = provider.create(c, provider.get_instance_types(c)[:2], 1,
                               lambda n: pytest.fail("bind ran despite the crash"))
    finally:
        inject.uninstall()
    records = [dataclasses.astuple(r)[:6] for r in provider.list_instances()]
    young = gc.reconcile("capacity-gc", "")
    spared = sorted(ec2._instances)
    clock.DEFAULT.set(T0 + GRACE + 1)
    old = gc.reconcile("capacity-gc", "")
    after = counts()
    return {"errs": errs, "records": records, "requeue": (young, old), "spared": spared,
            "terminated": list(ec2.terminated), "left": sorted(ec2._instances),
            "counters": {n: after[n] - before[n] for n in GC_COUNTERS}}


def test_gc_reaps_a_crash_before_bind_leak_as_the_jax_package(draws):
    draws()
    want = gc_leak(JAX)
    draws()
    got = gc_leak(PORT)
    assert got == want
    assert len(got["spared"]) == 1 and got["terminated"] == got["spared"]
    assert got["left"] == [] and got["counters"]["gc_instances_terminated_total"] == 1
    assert "injected connection loss after CreateFleet launched" in got["errs"][0]


# -- the EBS CSI zone alias ---------------------------------------------------------

def test_the_ebs_csi_zone_label_normalizes_alike():
    alias = "topology.ebs.csi.aws.com/zone"
    assert port_wk.NORMALIZED_LABELS[alias] == port_wk.LABEL_TOPOLOGY_ZONE
    outs = []
    for pkg in (JAX, PORT):
        assert pkg.wellknown.NORMALIZED_LABELS[alias] == pkg.wellknown.LABEL_TOPOLOGY_ZONE
        pod = affinity_pod(pkg, "ebs", "1", "1Gi", [(alias, ["test-zone-1b"])])
        pod.spec.node_selector = {alias: "test-zone-1b"}
        c = constraints(pkg, capacity_types=(), provider=False)
        tightened = c.tighten(pod)
        outs.append((c.validate_pod(pod),
                     sorted((r.key, r.operator, sorted(r.values))
                            for r in tightened.requirements.items)))
    assert outs[0] == outs[1]
    assert outs[1][0] is None and (port_wk.LABEL_TOPOLOGY_ZONE, "In", ["test-zone-1b"]) in outs[1][1]
