"""The port's counter and PVC controllers and volume topology against the
JAX package's, on the CPU.

- **Counter.** The same nodes give the same ``Provisioner.status.resources``;
  with a cpu limit at the counted capacity, the worker's next launch is
  refused with the same error in both packages and nothing is created;
  without the counter the same limit never binds.
- **Volume topology and PVC.** A pod mounting a claim, through the
  selection controller and one worker window: the claim's storage class's
  allowed topology (or its bound volume's node affinity) becomes the pod's
  required zone, the pod binds in that zone, and the PVC controller stamps
  the claim with the pod's node. A claim that does not exist keeps the pod
  out of every window. Same nodes, zones and annotations in both packages
  (same node names: each fake provider's counter from 0). Exact.
"""

import itertools
from types import SimpleNamespace

import pytest

from karpenter_tpu import pressure as jax_pressure
from karpenter_tpu.api import constraints as jax_constraints
from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wk
from karpenter_tpu.api.provisioner import Provisioner as JaxProvisioner
from karpenter_tpu.api.provisioner import ProvisionerSpec as JaxProvisionerSpec
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.controllers import counter as jax_counter
from karpenter_tpu.controllers import provisioning as jax_prov
from karpenter_tpu.controllers import pvc as jax_pvc
from karpenter_tpu.controllers import selection as jax_selection
from karpenter_tpu.runtime import kubecore as jax_kube
from karpenter_tpu.scheduling import batcher as jax_batcher
from karpenter_tpu.utils import resources as jax_resources
from karpenter_tpu_torch import pressure as port_pressure
from karpenter_tpu_torch.api import constraints as port_constraints
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wk
from karpenter_tpu_torch.api.provisioner import Provisioner as PortProvisioner
from karpenter_tpu_torch.api.provisioner import ProvisionerSpec as PortProvisionerSpec
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.controllers import counter as port_counter
from karpenter_tpu_torch.controllers import provisioning as port_prov
from karpenter_tpu_torch.controllers import pvc as port_pvc
from karpenter_tpu_torch.controllers import selection as port_selection
from karpenter_tpu_torch.runtime import kubecore as port_kube
from karpenter_tpu_torch.scheduling import batcher as port_batcher
from karpenter_tpu_torch.solver import solve as port_solve
from karpenter_tpu_torch.utils import resources as port_resources

JAX = SimpleNamespace(
    name="jax", core=jax_core, wk=jax_wk, constraints=jax_constraints, fake=jax_fake,
    counter=jax_counter, prov=jax_prov, pvc=jax_pvc, selection=jax_selection, kube=jax_kube,
    batcher=jax_batcher, resources=jax_resources, pressure=jax_pressure,
    Provisioner=JaxProvisioner, ProvisionerSpec=JaxProvisionerSpec,
    universe=jax_prov.universe_constraints)
PORT = SimpleNamespace(
    name="port", core=port_core, wk=port_wk, constraints=port_constraints, fake=port_fake,
    counter=port_counter, prov=port_prov, pvc=port_pvc, selection=port_selection,
    kube=port_kube, batcher=port_batcher, resources=port_resources, pressure=port_pressure,
    Provisioner=PortProvisioner, ProvisionerSpec=PortProvisionerSpec,
    universe=port_solve.universe_constraints)


@pytest.fixture(autouse=True)
def quiet_monitors():
    jax_pressure.set_monitor(jax_pressure.PressureMonitor(
        jax_pressure.PressureConfig(rss_watermark_bytes=0), breaker_fn=lambda: False))
    port_pressure.set_monitor(port_pressure.PressureMonitor(
        port_pressure.PressureConfig(rss_watermark_bytes=0)))
    yield
    jax_pressure.set_monitor(None)
    port_pressure.set_monitor(None)


def setup(pkg, monkeypatch, limits=None):
    """An API server with one provisioner over instance_types(4) (all
    zones), a fake provider and a worker (never started)."""
    monkeypatch.setattr(pkg.fake, "_name_counter", itertools.count())
    kube = pkg.kube.KubeCore()
    provider = pkg.fake.FakeCloudProvider(catalog=pkg.fake.instance_types(4))
    spec = pkg.ProvisionerSpec(constraints=pkg.universe(provider.catalog))
    if limits is not None:
        spec.limits = pkg.constraints.Limits(
            resources=pkg.resources.parse_resource_list(limits))
    prov = pkg.Provisioner(metadata=pkg.core.ObjectMeta(name="default", namespace="default"),
                           spec=spec)
    kube.create(prov)
    kw = {"device": "cpu"} if pkg.name == "port" else {}
    worker = pkg.prov.ProvisionerWorker(
        prov, kube, provider, batcher=pkg.batcher.Batcher(idle_seconds=0.02, max_seconds=0.2),
        **kw)
    return SimpleNamespace(kube=kube, provider=provider, prov=prov, worker=worker)


def pod(pkg, name, cpu="1", volumes=()):
    c = pkg.core
    return c.Pod(
        metadata=c.ObjectMeta(name=name, namespace="default", uid=f"uid-{name}"),
        spec=c.PodSpec(
            containers=[c.Container(resources=c.ResourceRequirements.make(
                requests={"cpu": cpu, "memory": "256Mi"}))],
            volumes=[c.Volume(name=v, persistent_volume_claim=
                              c.PersistentVolumeClaimVolumeSource(claim_name=v))
                     for v in volumes]),
        status=c.PodStatus(phase="Pending", conditions=[c.PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable")]))


def node(pkg, name, cpu, provisioner="default"):
    c, wk = pkg.core, pkg.wk
    caps = pkg.resources.parse_resource_list({"cpu": cpu, "memory": "8Gi"})
    return c.Node(metadata=c.ObjectMeta(name=name, namespace="", labels={
        wk.PROVISIONER_NAME_LABEL: provisioner}),
        status=c.NodeStatus(capacity=caps, allocatable=dict(caps)))


def provision(pkg, env, pods):
    for p in pods:
        env.kube.create(p)
        env.worker.add(p, key=(p.metadata.namespace, p.metadata.name))
    env.worker.provision()
    return sorted((p.metadata.name, p.spec.node_name) for p in env.kube.list("Pod"))


# -- the counter -----------------------------------------------------------------------

def counter_run(pkg, monkeypatch, count):
    env = setup(pkg, monkeypatch, limits={"cpu": "6"})
    for name, cpu, owner in (("n1", "4", "default"), ("n2", "2", "default"),
                             ("other", "16", "other")):
        env.kube.create(node(pkg, name, cpu, owner))
    counter = pkg.counter.CounterController(env.kube)
    if count:
        assert counter.reconcile("default") is None
    resources = {k: str(v) for k, v in
                 env.kube.get("Provisioner", "default").status.resources.items()}
    errors = []
    launch = env.worker._launch

    def recording_launch(constraints, packing):
        err = launch(constraints, packing)
        errors.append(err)
        return err

    env.worker._launch = recording_launch
    bound = provision(pkg, env, [pod(pkg, "limited-0"), pod(pkg, "limited-1")])
    return {"resources": resources, "errors": errors, "bound": bound,
            "nodes": sorted(n.metadata.name for n in env.kube.list("Node")),
            "wiring": (counter.kind(), [m[0] for m in counter.mappings()],
                       counter.mappings()[0][1](env.kube.get("Node", "n1", "")))}


@pytest.mark.parametrize("count", [True, False])
def test_counter_limits_equal_the_jax_package(count, monkeypatch):
    j = counter_run(JAX, monkeypatch, count)
    p = counter_run(PORT, monkeypatch, count)
    assert p == j
    if count:
        assert p["resources"] == {"cpu": "6", "memory": str(16 * 1024 ** 3)}
        assert p["errors"] and all("exceeds limit" in e for e in p["errors"])
        assert all(not n for _, n in p["bound"]) and p["nodes"] == ["n1", "n2", "other"]
    else:
        assert p["resources"] == {}
        assert all(e is None for e in p["errors"]) and all(n for _, n in p["bound"])
    assert p["wiring"] == ("Provisioner", ["Node"], [("default", "default")])


def test_counter_without_provisioner_is_noop():
    for pkg in (JAX, PORT):
        assert pkg.counter.CounterController(pkg.kube.KubeCore()).reconcile("gone") is None


# -- volume topology and the PVC controller ---------------------------------------------

def volume_objects(pkg, path):
    c, wk = pkg.core, pkg.wk
    zone_req = c.NodeSelectorRequirement(key=wk.LABEL_TOPOLOGY_ZONE, operator="In",
                                         values=["test-zone-2"])
    if path == "storage-class":
        return [c.StorageClass(metadata=c.ObjectMeta(name="zonal"), allowed_topologies=[
                    c.TopologySelectorTerm(match_label_expressions=[zone_req])]),
                c.PersistentVolumeClaim(metadata=c.ObjectMeta(name="data"),
                                        spec=c.PersistentVolumeClaimSpec(
                                            storage_class_name="zonal"))]
    if path == "bound-volume":
        return [c.PersistentVolume(metadata=c.ObjectMeta(name="pv-1"), spec=c.PersistentVolumeSpec(
                    node_affinity=c.VolumeNodeAffinity(required=[c.NodeSelectorTerm(
                        match_expressions=[zone_req])]))),
                c.PersistentVolumeClaim(metadata=c.ObjectMeta(name="data"),
                                        spec=c.PersistentVolumeClaimSpec(volume_name="pv-1"))]
    return []  # "missing-claim"


def pvc_run(pkg, monkeypatch, path):
    env = setup(pkg, monkeypatch)
    for obj in volume_objects(pkg, path):
        env.kube.create(obj)
    p = pod(pkg, "db-0", volumes=["data"])
    env.kube.create(p)
    provisioning = SimpleNamespace(workers={"default": env.worker},
                                   targets=lambda: [(env.prov, env.worker)])
    selection = pkg.selection.SelectionController(env.kube, provisioning)
    selection.reconcile("db-0", "default")
    queued = env.worker.pending(("default", "db-0"))
    if queued:
        env.worker.provision()
    live = env.kube.get("Pod", "db-0")
    node_name = live.spec.node_name
    zone = (env.kube.get("Node", node_name, "").metadata.labels[pkg.wk.LABEL_TOPOLOGY_ZONE]
            if node_name else None)
    annotation = None
    if path != "missing-claim":
        assert pkg.pvc.PVCController(env.kube).reconcile("data", "default") is None
        annotation = env.kube.get("PersistentVolumeClaim", "data").metadata.annotations.get(
            pkg.pvc.SELECTED_NODE_ANNOTATION)
    return {"queued": queued, "node": node_name, "zone": zone, "annotation": annotation,
            "wiring": (pkg.pvc.PVCController(env.kube).kind(),
                       pkg.pvc.PVCController(env.kube).mappings()[0][1](live))}


@pytest.mark.parametrize("path", ["storage-class", "bound-volume", "missing-claim"])
def test_volume_topology_and_pvc_equal_the_jax_package(path, monkeypatch):
    j = pvc_run(JAX, monkeypatch, path)
    p = pvc_run(PORT, monkeypatch, path)
    assert p == j
    if path == "missing-claim":
        assert not p["queued"] and p["node"] == ""
    else:
        assert p["queued"] and p["zone"] == "test-zone-2"
        assert p["annotation"] == p["node"]
    assert p["wiring"] == ("PersistentVolumeClaim", [("data", "default")])


def test_pvc_ignores_an_unscheduled_pod():
    for pkg in (JAX, PORT):
        kube = pkg.kube.KubeCore()
        kube.create(pkg.core.PersistentVolumeClaim(metadata=pkg.core.ObjectMeta(name="data")))
        kube.create(pod(pkg, "p1", volumes=["data"]))
        pkg.pvc.PVCController(kube).reconcile("data")
        assert pkg.pvc.SELECTED_NODE_ANNOTATION not in kube.get(
            "PersistentVolumeClaim", "data").metadata.annotations
        assert pkg.pvc.PVCController(kube).reconcile("gone") is None
