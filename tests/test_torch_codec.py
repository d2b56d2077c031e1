"""The port's wire codecs (api/codec_core.py, api/codec.py) and token bucket
(utils/ratelimit.py) against the JAX package's.

- Every kind ``codec_core`` decodes and encodes, built the same way in both
  packages from one seed, encodes to the same JSON and decodes back to
  equal dataclasses; a second round trip changes nothing.
- ``kubeclient._merge`` keeps the server's unmodeled fields and lets owned
  empties express removal.
- The Provisioner codec round-trips (conditions, resources, the lenient
  timestamps) to the JAX package's manifests.
- ``TokenBucket`` gives the JAX bucket's waits under a pinned clock.
"""

import dataclasses
import json
import random

import pytest

from karpenter_tpu.api import codec as jax_codec
from karpenter_tpu.api import codec_core as jax_cc
from karpenter_tpu.api import constraints as jax_constraints
from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import provisioner as jax_prov
from karpenter_tpu.api import requirements as jax_reqs
from karpenter_tpu.utils import ratelimit as jax_ratelimit
from karpenter_tpu.utils import resources as jax_res
from karpenter_tpu_torch.api import codec as port_codec
from karpenter_tpu_torch.api import codec_core as port_cc
from karpenter_tpu_torch.api import constraints as port_constraints
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import provisioner as port_prov
from karpenter_tpu_torch.api import requirements as port_reqs
from karpenter_tpu_torch.runtime import kubeclient as port_client
from karpenter_tpu_torch.utils import ratelimit as port_ratelimit
from karpenter_tpu_torch.utils import resources as port_res

JAX = dict(core=jax_core, cc=jax_cc, codec=jax_codec, constraints=jax_constraints,
           prov=jax_prov, reqs=jax_reqs, res=jax_res)
PORT = dict(core=port_core, cc=port_cc, codec=port_codec, constraints=port_constraints,
            prov=port_prov, reqs=port_reqs, res=port_res)
KINDS = ["Secret", "Lease", "Pod", "Node", "DaemonSet", "ConfigMap",
         "PersistentVolumeClaim", "PersistentVolume", "StorageClass"]
SEEDS = (0, 1, 2)
T0 = 1_700_000_000.0


def plain(obj):
    """A dataclass tree as plain Python: dataclasses by their fields (the
    per-object caches the marshal attaches are not fields), quantities as
    their strings."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if type(obj).__name__ == "Quantity":
        return str(obj)
    if type(obj).__name__ == "Requirements":
        return plain(obj.items)
    return obj


def meta(c, rng, name, cluster=False):
    return c.ObjectMeta(
        name=name, namespace="" if cluster else rng.choice(["default", "kube-system"]),
        labels={f"l{i}": f"v{rng.randrange(9)}" for i in range(rng.randrange(3))},
        annotations={"a": "b"} if rng.random() < 0.5 else {},
        finalizers=["karpenter.sh/termination"] if rng.random() < 0.5 else [],
        owner_references=[c.OwnerReference(kind=rng.choice(["DaemonSet", "ReplicaSet"]),
                                           name="owner", controller=True,
                                           uid="o-1" if rng.random() < 0.5 else "")]
        if rng.random() < 0.5 else [],
        resource_version=rng.randrange(0, 50), uid=f"u-{rng.randrange(1000)}")


def requirement(c, rng, key=None):
    return c.NodeSelectorRequirement(key=key or rng.choice(["zone", "arch", "type"]),
                                     operator=rng.choice(["In", "NotIn"]),
                                     values=[f"x{rng.randrange(5)}" for _ in range(2)])


def pod_spec(c, rng):
    na = c.NodeAffinity(
        required=[c.NodeSelectorTerm(match_expressions=[requirement(c, rng)])],
        preferred=[c.PreferredSchedulingTerm(weight=rng.randrange(1, 100),
                                             preference=c.NodeSelectorTerm(
                                                 match_expressions=[requirement(c, rng)]))])
    return c.PodSpec(
        node_name=rng.choice(["", "node-a"]),
        node_selector={"zone": "x1"} if rng.random() < 0.5 else {},
        containers=[c.Container(name=f"c{i}", image=rng.choice(["", "img"]),
                                resources=c.ResourceRequirements.make(
                                    requests={"cpu": f"{rng.randrange(1, 8) * 250}m",
                                              "memory": f"{rng.randrange(1, 9) * 64}Mi"},
                                    limits={"cpu": "4"} if rng.random() < 0.5 else {}))
                    for i in range(rng.randrange(1, 3))],
        tolerations=[c.Toleration(key="dedicated", operator=rng.choice(["Equal", "Exists"]),
                                  value=rng.choice(["", "ml"]),
                                  effect=rng.choice(["", "NoSchedule"]))],
        affinity=c.Affinity(node_affinity=na) if rng.random() < 0.7 else None,
        topology_spread_constraints=[c.TopologySpreadConstraint(
            max_skew=rng.randrange(1, 3), topology_key="zone",
            label_selector=c.LabelSelector(match_labels={"app": "web"}))]
        if rng.random() < 0.5 else [],
        volumes=[c.Volume(name="data", persistent_volume_claim=c.PersistentVolumeClaimVolumeSource(
            claim_name="claim"))] if rng.random() < 0.5 else [],
        priority_class_name=rng.choice(["", "high"]), priority=rng.choice([0, 1000]),
        termination_grace_period_seconds=rng.choice([0, 30, 300]))


def build(pkg, kind, seed):
    """One object of ``kind`` drawn from ``seed`` with the package's types."""
    c = pkg["core"]
    rng = random.Random(f"{kind}-{seed}")
    name = f"{kind.lower()}-{seed}"
    if kind == "Secret":
        return c.Secret(metadata=meta(c, rng, name), data={"tls.crt": "QUJD"},
                        type=rng.choice(["Opaque", "kubernetes.io/tls"]))
    if kind == "Lease":
        return c.Lease(metadata=meta(c, rng, name), spec=c.LeaseSpec(
            holder_identity=rng.choice(["", "a"]), lease_duration_seconds=rng.choice([15, 30]),
            acquire_time=rng.choice([None, T0]), renew_time=rng.choice([None, T0 + 7])))
    if kind == "Pod":
        return c.Pod(metadata=meta(c, rng, name), spec=pod_spec(c, rng), status=c.PodStatus(
            phase=rng.choice(["Pending", "Running"]),
            conditions=[c.PodCondition(type="PodScheduled", status="False",
                                       reason=rng.choice(["", "Unschedulable"]))]))
    if kind == "Node":
        return c.Node(
            metadata=meta(c, rng, name, cluster=True),
            spec=c.NodeSpec(taints=[c.Taint(key="karpenter.sh/not-ready", value=rng.choice(
                ["", "x"]), effect="NoSchedule")] if rng.random() < 0.5 else [],
                unschedulable=rng.random() < 0.5, provider_id=rng.choice(["", "fake://i-1"])),
            status=c.NodeStatus(
                capacity=pkg["res"].parse_resource_list({"cpu": "8", "memory": "32Gi",
                                                         "pods": "110"}),
                allocatable=pkg["res"].parse_resource_list({"cpu": "7900m"}),
                conditions=[c.NodeCondition(type="Ready", status=rng.choice(["True", "False"]),
                                            reason=rng.choice(["", "KubeletReady"]),
                                            last_heartbeat_time=rng.choice([None, T0]))]))
    if kind == "DaemonSet":
        return c.DaemonSet(metadata=meta(c, rng, name), spec=c.DaemonSetSpec(
            template=c.PodTemplateSpec(metadata=meta(c, rng, "tpl"), spec=pod_spec(c, rng))))
    if kind == "ConfigMap":
        return c.ConfigMap(metadata=meta(c, rng, name),
                           data={"loglevel": rng.choice(["info", "debug"])})
    if kind == "PersistentVolumeClaim":
        return c.PersistentVolumeClaim(metadata=meta(c, rng, name),
                                       spec=c.PersistentVolumeClaimSpec(
                                           storage_class_name=rng.choice([None, "", "gp3"]),
                                           volume_name=rng.choice(["", "pv-1"])))
    if kind == "PersistentVolume":
        return c.PersistentVolume(metadata=meta(c, rng, name, cluster=True),
                                  spec=c.PersistentVolumeSpec(node_affinity=c.VolumeNodeAffinity(
                                      required=[c.NodeSelectorTerm(
                                          match_expressions=[requirement(c, rng, "zone")])])
                                      if rng.random() < 0.7 else None))
    assert kind == "StorageClass"
    return c.StorageClass(metadata=meta(c, rng, name, cluster=True), allowed_topologies=[
        c.TopologySelectorTerm(match_label_expressions=[c.NodeSelectorRequirement(
            key="zone", operator="In", values=["x1", "x2"])])])


def encoded(pkg, obj) -> str:
    return json.dumps(pkg["cc"].encode_obj(obj), sort_keys=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_encodes_and_decodes_as_the_jax_codec(kind, seed):
    jobj, pobj = build(JAX, kind, seed), build(PORT, kind, seed)
    assert plain(pobj) == plain(jobj)
    wire = encoded(PORT, pobj)
    assert wire == encoded(JAX, jobj)
    jback = jax_cc.decode(kind, json.loads(wire))
    pback = port_cc.decode(kind, json.loads(wire))
    assert plain(pback) == plain(jback)
    assert encoded(PORT, pback) == wire  # a second round trip changes nothing


def test_merge_keeps_unmodeled_server_fields():
    raw = {
        "metadata": {"name": "nx", "finalizers": ["karpenter.sh/termination"],
                     "managedFields": [{"manager": "kubelet"}]},
        "spec": {"podCIDR": "10.1.0.0/24", "taints": [{"key": "old", "effect": "NoSchedule"}]},
        "status": {"nodeInfo": {"kubeletVersion": "v1.29"}},
    }
    node = port_core.Node(metadata=port_core.ObjectMeta(name="nx", namespace=""))
    merged = port_client._merge(raw, port_cc.node_to(node))
    assert merged["spec"]["podCIDR"] == "10.1.0.0/24"
    assert merged["metadata"]["managedFields"]
    assert merged["status"]["nodeInfo"]["kubeletVersion"] == "v1.29"
    assert merged["metadata"]["finalizers"] == []     # owned empty: removed
    assert merged["spec"]["taints"] == []             # owned: replaced
    from karpenter_tpu.runtime.kubeclient import _merge as jax_merge

    assert merged == jax_merge(raw, jax_cc.node_to(jax_core.Node(
        metadata=jax_core.ObjectMeta(name="nx", namespace=""))))


def test_grace_zero_round_trips():
    obj = {"metadata": {"name": "fast"},
           "spec": {"terminationGracePeriodSeconds": 0,
                    "containers": [{"name": "app", "resources": {}}]}}
    p = port_cc.pod_from(obj)
    assert p.spec.termination_grace_period_seconds == 0
    assert port_cc.pod_to(p)["spec"]["terminationGracePeriodSeconds"] == 0
    p300 = port_cc.pod_from({"metadata": {"name": "slow"},
                             "spec": {"terminationGracePeriodSeconds": 300}})
    assert port_cc.pod_from(port_cc.pod_to(p300)).spec.termination_grace_period_seconds == 300


# -- the Provisioner CRD codec -------------------------------------------------------

MANIFEST = {
    "apiVersion": "karpenter.sh/v1alpha5",
    "kind": "Provisioner",
    "metadata": {"name": "default"},
    "spec": {
        "labels": {"team": "ml"},
        "taints": [{"key": "dedicated", "value": "ml", "effect": "NoSchedule"}],
        "requirements": [{"key": "topology.kubernetes.io/zone", "operator": "In",
                          "values": ["us-west-2a", "us-west-2b"]}],
        "kubeletConfiguration": {"clusterDNS": ["10.0.0.10"]},
        "provider": {"instanceProfile": "karpenter-node"},
        "ttlSecondsAfterEmpty": 30,
        "ttlSecondsUntilExpired": 2592000,
        "limits": {"resources": {"cpu": "1000", "memory": "1000Gi"}},
        "consolidation": {"enabled": True},
    },
}


def provisioner(pkg, seed):
    """A Provisioner drawn from ``seed``: conditions, resources, scale time."""
    rng = random.Random(seed)
    c, prov = pkg["core"], pkg["prov"]
    p = prov.Provisioner(metadata=c.ObjectMeta(name=f"p{seed}", namespace=rng.choice(
        ["default", "team"]), uid=f"u{seed}", labels={"a": "b"} if seed % 2 else {}))
    p.spec.ttl_seconds_after_empty = rng.choice([None, 0, 30])
    p.spec.consolidation_enabled = rng.random() < 0.5
    p.spec.constraints.requirements = pkg["reqs"].Requirements([c.NodeSelectorRequirement(
        key="karpenter.sh/capacity-type", operator="In", values=["spot", "on-demand"])])
    p.spec.constraints.taints = pkg["constraints"].Taints(
        [c.Taint(key="gpu", value="", effect="NoSchedule")] if seed % 2 else [])
    p.status.resources = pkg["res"].parse_resource_list({"cpu": f"{seed + 1}", "memory": "4Gi"})
    for i in range(rng.randrange(3)):
        prov.set_condition(p.status.conditions, f"C{i}", rng.choice(["True", "False"]),
                           "Reason", rng.choice(["", "msg"]), now=T0 + i)
    p.status.last_scale_time = rng.choice([None, T0 + 60])
    return p


@pytest.mark.parametrize("seed", range(6))
def test_provisioner_manifests_equal_the_jax_codec(seed):
    jm = jax_codec.provisioner_to_manifest(provisioner(JAX, seed))
    pm = port_codec.provisioner_to_manifest(provisioner(PORT, seed))
    assert json.dumps(pm, sort_keys=True) == json.dumps(jm, sort_keys=True)
    back = port_codec.provisioner_from_manifest(pm)
    assert plain(back) == plain(jax_codec.provisioner_from_manifest(jm))
    assert port_codec.provisioner_to_manifest(back) == pm


def test_provisioner_manifest_round_trips():
    p = port_codec.provisioner_from_manifest(MANIFEST)
    assert p.spec.constraints.provider == {"instanceProfile": "karpenter-node"}
    assert p.spec.constraints.kubelet_configuration.cluster_dns == ["10.0.0.10"]
    assert str(p.spec.limits.resources["cpu"]) == "1000"
    assert port_codec.provisioner_to_manifest(p) == {
        **MANIFEST, "status": {"conditions": [], "resources": {}}}
    assert plain(p) == plain(jax_codec.provisioner_from_manifest(MANIFEST))
    bare = port_codec.provisioner_from_manifest({"metadata": {"name": "bare"}})
    assert bare.spec.constraints.provider is None and bare.spec.limits.resources is None
    assert port_codec.provisioner_to_manifest(bare)["spec"] == {}


def test_status_conditions_and_resources_survive_the_wire_encode():
    p = port_prov.Provisioner()
    p.metadata.name = "wire"
    p.status.resources = port_res.parse_resource_list({"cpu": "16", "memory": "64Gi"})
    port_prov.set_condition(p.status.conditions, "Active", "True", "WorkerRunning", now=T0)
    st = port_client._encode(p)["status"]
    assert st["resources"] == {"cpu": "16", "memory": "64Gi"}
    assert st["conditions"][0]["type"] == "Active"
    assert st["conditions"][0]["lastTransitionTime"].endswith("Z")


@pytest.mark.parametrize("stamp", [1234, "garbage", "2023-11-14T22:13:20.5Z", None])
def test_malformed_last_transition_time_decodes_leniently(stamp):
    m = {"apiVersion": "karpenter.sh/v1alpha5", "kind": "Provisioner",
         "metadata": {"name": "x"},
         "status": {"conditions": [{"type": "Active", "status": "True",
                                    "lastTransitionTime": stamp}],
                    "lastScaleTime": stamp}}
    got = port_codec.provisioner_from_manifest(m)  # must not raise (the webhook path)
    want = jax_codec.provisioner_from_manifest(m)
    assert got.status.conditions[0].last_transition_time == \
        want.status.conditions[0].last_transition_time
    assert got.status.last_scale_time == want.status.last_scale_time
    if stamp in (1234, "garbage"):
        assert got.status.conditions[0].last_transition_time is None


# -- the token bucket ----------------------------------------------------------------

class FakeTime:
    def __init__(self):
        self.t = 0.0
        self.slept = []

    def now(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def bucket_trace(mod, seed):
    """A seeded script of acquire / try_acquire / idle gaps: what each call
    returned and every sleep the bucket asked for. Rates are powers of two
    and gaps eighths of a second, so the clock's arithmetic is exact (a
    wait that rounds to no progress on the pinned clock never ends)."""
    rng = random.Random(seed)
    ft = FakeTime()
    burst = rng.choice([1, 3, 300])
    b = mod.TokenBucket(qps=rng.choice([2, 8, 256]), burst=burst,
                        timefunc=ft.now, sleepfunc=ft.sleep)
    out = []
    for _ in range(400):
        op = rng.random()
        if op < 0.6:
            # never more tokens than the burst holds: such a wait never ends
            n = rng.choice([1.0, 1.0, 2.0]) if burst > 1 else 1.0
            out.append(("acquire", round(b.acquire(n), 12)))
        elif op < 0.8:
            out.append(("try", b.try_acquire()))
        else:
            ft.t += rng.randrange(16) / 8
    return out, [round(s, 12) for s in ft.slept]


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_waits_as_the_jax_bucket(seed):
    assert bucket_trace(port_ratelimit, seed) == bucket_trace(jax_ratelimit, seed)


def test_token_bucket_burst_then_qps():
    ft = FakeTime()
    b = port_ratelimit.TokenBucket(qps=2, burst=3, timefunc=ft.now, sleepfunc=ft.sleep)
    assert [b.acquire() for _ in range(3)] == [0.0] * 3
    assert abs(b.acquire() - 0.5) < 1e-9
    ft.t += 100.0  # a long idle refills to the burst, not qps × idle
    assert [b.try_acquire() for _ in range(4)] == [True, True, True, False]
