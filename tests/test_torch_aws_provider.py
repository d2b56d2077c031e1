"""The port's AWS cloud provider against the JAX package's, on the CPU.

The scenarios of the JAX package's suite (tests/test_aws_provider.py), each
run in both packages on their own fakes (``FakeEC2API`` / ``FakeSSMAPI``)
with the fakes' id counters from 1 and one seeded ``uuid.uuid4`` for the
launch nonces:

- the catalog field for field (the default catalog and a seeded 120-type
  one, ENI-limited pod density on and off), its 5-minute cache, the
  overhead ladder and the ENI pod formula;
- the CreateFleet requests with their tags (and a journal's pre-assigned
  nonce), the launch templates (names, user-data bytes, tags), the SSM
  queries and the Nodes made, over capacity-type, zone, label, taint and
  template variants;
- the ICE cache: poisoning, its 45-second expiry, total ICE's errors;
- termination and its NotFound, ``list_instances`` records;
- the vendor block: ``validate()`` strings, defaulting, the codec,
  ``merge_tags``, the provider's hooks, subnet selectors and their errors;
- interning: the same objects between discoveries, an ICE breaks only the
  poisoned type's identity, and the port's ``build_packables_versioned``
  hits on a re-discovered catalog.

Every comparison is exact.
"""

import base64
import dataclasses
import itertools
import random
import uuid
from types import SimpleNamespace

import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wk
from karpenter_tpu.api.constraints import Constraints as JaxConstraints
from karpenter_tpu.api.constraints import Taints as JaxTaints
from karpenter_tpu.api.requirements import Requirements as JaxRequirements
from karpenter_tpu.cloudprovider.aws import instancetype as jax_itype
from karpenter_tpu.cloudprovider.aws import instancetypes as jax_itypes
from karpenter_tpu.cloudprovider.aws import launchtemplate as jax_lt
from karpenter_tpu.cloudprovider.aws import provider as jax_aws
from karpenter_tpu.cloudprovider.aws import sdk as jax_sdk
from karpenter_tpu.cloudprovider.aws import vendor as jax_vendor
from karpenter_tpu.cloudprovider.aws.fake import ec2api as jax_ec2api
from karpenter_tpu.cloudprovider.aws.fake import ssmapi as jax_ssmapi
from karpenter_tpu.runtime import journal as jax_journal
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wk
from karpenter_tpu_torch.api.constraints import Constraints as PortConstraints
from karpenter_tpu_torch.api.constraints import Taints as PortTaints
from karpenter_tpu_torch.api.requirements import Requirements as PortRequirements
from karpenter_tpu_torch.cloudprovider.aws import instancetype as port_itype
from karpenter_tpu_torch.cloudprovider.aws import instancetypes as port_itypes
from karpenter_tpu_torch.cloudprovider.aws import launchtemplate as port_lt
from karpenter_tpu_torch.cloudprovider.aws import provider as port_aws
from karpenter_tpu_torch.cloudprovider.aws import sdk as port_sdk
from karpenter_tpu_torch.cloudprovider.aws import vendor as port_vendor
from karpenter_tpu_torch.cloudprovider.aws.fake import ec2api as port_ec2api
from karpenter_tpu_torch.cloudprovider.aws.fake import ssmapi as port_ssmapi
from karpenter_tpu_torch.runtime import journal as port_journal
from karpenter_tpu_torch.solver import adapter as port_adapter
from karpenter_tpu_torch.utils import clock as port_clock

JAX = SimpleNamespace(
    name="jax", core=jax_core, wk=jax_wk, Constraints=JaxConstraints, Taints=JaxTaints,
    Requirements=JaxRequirements, itype=jax_itype, itypes=jax_itypes, lt=jax_lt, aws=jax_aws,
    sdk=jax_sdk, vendor=jax_vendor, ec2api=jax_ec2api, ssmapi=jax_ssmapi,
    journal=jax_journal, clock=jax_clock)
PORT = SimpleNamespace(
    name="port", core=port_core, wk=port_wk, Constraints=PortConstraints, Taints=PortTaints,
    Requirements=PortRequirements, itype=port_itype, itypes=port_itypes, lt=port_lt,
    aws=port_aws, sdk=port_sdk, vendor=port_vendor, ec2api=port_ec2api,
    ssmapi=port_ssmapi, journal=port_journal, clock=port_clock)
ZONES = ["test-zone-1a", "test-zone-1b", "test-zone-1c"]
T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both fakes' id counters from 1, both clocks at T0 (reset after)."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.ec2api, "_counter", itertools.count(1))
        pkg.clock.DEFAULT.set(T0)
    yield
    for pkg in (JAX, PORT):
        pkg.clock.DEFAULT.reset()


def constraints(pkg, capacity_types=("on-demand", "spot"), zones=ZONES, **overrides):
    c = pkg.Constraints(
        labels={pkg.wk.PROVISIONER_NAME_LABEL: "default"},
        requirements=pkg.Requirements([
            pkg.core.NodeSelectorRequirement(key=pkg.wk.LABEL_TOPOLOGY_ZONE, operator="In",
                                             values=list(zones)),
            pkg.core.NodeSelectorRequirement(key=pkg.wk.LABEL_CAPACITY_TYPE, operator="In",
                                             values=list(capacity_types))]),
        provider={"instanceProfile": "test-instance-profile",
                  "subnetSelector": {"Name": "*"}, "securityGroupSelector": {"Name": "*"}})
    for k, v in overrides.items():
        setattr(c, k, v)
    return c


def infos(pkg, n=120, seed=3):
    """A seeded catalog in ``pkg``'s shapes: families that pass and fail the
    filter, GPUs, accelerators, pod-ENI trunking, both architectures."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        fam = rng.choice(["m5", "c6g", "r5", "t3", "p3", "inf1", "g4", "x1", "i3", "a1"])
        info = pkg.sdk.InstanceTypeInfo(
            instance_type=f"{fam}.{i}xl", vcpus=rng.choice([1, 2, 4, 8, 16, 32, 48, 96]),
            memory_mib=rng.choice([512, 2048, 8192, 65536, 249856]),
            maximum_network_interfaces=rng.randint(1, 15),
            ipv4_addresses_per_interface=rng.randint(2, 50),
            supported_architectures=["arm64"] if fam in ("c6g", "a1") else ["x86_64"],
            supported_usage_classes=rng.choice([["on-demand"], ["on-demand", "spot"]]),
            bare_metal=rng.random() < 0.05, fpga=rng.random() < 0.05,
            pod_eni_trunking_compatible=rng.random() < 0.5,
            pod_eni_branch_interfaces=rng.randint(0, 54),
            inference_accelerator_count=rng.randint(1, 16) if fam == "inf1" else 0,
            price_per_hour=round(rng.uniform(0.01, 30.0), 4))
        if fam in ("p3", "g4"):
            info.gpus = [pkg.sdk.GPUInfo(rng.choice(["NVIDIA", "AMD"]), rng.randint(1, 8))
                         for _ in range(rng.randint(1, 2))]
        out.append(info)
    return out


def env(pkg, catalog=None, **kwargs):
    ec2 = pkg.ec2api.FakeEC2API(pkg.ec2api.EC2Behavior(describe_instance_types_output=catalog))
    ssm = pkg.ssmapi.FakeSSMAPI()
    provider = pkg.aws.AWSCloudProvider(ec2, ssm, cluster_name="test-cluster",
                                        cluster_endpoint="https://test-cluster",
                                        describe_retry_delay=0.0, **kwargs)
    return ec2, ssm, provider


def plain_type(it):
    return (it.name, [(o.capacity_type, o.zone, o.interruption_rate) for o in it.offerings],
            it.architecture, sorted(it.operating_systems),
            [q.nano for q in (it.cpu, it.memory, it.pods, it.nvidia_gpus, it.amd_gpus,
                              it.aws_neurons, it.aws_pod_eni)],
            sorted((k, v.nano) for k, v in it.overhead.items()), it.price)


def plain_node(node):
    return (node.metadata.name, node.metadata.namespace, dict(node.metadata.labels),
            node.spec.provider_id,
            sorted((k, v.nano) for k, v in node.status.capacity.items()),
            sorted((k, v.nano) for k, v in node.status.allocatable.items()))


def both(fn, *args, **kwargs):
    """``fn`` in each package, each with the same seeded uuid4 draws."""
    out, real = [], uuid.uuid4
    try:
        for pkg in (JAX, PORT):
            rng = random.Random(11)
            uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
            out.append(fn(pkg, *args, **kwargs))
    finally:
        uuid.uuid4 = real
    return out


# -- the catalog -------------------------------------------------------------------

@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("eni_density", [True, False])
def test_catalog_field_for_field(seeded, eni_density):
    def catalog(pkg):
        _, _, provider = env(pkg, infos(pkg) if seeded else None,
                             eni_limited_pod_density=eni_density)
        return [plain_type(it) for it in provider.get_instance_types(constraints(pkg))]

    want, got = both(catalog)
    assert got == want and got


def test_catalog_is_cached_for_five_minutes():
    def run(pkg):
        ec2, _, provider = env(pkg)
        counts = []
        for step in (0, 299, 2, 300):
            pkg.clock.DEFAULT.set(pkg.clock.now() + step)
            provider.get_instance_types(constraints(pkg))
            counts.append((len(ec2.calls["describe_instance_types"]),
                           len(ec2.calls["describe_instance_type_offerings"]),
                           len(ec2.calls["describe_subnets"])))
        return counts

    want, got = both(run)
    assert got == want == [(1, 1, 1), (1, 1, 2), (2, 2, 2), (3, 3, 3)]


def test_overhead_and_pod_formulas_equal_the_jax_package():
    for vcpus in list(range(0, 130)) + [192, 448]:
        assert port_itype.overhead_cpu_milli(vcpus) == jax_itype.overhead_cpu_milli(vcpus)
    for p, j in zip(infos(PORT, 60, 9), infos(JAX, 60, 9)):
        assert port_itype.eni_limited_pods(p) == jax_itype.eni_limited_pods(j)
        assert port_itype.overhead_memory_mib(p) == jax_itype.overhead_memory_mib(j)
        assert port_itype.memory_mib(p) == jax_itype.memory_mib(j)
        assert port_itype.architecture(p) == jax_itype.architecture(j)
        for m in ("NVIDIA", "AMD"):
            assert port_itype.gpu_count(p, m) == jax_itype.gpu_count(j, m)


# -- launches ----------------------------------------------------------------------

CREATE_CASES = {
    "both": {},
    "spot": {"capacity_types": ("spot",)},
    "on-demand": {"capacity_types": ("on-demand",)},
    "one-zone": {"capacity_types": ("on-demand",), "zones": ("test-zone-1b",)},
    "labels-taints": {"labels": True},
    "template": {"template": True},
    "dense": {"eni_density": False, "quantity": 3},
}


def create(pkg, case, journal_nonce=None):
    """Launch from the (smallest-first) catalog; the fakes' calls, the
    templates, the SSM queries, the Nodes and the SPI's errors."""
    spec = CREATE_CASES[case]
    ec2, ssm, provider = env(pkg, eni_limited_pod_density=spec.get("eni_density", True))
    c = constraints(pkg, capacity_types=spec.get("capacity_types", ("on-demand", "spot")),
                    zones=spec.get("zones", ZONES))
    if spec.get("labels"):
        c.labels = {**c.labels, "team": "a", "app": "b", "kops.k8s.io/x": "y"}
        c.taints = pkg.Taints([pkg.core.Taint(key="b", value="2", effect="NoSchedule"),
                               pkg.core.Taint(key="a", value="1", effect="NoExecute")])
        c.kubelet_configuration.cluster_dns = ["10.0.0.10"]
    if spec.get("template"):
        c.provider["launchTemplate"] = "my-custom-template"
    catalog = provider.get_instance_types(c)
    catalog.sort(key=lambda it: (it.cpu.value(), it.memory.value()))
    bound = []
    if journal_nonce:
        with pkg.journal.preassigned_nonce(journal_nonce):
            errs = provider.create(c, catalog, spec.get("quantity", 1),
                                   lambda n: bound.append(n) or None)
    else:
        errs = provider.create(c, catalog, spec.get("quantity", 1),
                               lambda n: bound.append(n) or None)
    return {"errs": errs, "nodes": [plain_node(n) for n in bound],
            "fleets": [dataclasses.asdict(r) for r in ec2.calls.get("create_fleet", [])],
            "templates": [dataclasses.asdict(t) for t in
                          ec2.calls.get("create_launch_template", [])],
            "described": ec2.calls.get("describe_launch_templates"),
            "ssm": list(ssm.calls),
            "records": [dataclasses.astuple(r)[:6] for r in provider.list_instances()]}


@pytest.mark.parametrize("case", sorted(CREATE_CASES))
def test_creates_what_the_jax_provider_creates(case):
    want, got = both(create, case)
    assert got == want
    run = got
    assert all(e is None for e in run["errs"]) and run["nodes"]
    tags = run["fleets"][0]["tags"]
    assert tags["kubernetes.io/cluster/test-cluster"] == "owned"
    assert tags[port_wk.LAUNCH_NONCE_TAG] == uuid.UUID(
        int=random.Random(11).getrandbits(128), version=4).hex
    if case == "template":
        assert run["templates"] == [] and \
            run["fleets"][0]["launch_template_configs"][0]["launch_template_name"] == \
            "my-custom-template"
    if case == "labels-taints":
        data = [base64.b64decode(t["user_data"]).decode() for t in run["templates"]]
        assert all("--register-with-taints=a=1:NoExecute,b=2:NoSchedule" in d
                   and "--node-labels=app=b,karpenter.sh/capacity-type=spot,"
                   "karpenter.sh/provisioner-name=default,kops.k8s.io/x=y,team=a" in d
                   and "--dns-cluster-ip '10.0.0.10'" in d for d in data)
        assert any("--container-runtime containerd" in d for d in data)
        assert any("--container-runtime containerd" not in d for d in data)


def test_the_journal_nonce_rides_the_fleet_tags():
    want, got = both(create, "both", journal_nonce="journaled-nonce-1")
    assert got == want
    assert got["fleets"][0]["tags"][port_wk.LAUNCH_NONCE_TAG] == "journaled-nonce-1"
    assert [r[2] for r in got["records"]] == ["journaled-nonce-1"]


def test_templates_are_reused_and_names_are_hashes():
    def run(pkg):
        ec2, _, provider = env(pkg)
        c = constraints(pkg)
        for _ in range(2):
            provider.create(c, provider.get_instance_types(c), 1, lambda n: None)
        names = [t.launch_template_name for t in ec2.calls["create_launch_template"]]
        options = {"ClusterName": "c", "UserData": "u", "InstanceProfile": "p",
                   "SecurityGroupsIds": ["sg-1"], "AMIID": "ami-1", "Tags": {},
                   "MetadataOptions": {"httpTokens": "required"}}
        return names, pkg.lt.launch_template_name(options), \
            pkg.lt.launch_template_name({**options, "AMIID": "ami-2"})

    want, got = both(run)
    assert got == want
    assert len(got[0]) == len(set(got[0])) >= 3 and got[1] != got[2]


# -- the ICE cache -----------------------------------------------------------------

def test_ice_poisons_offerings_for_45_seconds():
    def run(pkg):
        ec2, _, provider = env(pkg)
        ec2.behavior.insufficient_capacity_pools = [
            pkg.ec2api.CapacityPool("c6g.large", z, "on-demand") for z in ZONES]
        c = constraints(pkg, capacity_types=("on-demand",))
        catalog = provider.get_instance_types(c)
        catalog.sort(key=lambda it: (it.cpu.value(), it.memory.value()))
        bound = []
        errs = provider.create(c, catalog, 1, lambda n: bound.append(n) or None)
        steps = [(errs, [plain_node(n) for n in bound],
                  [dataclasses.asdict(e) for e in ec2.calls["create_fleet"]])]
        for dt in (0, 44, 2):
            pkg.clock.DEFAULT.set(pkg.clock.now() + dt)
            its = {it.name: it for it in provider.get_instance_types(c)}
            steps.append(sorted((o.capacity_type, o.zone) for o in its["c6g.large"].offerings))
        return steps

    want, got = both(run)
    assert got == want
    assert got[0][0] == [None] and \
        got[0][1][0][2][port_wk.LABEL_INSTANCE_TYPE] != "c6g.large"
    assert got[1] == got[2] == [("spot", z) for z in ZONES]
    assert ("on-demand", "test-zone-1a") in got[3]


def test_total_ice_returns_the_same_errors():
    def run(pkg):
        only = [i for i in pkg.ec2api.default_instance_type_infos()
                if i.instance_type == "t3.large"]
        ec2, _, provider = env(pkg, only)
        ec2.behavior.insufficient_capacity_pools = [
            pkg.ec2api.CapacityPool("t3.large", z, ct) for z in ZONES
            for ct in ("on-demand", "spot")]
        c = constraints(pkg)
        errs = provider.create(c, provider.get_instance_types(c), 2, lambda n: None)
        return errs, [plain_type(it) for it in provider.get_instance_types(c)]

    want, got = both(run)
    assert got == want
    assert got[0] == ["launching instances, with fleet error(s), InsufficientInstanceCapacity: "
                      "there is no capacity available"] * 2
    # spot was chosen, so only the spot offerings were poisoned
    assert [o[0] for o in got[1][0][1]] == ["on-demand"] * 3


def test_terminate_and_list_instances():
    def run(pkg):
        ec2, _, provider = env(pkg)
        c = constraints(pkg)
        bound = []
        provider.create(c, provider.get_instance_types(c), 2, lambda n: bound.append(n) or None)
        first = [dataclasses.astuple(r)[:6] for r in provider.list_instances()]
        out = [provider.delete(bound[0]), provider.delete(bound[0]),
               provider.delete_instance("i-missing")]
        bad = pkg.core.Node(metadata=pkg.core.ObjectMeta(name="x"),
                            spec=pkg.core.NodeSpec(provider_id="aws:///zone"))
        return first, out, provider.delete(bad), list(ec2.terminated), \
            [dataclasses.astuple(r)[:6] for r in provider.list_instances()]

    want, got = both(run)
    assert got == want
    assert got[1] == [None, None, None] and "parsing instance id" in got[2]
    assert len(got[0]) == 2 and len(got[4]) == 1


# -- the vendor block ----------------------------------------------------------------

PROVIDER_BLOCKS = [
    None, {}, {"instanceProfile": ""},
    {"instanceProfile": "p", "subnetSelector": {"a": "b"}, "securityGroupSelector": {"c": "d"}},
    {"instanceProfile": "p", "subnetSelector": {"": "b", "k": ""},
     "securityGroupSelector": {"c": ""}, "tags": {"": "x"}},
    {"instanceProfile": "p", "subnetSelector": {"a": "b"}, "securityGroupSelector": {"c": "d"},
     "metadataOptions": {"httpEndpoint": "bogus", "httpTokens": "optional",
                         "httpProtocolIPv6": "maybe", "httpPutResponseHopLimit": 99}},
    {"instanceProfile": "p", "subnetSelector": {"a": "b"}, "securityGroupSelector": {"c": "d"},
     "metadataOptions": {"httpPutResponseHopLimit": 0}, "launchTemplate": "lt",
     "tags": {"team": "ml"}},
]


@pytest.mark.parametrize("block", range(len(PROVIDER_BLOCKS)))
def test_vendor_block_as_the_jax_package(block):
    def run(pkg):
        _, _, provider = env(pkg)
        c = pkg.Constraints(provider=PROVIDER_BLOCKS[block])
        verdict = provider.validate(c)
        try:
            serialized = pkg.vendor.AWSProvider.deserialize(c).serialize()
        except ValueError as e:
            serialized = str(e)
        provider.default(c)
        return verdict, serialized, c.provider, [
            (r.key, r.operator, sorted(r.values)) for r in c.requirements.items]

    want, got = both(run)
    assert got == want


def test_defaulting_keeps_what_is_set():
    def run(pkg):
        wk, core = pkg.wk, pkg.core
        out = []
        for c in (pkg.Constraints(provider={}),
                  pkg.Constraints(requirements=pkg.Requirements([core.NodeSelectorRequirement(
                      key=wk.LABEL_CAPACITY_TYPE, operator="In", values=["spot", "on-demand"])])),
                  pkg.Constraints(labels={wk.LABEL_ARCH: "arm64"})):
            pkg.vendor.default_constraints(c)
            out.append((c.requirements.architectures(), c.requirements.capacity_types()))
        return out, pkg.vendor.merge_tags("prov", {"Name": "mine", "a": "1"}, {"b": "2"})

    want, got = both(run)
    assert got == want
    assert got[0][1] == (frozenset({"amd64"}), frozenset({"spot", "on-demand"}))


@pytest.mark.parametrize("selector", [{"TestTag": "*"}, {"Name": "test-subnet-2"},
                                      {"Nope": "nothing"}, {"Name": "*", "TestTag": ""}])
def test_subnet_selectors_as_the_jax_package(selector):
    def run(pkg):
        _, _, provider = env(pkg)
        c = constraints(pkg)
        c.provider["subnetSelector"] = selector
        try:
            return sorted({o.zone for it in provider.get_instance_types(c)
                           for o in it.offerings})
        except ValueError as e:
            return str(e)

    want, got = both(run)
    assert got == want


# -- interning ---------------------------------------------------------------------

def test_interning_as_the_jax_package():
    def run(pkg):
        _, _, provider = env(pkg)
        c = constraints(pkg)
        first = {it.name: it for it in provider.get_instance_types(c)}
        second = {it.name: it for it in provider.get_instance_types(c)}
        same = sorted(n for n in first if first[n] is second[n])
        victim = sorted(first)[0]
        o = first[victim].offerings[0]
        provider.instance_type_provider.cache_unavailable(victim, o.zone, o.capacity_type)
        third = {it.name: it for it in provider.get_instance_types(c)}
        kept = sorted(n for n in first if third[n] is first[n])
        pkg.clock.DEFAULT.set(pkg.clock.now() + 301)
        fourth = {it.name: it for it in provider.get_instance_types(c)}
        return same, victim, kept, sorted(n for n in fourth if fourth[n] is third[n])

    want, got = both(run)
    assert got == want
    same, victim, kept, after_refresh = got
    assert kept == [n for n in same if n != victim] and after_refresh == []


def test_a_rediscovered_catalog_hits_the_packables_cache(monkeypatch):
    from karpenter_tpu_torch.api.core import Container, Pod, PodSpec, ResourceRequirements
    from karpenter_tpu_torch.solver.solve import universe_constraints

    _, _, provider = env(PORT)
    pods = [Pod(spec=PodSpec(containers=[Container(resources=ResourceRequirements.make(
        requests={"cpu": "1", "memory": "1Gi"}))]))]
    catalog = provider.get_instance_types(constraints(PORT))
    uc = universe_constraints(catalog)
    _, _, version = port_adapter.build_packables_versioned(catalog, uc, pods, [])
    calls = []
    real = port_adapter._build_packables_from
    monkeypatch.setattr(port_adapter, "_build_packables_from",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    again = provider.get_instance_types(constraints(PORT))
    assert all(a is b for a, b in zip(again, catalog))
    _, _, version2 = port_adapter.build_packables_versioned(again, uc, pods, [])
    assert calls == [] and version2 == version
