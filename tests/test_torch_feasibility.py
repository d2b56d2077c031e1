"""The port's columnar constraint engine (ops/feasibility.py) against the JAX
package's and against the port's own scalar algebra.

Mirrors the classes of tests/test_feasibility.py. Every input is drawn
from numpy seeds 1, 7 and 42 and built separately in each package (the
same draws, the same names and fields), so no object crosses between the
packages. Every comparison is exact: verdicts, error strings, tightened
group keys, catalog masks, allowed-domain sets and schedules. The port's
RAW engine verdict (``_raw_ok``) is held against the scalar oracle, not
only the self-healing wrappers, so a divergence cannot hide behind the
heal; and the heal counter must stay at zero on the fuzz.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import requirements as jax_requirements
from karpenter_tpu.api import wellknown as jax_wellknown
from karpenter_tpu.api.constraints import Constraints as JaxConstraints
from karpenter_tpu.api.constraints import Taints as JaxTaints
from karpenter_tpu.cloudprovider import aws as _jax_aws  # noqa: F401 — the EBS CSI alias
from karpenter_tpu.cloudprovider import spi as jax_spi
from karpenter_tpu.ops import feasibility as jax_feas
from karpenter_tpu.runtime.kubecore import KubeCore as JaxKubeCore
from karpenter_tpu.scheduling.scheduler import Scheduler as JaxScheduler
from karpenter_tpu.solver import adapter as jax_adapter
from karpenter_tpu.utils.resources import Quantity as JaxQuantity
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import requirements as port_requirements
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch.api.constraints import Constraints as PortConstraints
from karpenter_tpu_torch.api.constraints import Taints as PortTaints
from karpenter_tpu_torch.cloudprovider import aws as _port_aws  # noqa: F401 — the alias
from karpenter_tpu_torch.cloudprovider import spi as port_spi
from karpenter_tpu_torch.ops import feasibility as feas
from karpenter_tpu_torch.runtime.kubecore import KubeCore as PortKubeCore
from karpenter_tpu_torch.scheduling import scheduler as port_scheduler
from karpenter_tpu_torch.solver import adapter
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import Quantity as PortQuantity

SEEDS = (1, 7, 42)
IN, NOT_IN = "In", "NotIn"


class Pkg:
    """One package's constructors, so every case is built the same way."""

    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.core = jax_core if jax else port_core
        self.wk = jax_wellknown if jax else port_wellknown
        self.Requirements = (jax_requirements if jax else port_requirements).Requirements
        self.Constraints = JaxConstraints if jax else PortConstraints
        self.Taints = JaxTaints if jax else PortTaints
        self.spi = jax_spi if jax else port_spi
        self.Quantity = JaxQuantity if jax else PortQuantity


JAX, PORT = Pkg("jax"), Pkg("port")


class Draws:
    """A numpy Generator behind the few draws the generators make; two
    Draws of one seed give both packages the same sequence."""

    def __init__(self, seed):
        self.g = np.random.default_rng(seed)

    def randint(self, lo, hi):  # inclusive, as random.randint
        return int(self.g.integers(lo, hi + 1))

    def random(self):
        return float(self.g.random())

    def choice(self, seq):
        return seq[int(self.g.integers(len(seq)))]

    def sample(self, seq, k):
        return [seq[i] for i in self.g.permutation(len(seq))[:k]]


def pools(pkg):
    wk = pkg.wk
    return {
        wk.LABEL_TOPOLOGY_ZONE: ["us-1a", "us-1b", "us-1c", "eu-9a"],
        wk.LABEL_OS: ["linux", "windows", "bottlerocket"],
        wk.LABEL_ARCH: ["amd64", "arm64"],
        wk.LABEL_INSTANCE_TYPE: ["m5.large", "m5.xlarge", "c5.large"],
        "example.com/team": ["red", "blue", "green"],
        "env": ["dev", "prod"],
    }


def aliases(pkg):
    """Alias keys by canonical key, from the port's table for both
    packages: importing either package's AWS provider adds an EBS CSI zone
    alias to that package's table, so this module imports both (the draws
    must not depend on which modules a test process imported first), and
    the alias is drawn and normalized in both."""
    out = {}
    for alias, canon in port_wellknown.NORMALIZED_LABELS.items():
        out.setdefault(canon, []).append(alias)
    return {k: sorted(v) for k, v in out.items()}


def rand_values(pkg, d, canon):
    pool = pools(pkg)[canon]
    return d.sample(pool, d.randint(0, min(3, len(pool))))


def maybe_alias(pkg, d, canon):
    al = aliases(pkg).get(canon)
    if al and d.random() < 0.3:
        return d.choice(al)
    return canon


def rand_constraints(pkg, d):
    keys = list(pools(pkg))
    rows = []
    for _ in range(d.randint(0, 6)):
        canon = d.choice(keys)
        op = d.choice([IN, IN, IN, NOT_IN, NOT_IN, "Exists"])
        rows.append(pkg.core.NodeSelectorRequirement(
            key=maybe_alias(pkg, d, canon), operator=op, values=rand_values(pkg, d, canon)))
    # add() normalizes alias keys; raw items keep the literal-key quirk
    reqs = pkg.Requirements().add(*rows) if d.random() < 0.5 else pkg.Requirements(rows)
    taints = pkg.Taints(
        pkg.core.Taint(key=d.choice(["a", "b"]), value=d.choice(["x", "y"]),
                       effect=d.choice(["NoSchedule", "NoExecute"]))
        for _ in range(d.randint(0, 2)))
    labels = {f"l{i}": "1" for i in range(d.randint(0, 2))}
    return pkg.Constraints(labels=labels, taints=taints, requirements=reqs)


def rand_pod(pkg, d, i=0, ops=(IN, IN, NOT_IN, "Exists")):
    c = pkg.core
    keys = list(pools(pkg))
    pod = c.Pod()
    pod.metadata.name = f"fuzz-{i}"
    for _ in range(d.randint(0, 2)):
        canon = d.choice(keys)
        pod.spec.node_selector[maybe_alias(pkg, d, canon)] = d.choice(
            pools(pkg)[canon] + ["unseen-value"])
    if d.random() < 0.7:
        def term():
            return c.NodeSelectorTerm(match_expressions=[
                c.NodeSelectorRequirement(key=maybe_alias(pkg, d, k2), operator=d.choice(list(ops)),
                                          values=rand_values(pkg, d, k2))
                for k2 in d.sample(keys, d.randint(0, 2))])
        na = c.NodeAffinity()
        for _ in range(d.randint(0, 2)):
            na.preferred.append(c.PreferredSchedulingTerm(weight=d.randint(1, 3),
                                                          preference=term()))
        if d.random() < 0.6:
            na.required = [term()]
        pod.spec.affinity = c.Affinity(node_affinity=na)
    for _ in range(d.randint(0, 2)):
        pod.spec.tolerations.append(c.Toleration(
            key=d.choice(["a", "b", ""]), operator=d.choice(["Equal", "Exists"]),
            # Exists with a value is the core/v1 "must not carry a value" quirk
            value=d.choice(["x", "y", ""]), effect=d.choice(["NoSchedule", "NoExecute", ""])))
    if d.random() < 0.2:
        pod.spec.containers.append(c.Container(resources=c.ResourceRequirements.make(
            limits={d.choice(["nvidia.com/gpu", "amd.com/gpu"]): "1"})))
    return pod


def compatible_pod(pkg, d, cons, i=0):
    """A pod biased toward satisfying ``cons``: selectors from its own
    allowed sets, tolerations matching its taints."""
    pod = pkg.core.Pod()
    pod.metadata.name = f"compat-{i}"
    for key in sorted(cons.requirements.keys()):
        allowed = cons.requirements.requirement(key)
        if allowed and d.random() < 0.8:
            pod.spec.node_selector[key] = d.choice(sorted(allowed))
    for t in cons.taints:
        pod.spec.tolerations.append(pkg.core.Toleration(
            key=t.key, operator="Equal", value=t.value, effect=t.effect))
    return pod


def both(seed, make):
    """``make(pkg, draws)`` in each package from the same seed."""
    return make(JAX, Draws(seed)), make(PORT, Draws(seed))


@pytest.fixture(autouse=True)
def fresh_heals():
    feas.reset_heals()
    yield
    feas.reset_heals()


def port_key(c, pod):
    return port_scheduler._constraints_key(c, res.gpu_limits_for(pod))


@pytest.mark.parametrize("operator", ["Exists", "DoesNotExist", "Gt", "Lt"])
def test_validate_pod_reads_only_in_and_notin(operator):
    """A pod requirement with another operator (here carrying values, as
    the fuzz draws them: seed 1's case 101 was Exists with three
    instance types) narrows nothing, as Requirements.requirement reads only
    In and NotIn: the port's scalar validate_pod, its columnar verdict and
    the JAX package's agree."""
    out = []
    for pkg in (JAX, PORT):
        c = pkg.core
        wk = pkg.wk
        cons = pkg.Constraints(requirements=pkg.Requirements([
            c.NodeSelectorRequirement(key=wk.LABEL_INSTANCE_TYPE, operator="In",
                                      values=["c5.large", "m5.large"])]))
        pod = c.Pod(spec=c.PodSpec(affinity=c.Affinity(node_affinity=c.NodeAffinity(
            required=[c.NodeSelectorTerm(match_expressions=[c.NodeSelectorRequirement(
                key=wk.LABEL_INSTANCE_TYPE, operator=operator,
                values=["m5.large", "c5.large", "m5.xlarge"])])]))))
        out.append(cons.validate_pod(pod))
        if pkg is PORT:
            out.append(feas.validate_pod_fast(cons, pod))
    assert out == [None, None, None]


class TestFuzzValidate:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_raw_verdicts_and_error_strings(self, seed):
        """200 random (constraints, pod) cases a seed: the port's raw bitset
        verdict equals its scalar oracle, and validate_pod_fast's answer
        (verdict and error string) equals the scalar one and the JAX
        package's validate_pod_fast."""
        def make(pkg, d):
            return [(rand_constraints(pkg, d), rand_pod(pkg, d, i)) for i in range(200)]

        jcases, pcases = both(seed, make)
        for i, ((jc, jp), (pc, pp)) in enumerate(zip(jcases, pcases)):
            cc = feas.compile_constraints(pc)
            assert cc is not None
            scalar = pc.validate_pod(pp)
            sig = feas.pod_signature(pp)
            assert sig is not None
            assert cc._raw_ok(sig) == (scalar is None), f"case {i}"
            got = feas.validate_pod_fast(pc, pp)
            assert got == scalar == jax_feas.validate_pod_fast(jc, jp), f"case {i}"
        assert feas.heal_counts() == {}

    @pytest.mark.parametrize("seed", SEEDS)
    def test_schedule_entry_keys_and_tighten(self, seed):
        """schedule_entry's memoized (error, tightened, group key) equals
        the per-pod scalar computation and the JAX engine's entry."""
        def make(pkg, d):
            out = []
            for i in range(150):
                c = rand_constraints(pkg, d)
                out.append((c, compatible_pod(pkg, d, c, i) if i % 2 else rand_pod(pkg, d, i)))
            return out

        jcases, pcases = both(seed, make)
        checked = 0
        for (jc, jp), (pc, pp) in zip(jcases, pcases):
            err, tightened, key = feas.compile_constraints(pc).schedule_entry(pp)
            jerr, jtight, jkey = jax_feas.compile_constraints(jc).schedule_entry(jp)
            assert err == jerr == pc.validate_pod(pp)
            assert key == jkey
            if err is not None:
                continue
            ref = pc.tighten(pp)
            assert key == port_key(ref, pp)
            assert feas.constraints_key_parts(tightened) == feas.constraints_key_parts(ref) \
                == jax_feas.constraints_key_parts(jtight)
            assert tightened.labels is pc.labels and tightened.taints is pc.taints
            checked += 1
        assert checked >= 30

    def test_one_tighten_per_signature(self):
        wk = port_wellknown
        c = PortConstraints(requirements=port_requirements.Requirements().add(
            port_core.NodeSelectorRequirement(key=wk.LABEL_TOPOLOGY_ZONE, operator=IN,
                                              values=["us-1a", "us-1b"])))
        p1, p2 = port_core.Pod(), port_core.Pod()
        for p, n in ((p1, "a"), (p2, "b")):
            p.metadata.name = n
            p.spec.node_selector = {wk.LABEL_TOPOLOGY_ZONE: "us-1a"}
        cc = feas.compile_constraints(c)
        _, t1, k1 = cc.schedule_entry(p1)
        _, t2, k2 = cc.schedule_entry(p2)
        assert t1 is t2 and k1 == k2 == port_key(c.tighten(p1), p1)

    def test_unsupported_operator_falls_back(self):
        def make(pkg, d):
            c = rand_constraints(pkg, d)
            pod = pkg.core.Pod()
            pod.spec.affinity = pkg.core.Affinity(node_affinity=pkg.core.NodeAffinity(required=[
                pkg.core.NodeSelectorTerm(match_expressions=[pkg.core.NodeSelectorRequirement(
                    key="example.com/team", operator="Gt", values=["5"])])]))
            return c, pod

        (jc, jp), (pc, pp) = both(1, make)
        assert feas.pod_signature(pp) is None
        assert feas.validate_pod_fast(pc, pp) == pc.validate_pod(pp) == \
            jax_feas.validate_pod_fast(jc, jp)
        assert feas.heal_counts()["unsupported-operator"] >= 1


def single(pkg, rows, raw=True, taints=()):
    reqs = pkg.Requirements(rows) if raw else pkg.Requirements().add(*rows)
    return pkg.Constraints(taints=pkg.Taints(taints), requirements=reqs)


def quirk_cases(pkg):
    """(constraints, pod) pairs for each Go quirk the engine keeps."""
    c, wk = pkg.core, pkg.wk
    zone = wk.LABEL_TOPOLOGY_ZONE
    req = c.NodeSelectorRequirement

    def pod(sel=None, tol=None):
        p = c.Pod()
        p.spec.node_selector = dict(sel or {})
        p.spec.tolerations = list(tol or [])
        return p

    return {
        "notin-without-in": (single(pkg, [req(key=zone, operator=NOT_IN, values=["us-1a"])]),
                             pod({zone: "us-1b"})),
        "empty-notin": (single(pkg, [req(key=zone, operator=NOT_IN, values=[])]),
                        pod({zone: "us-1b"})),
        "in-and-notin-ok": (single(pkg, [req(key=zone, operator=IN, values=["us-1a", "us-1b"]),
                                         req(key=zone, operator=NOT_IN, values=["us-1b"])]),
                            pod({zone: "us-1a"})),
        "in-and-notin-bad": (single(pkg, [req(key=zone, operator=IN, values=["us-1a", "us-1b"]),
                                          req(key=zone, operator=NOT_IN, values=["us-1b"])]),
                             pod({zone: "us-1b"})),
        "empty-in": (single(pkg, [req(key=zone, operator=IN, values=[])]), pod({zone: "us-1a"})),
        "alias-on-pod": (single(pkg, [req(key=zone, operator=IN, values=["us-1a"])], raw=False),
                         pod({wk.LABEL_FAILURE_DOMAIN_BETA_ZONE: "us-1a"})),
        "alias-literal-constraint": (
            single(pkg, [req(key=wk.LABEL_FAILURE_DOMAIN_BETA_ZONE, operator=IN,
                             values=["us-1a"])]),
            pod({wk.LABEL_FAILURE_DOMAIN_BETA_ZONE: "us-1a"})),
        "exists-toleration-value": (
            single(pkg, [], taints=[c.Taint(key="a", value="x", effect="NoSchedule")]),
            pod(tol=[c.Toleration(key="a", operator="Exists", value="x", effect="NoSchedule")])),
        "exists-constraint-row": (single(pkg, [req(key=zone, operator="Exists", values=[])]),
                                  pod({zone: "us-1a"})),
    }


class TestQuirks:
    @pytest.mark.parametrize("case", sorted(quirk_cases(PORT)))
    def test_quirk_matches_scalar_and_jax(self, case):
        jc, jp = quirk_cases(JAX)[case]
        pc, pp = quirk_cases(PORT)[case]
        scalar = pc.validate_pod(pp)
        assert feas.validate_pod_fast(pc, pp) == scalar == jax_feas.validate_pod_fast(jc, jp)
        raw = feas.compile_constraints(pc)._raw_ok(feas.pod_signature(pp))
        assert raw == (scalar is None)
        if case in ("notin-without-in", "empty-notin"):
            assert pc.requirements.requirement(port_wellknown.LABEL_TOPOLOGY_ZONE) == frozenset()
            assert scalar is not None

    def test_sets_has_nil_rejects_every_type(self):
        """An unconstrained allowed set rejects the whole catalog in both
        packages (Go's sets.Has(nil) is false)."""
        cat = [port_spi.InstanceType(name="t", offerings=[port_spi.Offering("spot", "z")])]
        allowed = (None, frozenset({"z"}), frozenset({"t"}), frozenset({"amd64"}),
                   frozenset({"linux"}))
        assert list(feas.catalog_feasibility_mask(cat, allowed, frozenset())) == [False]


class TestInternTable:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_rollover_keeps_verdicts(self, seed, monkeypatch):
        feas.reset_intern_table()
        jax_feas.reset_intern_table()
        monkeypatch.setattr(feas, "_INTERN_MAX", 4)
        monkeypatch.setattr(jax_feas, "_INTERN_MAX", 4)
        _, gen0 = feas.intern_table_stats()

        def make(pkg, d):
            return [(rand_constraints(pkg, d), rand_pod(pkg, d, i)) for i in range(40)]

        jcases, pcases = both(seed, make)
        for (jc, jp), (pc, pp) in zip(jcases, pcases):
            assert feas.validate_pod_fast(pc, pp) == pc.validate_pod(pp) == \
                jax_feas.validate_pod_fast(jc, jp)
        _, gen1 = feas.intern_table_stats()
        assert gen1 > gen0
        assert feas.heal_counts().get("intern-reset", 0) == gen1 - gen0

    def test_compiled_object_survives_reset(self):
        pc, pp = quirk_cases(PORT)["alias-on-pod"]
        cc = feas.compile_constraints(pc)
        assert cc.validate(pp) is None
        feas.reset_intern_table()
        assert cc.validate(pp) is None
        other = port_core.Pod()
        other.spec.node_selector = {port_wellknown.LABEL_TOPOLOGY_ZONE: "us-1b"}
        assert cc.validate(other) == pc.validate_pod(other)

    def test_size_tracks_interning(self):
        feas.reset_intern_table()
        c = single(PORT, [port_core.NodeSelectorRequirement(
            key=port_wellknown.LABEL_TOPOLOGY_ZONE, operator=IN,
            values=["us-1a", "us-1b", "us-1c"])])
        feas.compile_constraints(c)
        assert feas.intern_table_stats()[0] == 3


class TestCopySemantics:
    def test_deepcopy_recompiles_never_shares_stale(self):
        from karpenter_tpu_torch.utils import fastcopy

        pc, pp = quirk_cases(PORT)["alias-on-pod"]
        cc = feas.compile_constraints(pc)
        assert feas.CompiledConstraints.__deepcopy__(cc, {}) is cc
        for copy_ in (pc.deepcopy(), fastcopy.deep_copy(pc)):
            cc2 = feas.compile_constraints(copy_)
            assert cc2 is not cc
            assert cc2.validate(pp) is None

    def test_mutation_is_detected_by_length(self):
        wk = port_wellknown
        pc, _ = quirk_cases(PORT)["alias-on-pod"]
        cc = feas.compile_constraints(pc)
        pc.requirements.items.append(port_core.NodeSelectorRequirement(
            key=wk.LABEL_HOSTNAME, operator=IN, values=["h-1"]))
        cc2 = feas.compile_constraints(pc)
        assert cc2 is not cc
        pod = port_core.Pod()
        pod.spec.node_selector = {wk.LABEL_HOSTNAME: "h-2"}
        assert cc2.validate(pod) == pc.validate_pod(pod) is not None


# -- catalog masks ---------------------------------------------------------------

def rand_instance_type(pkg, d, i):
    q = lambda n: pkg.Quantity(int(n) * 10**9)  # noqa: E731
    offerings = [pkg.spi.Offering(d.choice(["spot", "on-demand"]),
                                  d.choice(["us-1a", "us-1b", "eu-9a"]))
                 for _ in range(d.randint(0, 3))]
    return pkg.spi.InstanceType(
        name=f"it-{i % 7}", offerings=offerings,
        architecture=d.choice(["amd64", "arm64"]),
        operating_systems=frozenset(d.sample(["linux", "windows", "bottlerocket"],
                                             d.randint(0, 2))),
        cpu=q(4), memory=q(16), pods=q(110),
        nvidia_gpus=q(d.choice([0, 0, 1])), amd_gpus=q(d.choice([0, 0, 1])),
        aws_neurons=q(d.choice([0, 0, 1])), aws_pod_eni=q(d.choice([0, 1])))


def rand_allowed(d):
    def some(pool):
        if d.random() < 0.2:
            return None  # an unconstrained set REJECTS (Go sets.Has(nil))
        return frozenset(d.sample(pool, d.randint(0, len(pool))))

    return (some(["spot", "on-demand"]), some(["us-1a", "us-1b", "eu-9a"]),
            some([f"it-{j}" for j in range(7)]), some(["amd64", "arm64"]),
            some(["linux", "windows", "bottlerocket"]))


SPECIAL = ["vpc.amazonaws.com/pod-eni", "nvidia.com/gpu", "amd.com/gpu", "aws.amazon.com/neuron"]


class TestCatalogMask:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_mask_equals_jax_and_validate(self, seed):
        def make(pkg, d):
            out = []
            for _ in range(60):
                cat = [rand_instance_type(pkg, d, i) for i in range(d.randint(0, 12))]
                out.append((cat, rand_allowed(d), frozenset(d.sample(SPECIAL, d.randint(0, 2)))))
            return out

        jcases, pcases = both(seed, make)
        for case, ((jcat, ja, jr), (pcat, pa, pr)) in enumerate(zip(jcases, pcases)):
            mask = feas.catalog_feasibility_mask(pcat, pa, pr)
            want = jax_feas.catalog_feasibility_mask(jcat, ja, jr)
            ref = [adapter._validate(it, pa, pr) is None for it in pcat]
            assert list(mask) == list(want) == ref, f"case {case}"

    def test_mask_is_memoized_and_readonly(self):
        d = Draws(3)
        cat = [rand_instance_type(PORT, d, i) for i in range(5)]
        allowed = rand_allowed(d)
        m1 = feas.catalog_feasibility_mask(cat, allowed, frozenset())
        assert feas.catalog_feasibility_mask(cat, allowed, frozenset()) is m1
        assert not m1.flags.writeable

    def test_os_vocab_overflow_falls_back_to_validate(self):
        def make(pkg, d):
            it = rand_instance_type(pkg, d, 0)
            it.operating_systems = frozenset(f"os-{i}" for i in range(70))
            return it, rand_allowed(d)

        (jit, ja), (pit, pa) = both(4, make)
        assert feas.catalog_feasibility_mask([pit], pa, frozenset()) is None
        assert jax_feas.catalog_feasibility_mask([jit], ja, frozenset()) is None
        assert feas.heal_counts() == {"os-vocab-overflow": 1}
        packables, types = adapter._build_packables_from([pit], pa, (), frozenset())
        assert len(types) == int(adapter._validate(pit, pa, frozenset()) is None)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_build_packables_on_the_mask_equals_scalar_and_jax(self, seed, monkeypatch):
        def make(pkg, d):
            cat = [rand_instance_type(pkg, d, i) for i in range(12)]
            for j, it in enumerate(cat):
                it.name = f"it-{j}"
            return cat, rand_allowed(d), frozenset(d.sample(SPECIAL, d.randint(0, 1)))

        (jcat, ja, jr), (pcat, pa, pr) = both(seed, make)
        with_mask = adapter._build_packables_from(pcat, pa, (), pr)
        want = jax_adapter._build_packables_from(jcat, ja, (), jr)
        monkeypatch.setattr(feas, "catalog_feasibility_mask", lambda *a, **k: None)
        scalar = adapter._build_packables_from(pcat, pa, (), pr)
        for got in (with_mask, scalar):
            assert [t.name for t in got[1]] == [t.name for t in want[1]]
            assert [p.total for p in got[0]] == [p.total for p in want[0]]

    @pytest.mark.parametrize("seed", SEEDS)
    def test_gang_column_on_host_masks_equals_jax(self, seed, monkeypatch):
        """With the device filter switched off, a gang column is the AND of
        the members' host catalog masks, as the JAX package's."""
        monkeypatch.setenv("KARPENTER_DEVICE_FILTER", "0")

        def make(pkg, d):
            cat = [rand_instance_type(pkg, d, i) for i in range(10)]
            keys = [(rand_allowed(d), frozenset(d.sample(SPECIAL, d.randint(0, 1))))
                    for _ in range(d.randint(1, 3))]
            return cat, keys

        (jcat, jkeys), (pcat, pkeys) = both(seed, make)
        feas.clear_gang_cache()
        jax_feas.clear_catalog_caches()
        got = feas.gang_feasibility_mask(pcat, pkeys, device="cpu")
        want = jax_feas.gang_feasibility_mask(jcat, jkeys)
        assert list(got) == list(want)
        assert list(got) == list(feas.gang_scalar_mask(pcat, tuple(sorted(set(pkeys))), None))


# -- the scheduler ---------------------------------------------------------------

class TestSchedulerIntegration:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_window_equals_jax_and_scalar(self, seed, monkeypatch):
        """Whole windows through the engine-backed _get_schedules: the same
        schedules (group keys, order, members, tightened structure) as the
        JAX package's and as the port's scalar path (the engine off)."""
        def make(pkg, d):
            return [(rand_constraints(pkg, d), [rand_pod(pkg, d, i) for i in range(25)])
                    for _ in range(12)]

        jcases, pcases = both(seed, make)
        port = port_scheduler.Scheduler(PortKubeCore(), device="cpu")
        jax = JaxScheduler(JaxKubeCore())
        got = [port._get_schedules(c, pods) for c, pods in pcases]
        want = [jax._get_schedules(c, pods) for c, pods in jcases]
        monkeypatch.setattr(feas, "compile_constraints", lambda c: None)
        scalar = [port._get_schedules(c, pods) for c, pods in pcases]
        for case, (g, w, s) in enumerate(zip(got, want, scalar)):
            gv = [(feas.constraints_key_parts(x.constraints), [p.metadata.name for p in x.pods])
                  for x in g]
            wv = [(jax_feas.constraints_key_parts(x.constraints),
                   [p.metadata.name for p in x.pods]) for x in w]
            sv = [(feas.constraints_key_parts(x.constraints), [p.metadata.name for p in x.pods])
                  for x in s]
            assert gv == wv == sv, f"case {case}"
        assert feas.heal_counts() == {}


# -- topology_allowed --------------------------------------------------------------

class TestTopologyAllowed:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_allowed_domains_equal_jax_and_scalar(self, seed):
        """At least 600 cases over the three seeds: the columnar allowed
        set equals the JAX package's and the scalar requirement algebra's."""
        def make(pkg, d):
            keys = list(pools(pkg)) + [pkg.wk.LABEL_HOSTNAME]
            return [(rand_constraints(pkg, d), rand_pod(pkg, d, i), d.choice(keys))
                    for i in range(220)]

        jcases, pcases = both(seed, make)
        checked = 0
        for i, ((jc, jp, jk), (pc, pp, pk)) in enumerate(zip(jcases, pcases)):
            cc, sig = feas.compile_constraints(pc), feas.pod_signature(pp)
            jcc, jsig = jax_feas.compile_constraints(jc), jax_feas.pod_signature(jp)
            assert (cc is None, sig is None) == (jcc is None, jsig is None)
            if cc is None or sig is None:
                continue
            want = pc.requirements.add(
                *port_requirements.pod_requirements(pp).items).requirement(pk)
            got = feas.topology_allowed(cc, sig, pk)
            assert got == want == jax_feas.topology_allowed(jcc, jsig, jk), f"case {i}"
            checked += 1
        assert checked >= 200

    def test_out_of_vocab_pod_values_survive_without_an_in_row(self):
        wk = port_wellknown
        c = single(PORT, [port_core.NodeSelectorRequirement(
            key=wk.LABEL_TOPOLOGY_ZONE, operator=NOT_IN, values=["us-1a"])], raw=False)
        pod = port_core.Pod()
        pod.spec.node_selector[wk.LABEL_TOPOLOGY_ZONE] = "zone-never-interned"
        got = feas.topology_allowed(feas.compile_constraints(c), feas.pod_signature(pod),
                                    wk.LABEL_TOPOLOGY_ZONE)
        assert got == frozenset({"zone-never-interned"})

    def test_go_notin_quirk_yields_empty_not_none(self):
        wk = port_wellknown
        c = PortConstraints(requirements=port_requirements.Requirements())
        pod = port_core.Pod()
        pod.spec.affinity = port_core.Affinity(node_affinity=port_core.NodeAffinity(required=[
            port_core.NodeSelectorTerm(match_expressions=[port_core.NodeSelectorRequirement(
                key=wk.LABEL_TOPOLOGY_ZONE, operator=NOT_IN, values=["us-1a"])])]))
        got = feas.topology_allowed(feas.compile_constraints(c), feas.pod_signature(pod),
                                    wk.LABEL_TOPOLOGY_ZONE)
        assert got == frozenset()

    def test_inject_heals_an_empty_domain_to_the_scalar_answer(self, monkeypatch):
        """A columnar set that leaves no domain is recomputed by the scalar
        algebra; a disagreement is counted and the scalar answer wins."""
        from karpenter_tpu_torch.scheduling import topology as port_topology

        wk = port_wellknown
        c = single(PORT, [port_core.NodeSelectorRequirement(
            key=wk.LABEL_TOPOLOGY_ZONE, operator=IN, values=["us-1a", "us-1b"])], raw=False)
        pods = []
        for i in range(3):
            p = port_core.Pod()
            p.metadata.name = f"p{i}"
            p.metadata.labels = {"app": "x"}
            p.spec.topology_spread_constraints = [port_core.TopologySpreadConstraint(
                max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE,
                label_selector=port_core.LabelSelector(match_labels={"app": "x"}))]
            pods.append(p)
        monkeypatch.setattr(feas, "topology_allowed", lambda *a: frozenset())
        port_topology.Topology(PortKubeCore()).inject(c, pods)
        assert feas.heal_counts() == {"topology-mismatch": 1}
        assert all(p.spec.node_selector[wk.LABEL_TOPOLOGY_ZONE] in ("us-1a", "us-1b")
                   for p in pods)
        assert not any(p.__dict__.get("_topology_unsat") for p in pods)
