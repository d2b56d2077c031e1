"""The port's pod-(anti-)affinity against the JAX package's.

Every input is built separately in each package from the same seeded draws
(``random.Random``), and every comparison is exact (bools, strings and
integers: tolerance 0):

- the selectors × peers match matrix (B5): the port's device program on
  the CPU (``device_filter.affinity_matrix``), its numpy twin
  (``affinity_matrix_plain``), the host columnar leg and the full entry
  with its probe (``feasibility.affinity_match_matrix``) against the
  scalar ``LabelSelector.matches`` oracle and the JAX package's matrix
  (its jitted ``_affinity_jit`` on the CPU), over the seeds 1/7/42 fuzz of
  tests/test_affinity.py (all four operators, match_labels, empty
  selectors, unseen pairs, absent keys); the sabotage heal and the
  unsupported-operator route, counted in ``feasibility.HEALS``;
- ``AffinityGroups.inject``: tests/test_affinity.py's four cases and the
  seeds 1/7/42 fuzz of tests/test_soft_affinity.py (required terms on the
  zone and hostname keys, plus preferred terms) give the same node
  selectors, the same unsat set and the same ``_soft_affinity`` votes in
  both packages. Hostname domains are ``secrets.token_hex`` draws, so both
  packages' draws are replaced by the same counter.
"""

import itertools
import random
import secrets

import numpy as np
import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wellknown
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.ops import device_filter as jax_df
from karpenter_tpu.ops import feasibility as jax_feas
from karpenter_tpu.scheduling import affinity as jax_aff
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.ops import device_filter as port_df
from karpenter_tpu_torch.ops import feasibility as port_feas
from karpenter_tpu_torch.scheduling import affinity as port_aff
from karpenter_tpu_torch.solver.solve import universe_constraints as port_universe

SEEDS = (1, 7, 42)
_KEYS = ["app", "tier", "track", "zone-hint", "rel"]
_VALS = ["web", "db", "cache", "canary", "stable", "batch", "x", ""]


@pytest.fixture(autouse=True)
def fresh_caches():
    port_feas.reset_heals()
    port_df.clear_affinity_cache()
    yield
    port_feas.reset_heals()
    port_df.clear_affinity_cache()


# -- the match matrix ------------------------------------------------------------

def rand_selector_spec(rng):
    """(match_labels, [(key, operator, values)]) drawn as
    tests/test_affinity.py draws its selectors."""
    ml = {k: rng.choice(_VALS + ["never-a-peer-value"])
          for k in rng.sample(_KEYS, rng.randint(0, 2))}
    exprs = []
    for _ in range(rng.randint(0, 3)):
        op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist"])
        vals = ([rng.choice(_VALS + ["absent-value"]) for _ in range(rng.randint(1, 3))]
                if op in ("In", "NotIn") else [])
        exprs.append((rng.choice(_KEYS + ["absent-key"]), op, vals))
    return ml, exprs


def selector(core, spec):
    ml, exprs = spec
    return core.LabelSelector(match_labels=dict(ml), match_expressions=[
        core.NodeSelectorRequirement(key=k, operator=op, values=list(v)) for k, op, v in exprs])


def rand_case(rng):
    peers = [port_feas.labels_signature({k: rng.choice(_VALS) for k in
                                         rng.sample(_KEYS, rng.randint(0, len(_KEYS)))})
             for _ in range(rng.randint(1, 14))]
    peers = tuple(dict.fromkeys(peers))
    specs = [rand_selector_spec(rng) for _ in range(rng.randint(1, 6))]
    return specs, peers


@pytest.mark.parametrize("seed", SEEDS)
def test_match_matrix_equals_the_jax_package(seed):
    """180 fuzzed matrices a seed: every leg of the port equals the scalar
    oracle and the JAX package's matrices, cell for cell, with no heal."""
    rng = random.Random(seed)
    for _ in range(180):
        specs, peers = rand_case(rng)
        psel = [selector(port_core, s) for s in specs]
        jsel = [selector(jax_core, s) for s in specs]
        oracle = port_feas._affinity_scalar(psel, peers)
        assert np.array_equal(oracle, jax_feas._affinity_scalar(jsel, peers))
        sigs = tuple(port_feas.selector_signature(s) for s in psel)
        assert sigs == tuple(jax_feas.selector_signature(s) for s in jsel)
        want = jax_df.affinity_matrix(sigs, peers)
        assert want is not None and np.array_equal(want, oracle)
        assert np.array_equal(port_df.affinity_matrix(sigs, peers, "cpu"), oracle)
        assert np.array_equal(port_df.affinity_matrix_plain(sigs, peers), oracle)
        assert np.array_equal(port_feas._affinity_columnar(psel, peers), oracle)
        assert np.array_equal(port_feas.affinity_match_matrix(psel, peers, "cpu"),
                              jax_feas.affinity_match_matrix(jsel, peers))
    assert port_feas.heal_counts() == {}


def test_empty_selectors_and_padding_clauses():
    """Every selector empty: all True without a program; one clause beside
    empty selectors pads to eight clauses charged to selector 0, which
    must stay a non-violation."""
    peers = (port_feas.labels_signature({"app": "web"}),
             port_feas.labels_signature({}))
    empty = [port_core.LabelSelector(), port_core.LabelSelector()]
    sigs = tuple(port_feas.selector_signature(s) for s in empty)
    assert port_df.affinity_planes(sigs, peers) is None
    got = port_df.affinity_matrix(sigs, peers, "cpu")
    assert got.all() and np.array_equal(got, jax_df.affinity_matrix(sigs, peers))
    mixed = [port_core.LabelSelector(),
             port_core.LabelSelector(match_labels={"app": "web"}),
             port_core.LabelSelector(match_labels={"app": "unseen"})]
    sigs = tuple(port_feas.selector_signature(s) for s in mixed)
    _, cmask, ckind, csel = port_df.affinity_planes(sigs, peers)
    assert cmask.shape[0] == 8 and list(csel[2:]) == [0] * 6 and list(ckind[2:]) == [1] * 6
    want = np.array([[True, True], [True, False], [False, False]])
    assert np.array_equal(port_df.affinity_matrix(sigs, peers, "cpu"), want)
    assert np.array_equal(jax_df.affinity_matrix(sigs, peers), want)


def test_sabotaged_matrix_heals_to_scalar(monkeypatch):
    """A flipped cell of the device matrix is caught by the probe (S*P = 6
    cells, all probed): the scalar matrix wins and the heal is counted."""
    psel = [port_core.LabelSelector(match_labels={"app": "web"}),
            port_core.LabelSelector(match_expressions=[
                port_core.NodeSelectorRequirement(key="tier", operator="In", values=["db"])])]
    peers = (port_feas.labels_signature({"app": "web"}),
             port_feas.labels_signature({"tier": "db"}),
             port_feas.labels_signature({"app": "other"}))
    oracle = port_feas._affinity_scalar(psel, peers)

    def sabotage(sel_sigs, peer_sigs, device=None):
        bad = oracle.copy()
        bad[0, 0] = not bad[0, 0]
        return bad

    monkeypatch.setattr(port_df, "affinity_matrix", sabotage)
    got = port_feas.affinity_match_matrix(psel, peers, "cpu")
    assert np.array_equal(got, oracle)
    assert port_feas.heal_counts() == {"affinity-mismatch": 1}


def test_unsupported_operator_goes_scalar():
    psel = [port_core.LabelSelector(match_expressions=[
        port_core.NodeSelectorRequirement(key="app", operator="Gt", values=["3"])])]
    jsel = [jax_core.LabelSelector(match_expressions=[
        jax_core.NodeSelectorRequirement(key="app", operator="Gt", values=["3"])])]
    peers = (port_feas.labels_signature({"app": "x"}),)
    assert port_feas.selector_signature(psel[0]) is None
    got = port_feas.affinity_match_matrix(psel, peers, "cpu")
    assert np.array_equal(got, jax_feas.affinity_match_matrix(jsel, peers))
    assert port_feas.heal_counts() == {"unsupported-operator": 1}


def test_matrix_is_cached_and_read_only():
    sigs = (port_feas.selector_signature(port_core.LabelSelector(match_labels={"a": "b"})),)
    peers = (port_feas.labels_signature({"a": "b"}),)
    runs = port_df.AFFINITY_RUNS
    first = port_df.affinity_matrix(sigs, peers, "cpu")
    assert port_df.affinity_matrix(sigs, peers, "cpu") is first
    assert port_df.AFFINITY_RUNS == runs + 1
    assert not first.flags.writeable


# -- AffinityGroups.inject ---------------------------------------------------------

PKGS = {
    "jax": (jax_core, jax_wellknown, jax_fake, jax_universe, jax_aff),
    "port": (port_core, port_wellknown, port_fake, port_universe, port_aff),
}


@pytest.fixture
def same_tokens(monkeypatch):
    """Both packages draw hostname domains from ``secrets.token_hex``; give
    each run the same counter so the domains compare as strings."""
    def reset():
        counter = itertools.count()
        monkeypatch.setattr(secrets, "token_hex", lambda n=4: f"h{next(counter):07x}")

    return reset


def make_pod(pkg, name, labels, aff=(), anti=(), preferred=(), node_selector=None):
    """A 100m pod in namespace default; ``aff`` / ``anti`` are required
    (topology key, match_labels) terms, ``preferred`` (weight, key,
    match_labels, anti) terms."""
    core, wk, *_ = PKGS[pkg]

    def term(key, ml):
        return core.PodAffinityTerm(topology_key=key, label_selector=core.LabelSelector(
            match_labels=dict(ml)))

    p = core.Pod(metadata=core.ObjectMeta(name=name, namespace="default", labels=dict(labels)),
                 spec=core.PodSpec(containers=[core.Container(
                     resources=core.ResourceRequirements.make(
                         requests={"cpu": "100m", "memory": "64Mi"}))]))
    if node_selector:
        p.spec.node_selector = dict(node_selector)
    pref_aff = [core.WeightedPodAffinityTerm(weight=w, term=term(k, ml))
                for w, k, ml, is_anti in preferred if not is_anti]
    pref_anti = [core.WeightedPodAffinityTerm(weight=w, term=term(k, ml))
                 for w, k, ml, is_anti in preferred if is_anti]
    if aff or anti or preferred:
        a = core.Affinity()
        if aff or pref_aff:
            a.pod_affinity = core.PodAffinity(required=[term(k, ml) for k, ml in aff],
                                              preferred=pref_aff)
        if anti or pref_anti:
            a.pod_anti_affinity = core.PodAffinity(required=[term(k, ml) for k, ml in anti],
                                                   preferred=pref_anti)
        p.spec.affinity = a
    return p


def inject(pkg, specs, extra_reqs=()):
    """Build the window ``specs`` (make_pod kwargs) in ``pkg`` over the fake
    5-type catalog's universe, inject, and return what the injection
    decided: per pod (node selector, unsat, soft votes), and the
    constraints' hostname and node-group requirements."""
    core, wk, fake, universe, aff = PKGS[pkg]
    cons = universe(fake.instance_types(5))
    if extra_reqs:
        cons.requirements = cons.requirements.add(*[
            core.NodeSelectorRequirement(key=k, operator="In", values=list(v))
            for k, v in extra_reqs])
    pods = [make_pod(pkg, **s) for s in specs]
    if pkg == "port":
        aff.AffinityGroups("cpu").inject(cons, pods)
    else:
        aff.AffinityGroups().inject(cons, pods)
    decided = [(dict(p.spec.node_selector), bool(p.__dict__.get("_affinity_unsat")),
                p.__dict__.get("_soft_affinity")) for p in pods]
    reqs = cons.requirements
    return (decided, reqs.requirement(wk.LABEL_HOSTNAME), reqs.requirement(wk.LABEL_NODE_GROUP),
            [aff.has_affinity(p) for p in pods])


def both(same_tokens, specs, extra_reqs=()):
    same_tokens()
    want = inject("jax", specs, extra_reqs)
    same_tokens()
    got = inject("port", specs, extra_reqs)
    assert got == want
    return got


HOST, ZONE = port_wellknown.LABEL_HOSTNAME, port_wellknown.LABEL_TOPOLOGY_ZONE
GROUP = port_wellknown.LABEL_NODE_GROUP
WEB = {"app": "web"}

GROUP_CASES = {
    "affinity pair shares a domain": [
        dict(name="a", labels=WEB, aff=[(HOST, WEB)]), dict(name="b", labels=WEB)],
    "anti-affinity pair separates": [
        dict(name="a", labels=WEB, anti=[(HOST, WEB)]),
        dict(name="b", labels=WEB, anti=[(HOST, WEB)])],
    "conflict inside a component is unsat": [
        dict(name="a", labels=WEB, aff=[(HOST, WEB)], anti=[(HOST, WEB)]),
        dict(name="b", labels=WEB, aff=[(HOST, WEB)])],
    "lonely required affinity sheds": [
        dict(name="a", labels=WEB, aff=[(HOST, {"app": "nothing-matches"})]),
        dict(name="b", labels={"app": "db"})],
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_affinity_groups_cases(same_tokens, case):
    decided, hosts, _, _ = both(same_tokens, GROUP_CASES[case])
    (sa, ua, _), (sb, ub, _) = decided
    if case.startswith("affinity pair"):
        assert sa[HOST] == sb[HOST] and sa[HOST] in hosts
    elif case.startswith("anti"):
        assert sa[HOST] and sb[HOST] and sa[HOST] != sb[HOST]
    else:
        assert ua and sa[HOST] == ""


def test_node_group_key_and_missing_vocabulary(same_tokens):
    """A valued key draws from the provisioner's vocabulary; a key it has
    no vocabulary for sheds the component."""
    decided, _, groups, _ = both(
        same_tokens, [dict(name="a", labels=WEB, aff=[(GROUP, WEB)]), dict(name="b", labels=WEB)],
        extra_reqs=[(GROUP, ["pool-a", "pool-b"])])
    assert decided[0][0][GROUP] == decided[1][0][GROUP] == "pool-a"
    decided, *_ = both(same_tokens, [
        dict(name="a", labels=WEB, aff=[("example.com/unheard-of", WEB)]),
        dict(name="b", labels=WEB)])
    assert decided[0][1] and decided[1][1]


_LBL_KEYS = ("app", "tier", "track")
_LBL_VALS = ("web", "db", "cache", "batch", "canary")
_TOPO_KEYS = (ZONE, HOST)
_ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


def rand_window(rng):
    """tests/test_soft_affinity.py's window draws, plus preferred terms
    (zone- or hostname-keyed, affinity or anti) and zone pins so the votes
    have values to land on."""
    def rterm():
        return (rng.choice(_TOPO_KEYS), {rng.choice(_LBL_KEYS): rng.choice(_LBL_VALS)})

    specs = []
    for i in range(rng.randint(3, 9)):
        labels = {k: rng.choice(_LBL_VALS) for k in rng.sample(_LBL_KEYS, rng.randint(1, 2))}
        aff, anti, pref = [], [], []
        roll = rng.random()
        if roll < 0.45:
            aff.append(rterm())
        elif roll < 0.75:
            anti.append(rterm())
        if rng.random() < 0.15:
            anti.append(rterm())
        if rng.random() < 0.35:
            key, ml = rterm()
            pref.append((rng.choice([1, 7, 50, 100]), key, ml, rng.random() < 0.3))
        pin = {ZONE: rng.choice(_ZONES)} if rng.random() < 0.25 else None
        specs.append(dict(name=f"p{i}", labels=labels, aff=aff, anti=anti, preferred=pref,
                          node_selector=pin))
    return specs


@pytest.mark.parametrize("seed", SEEDS)
def test_injection_fuzz_equals_the_jax_package(same_tokens, seed):
    """180 seeded windows a seed: the same node selectors (zone values and
    hostname domains), the same unsat set, the same soft votes and the
    same admitted hostname domains in both packages."""
    rng = random.Random(seed)
    votes = unsat = 0
    for _ in range(180):
        decided, *_ = both(same_tokens, rand_window(rng))
        votes += sum(1 for _, _, soft in decided if soft)
        unsat += sum(1 for _, u, _ in decided if u)
    assert votes > 0 and unsat > 0  # the fuzz reaches both outcomes


def test_soft_kill_switch_injects_no_votes(same_tokens, monkeypatch):
    monkeypatch.setenv("KARPENTER_SOFT_AFFINITY", "0")
    decided, *_ = both(same_tokens, [
        dict(name="a", labels=WEB, preferred=[(50, ZONE, {"app": "db"}, False)]),
        dict(name="b", labels={"app": "db"}, node_selector={ZONE: "test-zone-1"})])
    assert decided[0][2] is None


def test_soft_votes_follow_the_peers_zone(same_tokens):
    decided, *_ = both(same_tokens, [
        dict(name="a", labels=WEB, preferred=[(50, ZONE, {"app": "db"}, False),
                                              (7, ZONE, {"app": "cache"}, True)]),
        dict(name="b", labels={"app": "db"}, node_selector={ZONE: "test-zone-2"}),
        dict(name="c", labels={"app": "cache"}, node_selector={ZONE: "test-zone-3"})])
    assert decided[0][2] == {(ZONE, "test-zone-2"): 50, (ZONE, "test-zone-3"): -7}


def test_default_device_needs_a_card():
    """The injection, the scheduler and an uncached match matrix run on the
    card unless asked for the CPU, and raise without one."""
    from karpenter_tpu_torch.runtime.kubecore import KubeCore
    from karpenter_tpu_torch.scheduling.scheduler import Scheduler

    sigs = (port_feas.selector_signature(port_core.LabelSelector(match_labels={"a": "b"})),)
    peers = (port_feas.labels_signature({"a": "c"}),)
    for make in (port_aff.AffinityGroups, lambda: Scheduler(KubeCore()),
                 lambda: port_df.affinity_matrix(sigs, peers)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
