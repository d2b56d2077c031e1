"""The port's gang co-pack (B10, B4's rest) against the JAX package's, on the CPU.

The same seeded draws (``random.Random``) build both packages' catalogs,
pods and windows; the port runs with ``device="cpu"``, where the what-if
kernel's wrapper runs its plain version. Every quantity here is an integer
or a bool, so every comparison is exact (tolerance 0):

- the slice algebra (``parse_slice_shape``, ``slice_fits``,
  ``instance_slice_shape``, ``InstanceType.grid_dims``) on a table of
  shapes, and ``tpu_catalog`` type for type;
- ``gang_feasibility_mask`` (the member column on the catalog bit-planes)
  against the JAX package's and against the scalar oracle, over seeded
  random catalogs (the JAX package's ``TestGangFeasibilityFuzz``), with no
  self-heal;
- ``encode_gang_window``: ``d_pods``, ``d_valid``, ``d_compat``,
  ``d_free0``, ``scales``, the bins and the skipped gangs;
- B10: ``solver/gang.gang_scan`` (``whatif_scan`` with every own bin -1,
  on CPU tensors its plain version) against ``_gang_jit`` (XLA on the
  CPU) on ``feasible`` and every slot, over seeded padded windows and
  encoded ones; against ``host_gang`` on ``feasible`` and on the slots of
  feasible rows only (``host_gang`` stops at a gang's first member that
  fits nowhere; ``_gang_jit`` and the kernel go on, ROADMAP §C);
- ``plan_gang_window`` with the device filter and without it, against the
  JAX package's, seeds 1, 7 and 42 and a small config_11: placements with
  their node sets by pod name, unplaced gangs with their reasons.
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.ops import feasibility as jax_feasibility
from karpenter_tpu.solver.gang import GangConfig, _gang_jit
from karpenter_tpu_torch.ops import feasibility as port_feasibility
from karpenter_tpu_torch.solver.gang import gang_scan
from karpenter_tpu_torch.solver.solve import universe_constraints as port_universe

SEEDS = (1, 7, 42)
ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]


def _pkg(root, universe):
    def m(sub):
        return importlib.import_module(f"{root}.{sub}")
    return SimpleNamespace(
        root=root, core=m("api.core"), wk=m("api.wellknown"), gang=m("api.gang"),
        spi=m("cloudprovider.spi"), fake=m("cloudprovider.fake.provider"),
        res=m("utils.resources"), feas=m("ops.feasibility"), og=m("ops.gang"),
        sg=m("solver.gang"), adapter=m("solver.adapter"), ow=m("ops.whatif"),
        universe=universe)


JAX = _pkg("karpenter_tpu", jax_universe)
PORT = _pkg("karpenter_tpu_torch", port_universe)


def pod(P, name, cpu, mem):
    c = P.core
    return c.Pod(
        metadata=c.ObjectMeta(name=name, namespace="default", uid=name),
        spec=c.PodSpec(containers=[c.Container(resources=c.ResourceRequirements.make(
            requests={"cpu": cpu, "memory": mem}))]),
        status=c.PodStatus(phase="Pending"))


def solve_window(P, enc):
    """(feasible, slots) of the package's device path on the CPU."""
    if P is JAX:
        feas, slots, executor = P.sg.solve_gang_window(enc, GangConfig(device_min_cells=0))
    else:
        feas, slots, executor = P.sg.solve_gang_window(enc, device="cpu")
    assert executor == "device-gang"
    return feas, slots


def plan_sig(plan):
    return ([(pl.gang.key, [(bi, [p.metadata.name for p in ps]) for bi, ps in pl.node_sets],
              {bi: tuple(int(c) for c in cells) for bi, cells in pl.carves.items()})
             for pl in plan.placements],
            [(e.key, reason) for e, reason in plan.unplaced],
            [(e.key, c.gang_key) for e, c in plan.preemptions], plan.verified)


# -- the slice algebra ------------------------------------------------------------

SHAPES = ["v5e-4x4", "v4-2x2x4", "v5p-8x16", "v5e-4x8", "v5e-2x2", "v5e-4x4x2", "v4-4x8",
          "", "v5e", "v5e-", "4x4", "v5e-4x0", "v5e-4x-4", "V5E-4x4", "v5e-4x4x", " v5e-2x4 "]


@pytest.mark.parametrize("text", SHAPES)
def test_slice_algebra_equals_jax(text):
    want = JAX.gang.parse_slice_shape(text)
    got = PORT.gang.parse_slice_shape(text)
    assert (got is None) == (want is None)
    if want is None:
        return
    assert (got.family, got.dims, got.chips, str(got)) == \
        (want.family, want.dims, want.chips, str(want))
    assert list(got.coords()) == list(want.coords())
    assert [got.flat_index(c) for c in got.coords()] == [want.flat_index(c) for c in want.coords()]
    for host in SHAPES:
        h_j, h_p = JAX.gang.parse_slice_shape(host), PORT.gang.parse_slice_shape(host)
        assert PORT.gang.slice_fits(h_p, got) == JAX.gang.slice_fits(h_j, want)
    it_j = JAX.fake.make_instance_type("tpu-host", tpu_topology=text.strip())
    it_p = PORT.fake.make_instance_type("tpu-host", tpu_topology=text.strip())
    assert it_p.grid_dims() == it_j.grid_dims()
    assert PORT.gang.instance_slice_shape(it_p) is PORT.gang.instance_slice_shape(it_p)


def test_tpu_catalog_equals_jax():
    fields = ("name", "price", "tpu_topology")
    for a, b in zip(JAX.fake.tpu_catalog(), PORT.fake.tpu_catalog(), strict=True):
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
        assert (a.cpu.nano, a.memory.nano, a.pods.nano) == (b.cpu.nano, b.memory.nano, b.pods.nano)
        assert a.grid_dims() == b.grid_dims()


def gang_pod_spec(P, size, slice_=None):
    p = pod(P, "g-m0", "1", "1Gi")
    p.metadata.labels[P.wk.POD_GROUP_LABEL] = "g"
    p.metadata.labels[P.wk.POD_GROUP_SIZE_LABEL] = size
    if slice_ is not None:
        p.metadata.labels[P.wk.POD_GROUP_SLICE_LABEL] = slice_
    return P.gang.gang_of(p)


@pytest.mark.parametrize("size,slice_", [("4", "v5e-4x4"), ("2", None), ("0", None),
                                         ("x", None), ("2", "bad shape")])
def test_gang_spec_equals_jax(size, slice_):
    want, got = gang_pod_spec(JAX, size, slice_), gang_pod_spec(PORT, size, slice_)
    assert (got.key, got.size, str(got.slice_), got.error, got.group_part) == \
        (want.key, want.size, str(want.slice_), want.error, want.group_part)


# -- the gang feasibility column (B4's rest) --------------------------------------

def fuzz_catalog(P, rng, case):
    topos = ["", "", "v5e-4x4", "v5e-4x8", "v5e-2x2", "v4-2x2x4", "v4-4x4x8"]
    cat = []
    for i in range(rng.randint(1, 8)):
        offerings = [P.spi.Offering(ct, z)
                     for ct in rng.sample(["on-demand", "spot"], rng.randint(1, 2))
                     for z in rng.sample(ZONES, rng.randint(1, 3))]
        cat.append(P.fake.make_instance_type(
            name=f"fuzz-{case}-{i}", offerings=offerings,
            architecture=rng.choice(["amd64", "arm64"]),
            operating_systems=frozenset(rng.sample(["linux", "windows", "darwin"],
                                                   rng.randint(1, 3))),
            nvidia_gpus=rng.choice(["0", "0", "2"]), amd_gpus=rng.choice(["0", "0", "1"]),
            aws_neurons=rng.choice(["0", "0", "4"]), aws_pod_eni=rng.choice(["0", "1"]),
            tpu_topology=rng.choice(topos)))
    names = [it.name for it in cat]
    res = P.res
    keys = []
    for _ in range(rng.randint(1, 4)):
        allowed = (
            frozenset(rng.sample(["on-demand", "spot"], rng.randint(1, 2))),
            frozenset(rng.sample(ZONES, rng.randint(1, 3))),
            frozenset(rng.sample(names, rng.randint(1, len(names)))),
            frozenset(rng.sample(["amd64", "arm64"], rng.randint(1, 2))),
            frozenset(rng.sample(["linux", "windows", "darwin"], rng.randint(1, 3))))
        required = frozenset(rng.sample(
            [res.NVIDIA_GPU, res.AMD_GPU, res.AWS_NEURON, res.AWS_POD_ENI], rng.randint(0, 2)))
        keys.append((allowed, required))
    text = rng.choice([None, "v5e-4x4", "v5e-2x2", "v5e-8x8", "v4-2x2x2", "v5p-4x4"])
    return cat, keys, P.gang.parse_slice_shape(text) if text else None


@pytest.mark.parametrize("seed", SEEDS)
def test_gang_feasibility_mask_equals_jax(seed):
    """120 seeded catalogs a seed: the port's column (member column on the
    planes, slice column, cache) equals the JAX package's and the scalar
    oracle, with no heal."""
    jax_feasibility.clear_catalog_caches()
    port_feasibility.clear_gang_cache()
    port_feasibility.reset_heals()
    draws = random.Random(seed)
    for case in range(120):
        draw = draws.random()
        cat_j, keys_j, shape_j = fuzz_catalog(JAX, random.Random(draw), case)
        cat_p, keys_p, shape_p = fuzz_catalog(PORT, random.Random(draw), case)
        want = jax_feasibility.gang_feasibility_mask(cat_j, keys_j, shape_j)
        got = port_feasibility.gang_feasibility_mask(cat_p, keys_p, shape_p, device="cpu")
        assert np.array_equal(got, want), f"case {case}"
        assert np.array_equal(got, port_feasibility.gang_scalar_mask(cat_p, keys_p, shape_p))
    assert port_feasibility.heal_counts() == {}


def test_gang_column_is_cached_and_counted():
    from karpenter_tpu_torch.ops import device_filter

    port_feasibility.clear_gang_cache()
    cat = PORT.fake.instance_types(4)
    keys = [((frozenset(["on-demand"]), frozenset(ZONES), frozenset(it.name for it in cat),
              frozenset(["amd64"]), frozenset(["linux"])), frozenset())]
    runs = device_filter.GANG_COLUMN_RUNS
    a = port_feasibility.gang_feasibility_mask(cat, keys, None, device="cpu")
    b = port_feasibility.gang_feasibility_mask(cat, list(keys), None, device="cpu")
    assert a is b and not a.flags.writeable and a.all()
    assert device_filter.GANG_COLUMN_RUNS == runs + 1


def test_all_false_column_heals_to_the_oracle(monkeypatch):
    """A member column that says no type fits, where the scalar oracle
    finds one, is replaced by the oracle's and counted."""
    from karpenter_tpu_torch.ops import device_filter

    port_feasibility.clear_gang_cache()
    port_feasibility.reset_heals()
    cat = PORT.fake.instance_types(3)
    keys = [((frozenset(["on-demand"]), frozenset(ZONES), frozenset(it.name for it in cat),
              frozenset(["amd64"]), frozenset(["linux"])), frozenset())]
    monkeypatch.setattr(device_filter, "gang_member_column",
                        lambda its, k, d=None: np.zeros(len(its), bool))
    got = port_feasibility.gang_feasibility_mask(cat, keys, None, device="cpu")
    assert got.all()
    assert port_feasibility.heal_counts() == {"gang-mismatch": 1}


# -- encoded windows ----------------------------------------------------------------

def encode_window(P, seed, catalog_size=6, n_gangs=8, **kwargs):
    """A random gang window over the real packable path (frees = type total
    minus overhead), random feasibility stripes, never empty."""
    rng = random.Random(seed)
    catalog = P.fake.instance_types(catalog_size)
    gangs, all_pods = [], []
    for gi in range(n_gangs):
        size = rng.randint(1, 5)
        pods = [pod(P, f"enc-g{gi}-m{m}", rng.choice(["250m", "500m", "1", "2", "5"]),
                    rng.choice(["256Mi", "512Mi", "1Gi"])) for m in range(size)]
        all_pods += pods
        gangs.append(pods)
    packables, sorted_types = P.adapter.build_packables(
        catalog, P.universe(catalog), all_pods, ())
    frees = [[t - r for t, r in zip(pk.total, pk.reserved)] for pk in packables]
    window = []
    for gi, pods in enumerate(gangs):
        mask = np.array([rng.random() < 0.8 for _ in sorted_types])
        mask[rng.randrange(len(sorted_types))] = True
        window.append(((f"g{gi}",), pods, mask, gi))
    return P.og.encode_gang_window(window, frees, [it.price for it in sorted_types],
                                   [it.name for it in sorted_types], **kwargs)


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_gang_window_equals_jax(seed):
    want, got = encode_window(JAX, seed), encode_window(PORT, seed)
    assert (got.g, got.k, got.b) == (want.g, want.k, want.b)
    assert got.scales == want.scales
    for f in ("d_pods", "d_valid", "d_compat", "d_free0", "compat"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert [(bn.name, bn.type_index, bn.free) for bn in got.bins] == \
        [(bn.name, bn.type_index, bn.free) for bn in want.bins]
    assert [(e.key, e.vecs, e.fresh_cost) for e in got.gangs] == \
        [(e.key, e.vecs, e.fresh_cost) for e in want.gangs]
    assert got.skipped == want.skipped


def jax_gang_jit(pods, valid, compat, free0):
    gb, kb, _ = pods.shape
    f, s = _gang_jit(gb, kb, compat.shape[1])(pods, valid, compat, free0)
    return np.asarray(f), np.asarray(s)


def port_gang_scan(pods, valid, compat, free0):
    f, s = gang_scan(torch.from_numpy(pods), torch.from_numpy(valid),
                     torch.from_numpy(compat), torch.from_numpy(free0))
    return f.numpy(), s.numpy()


def random_padded(rng, GB, KB, BB):
    """Padded gang-window tensors: some padded gangs (no valid member),
    members scattered valid, an all-incompatible row, runs of identical
    members, zero and tight bins."""
    R = 8
    pods = rng.randint(0, 6, size=(GB, KB, R)).astype(np.int32)
    pods[:, :, 3:] = 0
    pods[:, :, 2] = 1
    pods[1] = pods[1, :1]  # a run of identical members
    valid = rng.rand(GB, KB) < 0.8
    valid[-1] = False      # a padded gang
    compat = rng.rand(GB, BB) < 0.6
    compat[0] = False      # all-incompatible
    free0 = rng.randint(0, 12, size=(BB, R)).astype(np.int32)
    free0[:, 3:] = 0
    free0[-1] = 0          # a padded bin
    return pods, valid, compat, free0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(8, 4, 16), (4, 16, 8)])
def test_gang_scan_equals_gang_jit(seed, shape):
    """B10's plain version against _gang_jit, bit for bit: feasible and
    every slot."""
    pods, valid, compat, free0 = random_padded(np.random.RandomState(seed), *shape)
    want = jax_gang_jit(pods, valid, compat, free0)
    got = port_gang_scan(pods, valid, compat, free0)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[0][0] == (not valid[0].any()) and got[0][-1]
    assert (got[1][-1] == -1).all()


def test_fail_then_place_follows_gang_jit():
    """A gang whose first member fits nowhere and whose second does:
    _gang_jit and the port place the second member (the scan never
    breaks); host_gang stops and gives -1 for both. Verdicts agree."""
    pods = np.zeros((4, 4, 8), np.int32)
    pods[0, 0, :3] = (9, 9, 1)
    pods[0, 1, :3] = (2, 2, 1)
    valid = np.zeros((4, 4), bool)
    valid[0, :2] = True
    compat = np.ones((4, 4), bool)
    free0 = np.zeros((4, 8), np.int32)
    free0[:2, :3] = (4, 4, 4)
    want = jax_gang_jit(pods, valid, compat, free0)
    got = port_gang_scan(pods, valid, compat, free0)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert not got[0][0] and got[1][0, :2].tolist() == [-1, 0]


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_and_plan_equal_jax(seed):
    """An encoded window through both packages' device paths: feasible and
    slots equal, equal to host_gang on feasible rows; the filtered and the
    unfiltered plans equal the JAX package's and each other."""
    enc_j, enc_p = encode_window(JAX, seed), encode_window(PORT, seed)
    feas_j, slots_j = solve_window(JAX, enc_j)
    feas_p, slots_p = solve_window(PORT, enc_p)
    assert np.array_equal(feas_p, feas_j) and np.array_equal(slots_p, slots_j)
    feas_h, slots_h = PORT.og.host_gang(enc_p)
    assert np.array_equal(feas_p, feas_h)
    assert np.array_equal(slots_p[feas_p], slots_h[feas_h])
    want = plan_sig(JAX.sg.plan_gang_window(enc_j, feas_j))
    assert plan_sig(PORT.sg.plan_gang_window(enc_p, feas_p)) == want
    plain = plan_sig(PORT.sg.plan_gang_window(enc_p, None))
    assert (plain[0], plain[2]) == (want[0], want[2])
    assert [k for k, _ in plain[1]] == [k for k, _ in want[1]]


def config11_window(P, G=24):
    """config_11 (bench.py:1068-1172) cut to ``G`` gangs over a 20-type
    catalog: 2-4 heavyweight members a gang, the three member shapes."""
    offerings = [P.spi.Offering(ct, f"bench-zone-{z + 1}")
                 for z in range(3) for ct in ("on-demand", "spot")]
    cpus, ratios = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96], [2, 4, 8]
    catalog = []
    for i in range(20):
        cpu, ratio = cpus[i % 10], ratios[(i // 10) % 3]
        catalog.append(P.fake.make_instance_type(
            name=f"syn-{cpu}x{ratio}-{i}", cpu=str(cpu), memory=f"{cpu * ratio}Gi",
            pods=str(min(110, cpu * 15)), offerings=offerings,
            price=0.05 * cpu * (1 + 0.1 * (ratio // 4))))
    constraints = P.universe(catalog)
    shapes = [("2000m", "2048Mi"), ("4000m", "4096Mi"), ("6000m", "6144Mi")]
    gangs, all_pods = [], []
    for gi in range(G):
        k = (2, 3, 4)[gi % 3]
        members = [pod(P, f"gang-{gi}-m{j}", *shapes[(gi + j) % 3]) for j in range(k)]
        all_pods += members
        gangs.append((f"gang-{gi}", members))
    packables, sorted_types = P.adapter.build_packables(catalog, constraints, all_pods, ())
    frees = [[t - r for t, r in zip(pk.total, pk.reserved)] for pk in packables]
    allowed = P.adapter._allowed_sets(constraints)
    required = P.adapter._required_resources(all_pods)
    if P is JAX:
        mask = jax_feasibility.gang_feasibility_mask(sorted_types, [(allowed, required)])
    else:
        mask = port_feasibility.gang_feasibility_mask(sorted_types, [(allowed, required)],
                                                      device="cpu")
    return P.og.encode_gang_window([(key, pods, mask, None) for key, pods in gangs], frees,
                                   [it.price for it in sorted_types],
                                   [it.name for it in sorted_types])


def test_config11_plan_equals_jax():
    enc_j, enc_p = config11_window(JAX), config11_window(PORT)
    assert enc_p.g == 24 and enc_p.device_ready
    feas_j, slots_j = solve_window(JAX, enc_j)
    feas_p, slots_p = solve_window(PORT, enc_p)
    assert np.array_equal(feas_p, feas_j) and np.array_equal(slots_p, slots_j)
    want = plan_sig(JAX.sg.plan_gang_window(enc_j, feas_j))
    got = plan_sig(PORT.sg.plan_gang_window(enc_p, feas_p))
    assert got == want and len(got[0]) == 24
    assert plan_sig(PORT.sg.plan_gang_window(enc_p, None))[0] == want[0]


def test_unencodable_window_is_answered_by_host_gang():
    """A window past MAX_WINDOW_CELLS carries no device arrays: the host
    answers with executor "host-gang"."""
    small = encode_window(PORT, 7, max_cells=16)
    assert small.g == 8 and not small.device_ready
    feas, slots, executor = PORT.sg.solve_gang_window(small, device="cpu")
    assert executor == "host-gang"
    want = PORT.og.host_gang(small)
    assert np.array_equal(feas, want[0]) and np.array_equal(slots, want[1])
