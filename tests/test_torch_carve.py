"""The port's torus carving (B11) and priced preemption against the JAX package's.

Both packages build the same windows from the same seeded draws; the port
runs with ``device="cpu"``. Every comparison is exact (bools and integers):

- ``orientations``, ``placement_masks`` and ``first_carve`` equal the JAX
  package's on 2-D and 3-D grids, wraps included;
- the carve program (``solver/topology.carve_program``: one verdict per
  slice class over int64 cell words, rows gathered by class) against the
  JAX package's ``_carve_jit`` (XLA on the CPU), ``host_carve`` and the
  scalar scan over seeded windows of 2-D and 3-D grids, gridless bins and
  gangs without a slice, padded rows and bins included; grids of 64 and
  128 cells take one and two words;
- the gang window with carving through both packages' device paths
  (feasible and slots) and their planners (phantom capacity refused,
  carves, seed reuse);
- the occupancy ledger's commit, release, prune and snapshot;
- the JAX package's ``TestPricedPreemption`` cases through both planners:
  placements, preemptions, unplaced reasons and the declined reasons;
- the probe self-heal: an inverted carve verdict fails its probes,
  ``solver/topology.HEALS`` counts it, the kernel runs again on the scalar
  verdict and the plan equals the plain host plan;
- the ``KARPENTER_TOPOLOGY_CARVE`` switch in both packages.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.solver.gang import GangConfig
from karpenter_tpu.solver.topology import _carve_jit
from karpenter_tpu_torch.solver import topology as port_topo_solver

SEEDS = (1, 7, 42)


def _pkg(root):
    def m(sub):
        return importlib.import_module(f"{root}.{sub}")
    return SimpleNamespace(
        root=root, core=m("api.core"), topo=m("ops.topology"), og=m("ops.gang"),
        sg=m("solver.gang"), st=m("solver.topology"), ow=m("ops.whatif"))


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")


def pod(P, name, cpu="1", mem="1Gi"):
    c = P.core
    return c.Pod(metadata=c.ObjectMeta(name=name, namespace="default", uid=name),
                 spec=c.PodSpec(containers=[c.Container(resources=c.ResourceRequirements.make(
                     requests={"cpu": cpu, "memory": mem}))]))


def window(P, gang_specs, types, seed_bins=None, grow=True):
    """``gang_specs`` = (key, members, slice dims, band); ``types`` = (name,
    price, grid). Every type's free vector is 100 member pods, so resources
    never bind unless a case saturates them on purpose."""
    unit = [max(v, 1) for v in P.ow._reserve_vec(pod(P, "probe"))]
    big = [v * 100 for v in unit]
    gangs, slices, bands = [], [], []
    for key, n, sdims, band in gang_specs:
        gangs.append((key, [pod(P, f"{key}-m{i}") for i in range(n)],
                      np.ones(len(types), bool), None))
        slices.append(sdims)
        bands.append(band)
    enc = P.og.encode_gang_window(
        gangs, [list(big) for _ in types], [t[1] for t in types], [t[0] for t in types],
        slices=slices, bands=bands, type_grids=[t[2] for t in types],
        seed_bins=[P.og.GangBin(name=n, type_index=ti, free=list(f), grid=g,
                                occ=np.asarray(o, bool), node_name=n)
                   for n, ti, f, g, o in (seed_bins or [])],
        grow=grow)
    return enc, unit, big


def plan_sig(plan):
    return ([(pl.gang.key, [(bi, [p.metadata.name for p in ps]) for bi, ps in pl.node_sets],
              {bi: tuple(int(c) for c in cells) for bi, cells in pl.carves.items()})
             for pl in plan.placements],
            [(e.key, reason) for e, reason in plan.unplaced],
            [(e.key, c.gang_key) for e, c in plan.preemptions], plan.verified)


# -- the placement algebra ------------------------------------------------------------

GRIDS = [(2, 2), (4, 4), (2, 8), (4, 8), (2, 2, 4), (4, 4, 2), (8, 8), (4, 4, 8)]
SLICES = [(1, 2), (2, 2), (2, 4), (4, 4), (2, 2, 2), (8, 2), (1, 1), (4, 2, 2), (3, 1)]


@pytest.mark.parametrize("grid", GRIDS)
def test_placement_algebra_equals_jax(grid):
    rng = np.random.RandomState(sum(grid))
    for sl in SLICES:
        assert PORT.topo.orientations(sl, len(grid)) == JAX.topo.orientations(sl, len(grid))
        want = JAX.topo.placement_masks(grid, sl)
        got = PORT.topo.placement_masks(grid, sl)
        assert (got is None) == (want is None)
        if want is not None:
            assert np.array_equal(got, want)
        for density in (0.0, 0.3, 0.6, 0.9):
            occ = rng.rand(PORT.topo.grid_cells(grid)) < density
            assert PORT.topo.first_carve(occ, grid, sl) == JAX.topo.first_carve(occ, grid, sl)
        # a carve wraps: occupy the grid's middle rows, free rows 0 and last
        occ = np.ones(PORT.topo.grid_cells(grid), bool)
        row = PORT.topo.grid_cells(grid) // grid[0]
        occ[:row] = occ[-row:] = False
        assert PORT.topo.first_carve(occ, grid, sl) == JAX.topo.first_carve(occ, grid, sl)


# -- the carve program against _carve_jit ---------------------------------------------

class _Gang:
    def __init__(self, index, slice_dims):
        self.index, self.slice_dims = index, slice_dims


class _Bin:
    def __init__(self, grid, occ):
        self.grid, self.occ = grid, occ


class _Enc:
    def __init__(self, gangs, bins):
        self.gangs, self.bins, self.g, self.b = gangs, bins, len(gangs), len(bins)


def fuzz_enc(rng, grids, slices, max_g=6, max_b=6):
    bins = []
    for _ in range(rng.randint(1, max_b)):
        grid = grids[rng.randint(0, len(grids))]
        if grid is None:
            bins.append(_Bin(None, None))
        else:
            occ = rng.rand(PORT.topo.grid_cells(grid)) < rng.choice([0.0, 0.3, 0.6, 0.9])
            bins.append(_Bin(grid, occ))
    gangs = [_Gang(i, slices[rng.randint(0, len(slices))]) for i in range(rng.randint(1, max_g))]
    return _Enc(gangs, bins)


def jax_carve(cv):
    f = _carve_jit(cv.d_scls.shape[0], cv.d_occ.shape[0], cv.d_pmask.shape[0],
                   cv.d_pmask.shape[1], cv.d_pmask.shape[2], cv.d_pmask.shape[3])
    return np.asarray(f(cv.d_occ, cv.d_cls, cv.d_scls, cv.d_pmask, cv.d_pvalid))


def port_carve(cv):
    tensors = [torch.from_numpy(np.ascontiguousarray(a))
               for a in PORT.st.carve_arrays(cv)]
    return PORT.st.carve_program(*tensors).numpy()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", ["2d", "3d", "wide"])
def test_carve_program_equals_carve_jit(seed, family):
    """The padded (GB, BB) verdict bit for bit against _carve_jit, and its
    live (G, B) part against host_carve and the scalar scan of both
    packages."""
    grids = {"2d": [(2, 2), (4, 4), (2, 8), (4, 8), None],
             "3d": [(2, 2, 4), (4, 4, 2), (2, 2, 2), None],
             "wide": [(8, 8), (8, 16), (4, 4), None]}[family]
    slices = {"2d": [(1, 2), (2, 2), (2, 4), (4, 4), (8, 2), None],
              "3d": [(2, 2), (2, 2, 2), (4, 2), (1, 1, 2), None],
              "wide": [(4, 4), (2, 8), (8, 8), (3, 3), None]}[family]
    rng = np.random.RandomState(seed)
    for case in range(12):
        enc = fuzz_enc(rng, grids, slices)
        cv = PORT.topo.encode_carve(enc, gb=8, bb=8)
        if cv is None:
            continue
        cv_j = JAX.topo.encode_carve(enc, gb=8, bb=8)
        for f in ("d_occ", "d_cls", "d_scls", "d_pmask", "d_pvalid"):
            assert np.array_equal(getattr(cv, f), getattr(cv_j, f)), f
        got = port_carve(cv)
        assert np.array_equal(got, jax_carve(cv_j)), f"{family} seed {seed} case {case}"
        live = got[:enc.g, :enc.b]
        assert np.array_equal(live, PORT.topo.host_carve(cv))
        assert np.array_equal(live, PORT.topo.scalar_carve(enc))
        assert np.array_equal(live, JAX.topo.scalar_carve(enc))
        for gi in range(enc.g):
            for bi in range(enc.b):
                assert PORT.topo.scalar_carve_cell(enc, gi, bi) == live[gi, bi]


def test_carve_program_walks_slice_classes_in_steps(monkeypatch):
    """A step bound smaller than one class gives the same verdict."""
    enc = fuzz_enc(np.random.RandomState(3), [(4, 4), (2, 8)], [(2, 2), (1, 4), (2, 4)],
                   max_g=8, max_b=8)
    cv = PORT.topo.encode_carve(enc, gb=8, bb=8)
    want = port_carve(cv)
    monkeypatch.setattr(PORT.st, "_STEP_WORDS", 1)
    assert np.array_equal(port_carve(cv), want)


# -- the gang window with carving -----------------------------------------------------

CARVE_WINDOWS = [
    ([("g0", 2, (2, 2), "default"), ("g1", 2, (4, 4), "default"), ("g2", 2, None, "default")],
     [("tpu-a", 1.0, (4, 4)), ("tpu-b", 2.0, (4, 8))]),
    ([("a", 2, (4, 4), "default"), ("b", 2, (4, 4), "default"), ("c", 3, (2, 2), "high")],
     [("tpu-a", 1.0, (4, 4))]),
    ([("cube", 2, (2, 2, 2), "default"), ("line", 4, (1, 4), "low"), ("flat", 2, None, "low")],
     [("tpu-v4", 3.0, (2, 2, 4)), ("tpu-a", 4.0, (4, 4)), ("cpu", 9.0, None)]),
]
FRAGMENTED = np.array([(r + c) % 2 == 0 for r in range(4) for c in range(4)], bool)


@pytest.mark.parametrize("case", range(len(CARVE_WINDOWS)))
@pytest.mark.parametrize("seeded", [False, True])
def test_carve_gang_window_equals_jax(case, seeded):
    """Both packages' device paths (carve program, AND into compat, first
    fit) give the same feasible and slots, and both planners the same plan
    (carves included); a fragmented seed torus is offered first."""
    specs, types = CARVE_WINDOWS[case]

    def seeds(P):
        if not seeded:
            return None
        unit = [max(v, 1) for v in P.ow._reserve_vec(pod(P, "probe"))]
        return [("frag", 0, [v * 100 for v in unit], types[0][2], FRAGMENTED
                 if types[0][2] == (4, 4) else np.zeros(16, bool))]

    enc_j, _, _ = window(JAX, specs, types, seeds(JAX))
    enc_p, _, _ = window(PORT, specs, types, seeds(PORT))
    assert enc_p.carve is not None
    feas_j, slots_j, ex_j = JAX.sg.solve_gang_window(enc_j, GangConfig(device_min_cells=0))
    feas_p, slots_p, ex_p = PORT.sg.solve_gang_window(enc_p, device="cpu")
    assert (ex_j, ex_p) == ("device-gang", "device-gang")
    assert np.array_equal(feas_p, feas_j) and np.array_equal(slots_p, slots_j)
    want = plan_sig(JAX.sg.plan_gang_window(enc_j, feas_j))
    assert plan_sig(PORT.sg.plan_gang_window(enc_p, feas_p)) == want
    # unfiltered, the same placements (an unplaced gang's reason says
    # whether the filter skipped it)
    plain = plan_sig(PORT.sg.plan_gang_window(enc_p, None))
    assert (plain[0], plain[2]) == (want[0], want[2])


@pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])
def test_phantom_capacity_is_refused(P):
    """Resources fit on the checkerboarded seed torus, chips do not: the
    carve walk rejects the bin (once per walk) and carves a fresh one."""
    rejects = 0 if P is JAX else PORT.og.CARVE_REJECTS
    unit = [max(v, 1) for v in P.ow._reserve_vec(pod(P, "probe"))]
    big = [v * 100 for v in unit]
    enc, _, _ = window(P, [("memo", 3, (2, 2), "default")], [("tpu-a", 1.0, (4, 4))],
                       seed_bins=[("frag-node", 0, big, (4, 4), FRAGMENTED)])
    plan = P.sg.plan_gang_window(enc)
    assert len(plan.placements) == 1
    assert 0 not in {bi for bi, _ in plan.placements[0].node_sets}
    assert plan.placements[0].carves
    if P is PORT:
        assert PORT.og.CARVE_REJECTS == rejects + 1


# -- the occupancy ledger --------------------------------------------------------------

def test_ledger_round_trip_equals_jax():
    out = []
    for P in (JAX, PORT):
        led = P.topo.OccupancyLedger()
        led.commit("n1", (4, 4), "tpu-a", (), ("ns", "g1"), [0, 1, 4, 5], "default",
                   [("ns", "p0")])
        led.commit("n2", (4, 4), "tpu-a", (), ("ns", "g2"), [0, 1], "low", [("ns", "p1")])
        led.commit("n2", (4, 4), "tpu-a", (), ("ns", "g3"), [8, 9], "low", [("ns", "p2")])
        led.commit("n1", (4, 4), "tpu-a", (), ("ns", "g1"), [0, 1, 4, 5], "default",
                   [("ns", "p0")])
        snap = led.snapshot()
        snap[0].occ[:] = False  # a snapshot is a copy
        steps = [[(ng.node, ng.dims, ng.occ.tolist(), sorted(map(str, ng.carves)))
                  for ng in led.snapshot()]]
        steps.append([name for name, _ in led.pop_gang(("ns", "g1"))])
        steps.append([r.gang_key for r in led.pop_node("n2")])
        steps.append(led.node_count())
        led.commit("n3", (2, 2), "t", (), "g", [0], "low", [])
        steps.append([r.gang_key for r in led.prune(["other"])])
        steps.append(led.node_count())
        out.append(steps)
    assert out[0] == out[1]
    assert out[1][1] == ["n1"] and out[1][3] == 0


# -- priced preemption ----------------------------------------------------------------

def preemption_case(P, name):
    """The JAX package's TestPricedPreemption windows, built in ``P``."""
    C = P.sg.PreemptCandidate
    if name == "full-pool":
        unit = [max(v, 1) for v in P.ow._reserve_vec(pod(P, "probe"))]
        seed = P.og.GangBin(name="node-a", type_index=0, free=list(unit), grid=(4, 4),
                            occ=np.ones(16, bool), node_name="node-a")
        enc = P.og.encode_gang_window(
            [("sp", [pod(P, "sp-m0"), pod(P, "sp-m1")], np.ones(1, bool), None)],
            [list(unit)], [1.0], ["tpu-a"], slices=[(2, 2)], bands=["high"],
            type_grids=[(4, 4)], seed_bins=[seed])
        enc.bins[2].free = [0] * len(unit)
        ctx = P.sg.PreemptContext([C(gang_key=("d", "lo"), bin_index=0, node="node-a",
                                     band="low", pods=[("d", "lo-m0")], cells=np.arange(16),
                                     refund=[0] * len(unit), displacement_cost=0.1)])
        return enc, ctx
    _, unit, big = window(P, [("hi", 2, (2, 2), "high")], [("tpu-a", 1.0, (4, 4))])
    saturated = ("node-a", 0, [v // 100 for v in big], (4, 4), np.ones(16, bool))
    if name == "shared-bin":
        enc, _, _ = window(P, [("hi", 2, (2, 2), "high")], [("tpu-a", 1.0, (4, 4))],
                           seed_bins=[("node-a", 0, big, (4, 4), np.ones(16, bool))],
                           grow=False)
        return enc, P.sg.PreemptContext([
            C(gang_key=("d", "a"), bin_index=0, node="node-a", band="low",
              pods=[("d", "a-m0")], cells=np.arange(4), refund=list(unit),
              displacement_cost=0.1),
            C(gang_key=("d", "b"), bin_index=0, node="node-a", band="low",
              pods=[("d", "b-m0")], cells=np.array([5, 10]), refund=list(unit),
              displacement_cost=0.2)])
    band, cost, refund, grow = {
        "cheap": ("low", 0.3, big, True), "fresh-cheaper": ("low", 1.5, big, True),
        "system-critical": ("system-critical", 0.3, big, True),
        "equal-band": ("high", 0.3, big, True),
        "no-help": ("low", 0.1, [0] * len(big), False)}[name]
    enc, _, _ = window(P, [("hi", 2, (2, 2), "high")], [("tpu-a", 1.0, (4, 4))],
                       seed_bins=[saturated], grow=grow)
    return enc, P.sg.PreemptContext([C(
        gang_key=("d", "lo"), bin_index=0, node="node-a", band=band,
        pods=[("d", "lo-m0"), ("d", "lo-m1")], cells=np.arange(16), refund=list(refund),
        displacement_cost=cost)])


def jax_declines():
    from karpenter_tpu.metrics.topology import PREEMPTION_DECLINED_TOTAL
    return {dict(k).get("reason"): v for k, v in PREEMPTION_DECLINED_TOTAL.collect().items()}


@pytest.mark.parametrize("name", ["cheap", "fresh-cheaper", "system-critical", "equal-band",
                                  "no-help", "shared-bin", "full-pool"])
def test_priced_preemption_equals_jax(name):
    enc_j, ctx_j = preemption_case(JAX, name)
    enc_p, ctx_p = preemption_case(PORT, name)
    before_j = jax_declines()
    PORT.sg.DECLINES.clear()
    want = JAX.sg.plan_gang_window(enc_j, preempt=ctx_j)
    got = PORT.sg.plan_gang_window(enc_p, preempt=ctx_p)
    assert plan_sig(got) == plan_sig(want)
    after_j = jax_declines()
    assert PORT.sg.DECLINES == {r: after_j[r] - before_j.get(r, 0.0)
                                for r in after_j if after_j[r] != before_j.get(r, 0.0)}
    assert [c.taken for c in ctx_p.candidates] == [c.taken for c in ctx_j.candidates]
    if name == "cheap":
        assert got.preemptions and {bi for bi, _ in got.placements[0].node_sets} == {0}
    if name in ("no-help", "shared-bin"):
        assert not got.placements and not any(c.taken for c in ctx_p.candidates)


def test_shared_bin_rollback_restores_newest_first():
    enc, ctx = preemption_case(PORT, "shared-bin")
    free_state = [list(bn.free) for bn in enc.bins]
    occ_state = [enc.bins[0].occ.copy()]
    before = [list(v) for v in free_state]
    plan = PORT.sg.GangPlan()
    assert PORT.sg._attempt_preemption(enc, enc.gangs[0], free_state, occ_state, {}, ctx,
                                       plan) is None
    assert plan.verified == 2 and free_state == before and occ_state[0].all()


# -- the probe self-heal and the switch ------------------------------------------------

def test_probe_sabotage_heals_and_relaunches(monkeypatch):
    """Invert the carve verdict inside the dispatch: the probes condemn
    it, HEALS counts one, the kernel runs again on the scalar verdict and
    the plan is the plain host plan node for node."""
    specs, types = [("g0", 2, (2, 2), "default"), ("g1", 2, (2, 4), "default")], \
        [("tpu-a", 1.0, (4, 4))]
    enc_ref, _, _ = window(PORT, specs, types)
    ref = plan_sig(PORT.sg.plan_gang_window(enc_ref))
    real = PORT.st.carve_program
    monkeypatch.setattr(PORT.st, "carve_program", lambda *a: ~real(*a))
    heals = PORT.st.HEALS
    enc, _, _ = window(PORT, specs, types)
    handle = PORT.sg.dispatch_gang_window(enc, device="cpu")
    feas, slots, executor = handle.fetch()
    assert executor == "device-gang" and handle.healed
    assert PORT.st.HEALS == heals + 1
    want = PORT.og.host_gang(enc, PORT.topo.scalar_carve(enc))
    assert np.array_equal(feas, want[0])
    assert plan_sig(PORT.sg.plan_gang_window(enc, feas))[:3] == ref[:3]
    # the handle keeps the tensors of the relaunch: compat AND the scalar verdict
    launched = handle.inputs[2][:enc.g, :enc.b].numpy()
    assert np.array_equal(launched, (enc.d_compat[:enc.g, :enc.b] != 0)
                          & PORT.topo.scalar_carve(enc))
    again = PORT.sg.gang_scan(*handle.inputs)
    assert np.array_equal(again[0].numpy()[:enc.g], feas)
    assert np.array_equal(again[1].numpy()[:enc.g, :max(enc.k, 1)], slots)


def test_check_probes_heals_to_scalar():
    enc, _, _ = window(PORT, [("g0", 2, (2, 2), "default")], [("tpu-a", 1.0, (4, 4))])
    want = PORT.topo.scalar_carve(enc)
    heals = PORT.st.HEALS
    ok, healed = PORT.st.check_probes(enc, ~want)
    assert not ok and np.array_equal(healed, want) and PORT.st.HEALS == heals + 1
    verdict, executor = PORT.st.solve_carve_window(enc, device="cpu")
    assert executor == "device-carve" and np.array_equal(verdict, want)
    assert PORT.st.probe_pairs(5, 7, 8) == JAX.st.probe_pairs(5, 7, 8)


@pytest.mark.parametrize("value,on", [("", True), ("0", False), ("off", False), ("1", True)])
def test_carve_switch_reads_as_jax(monkeypatch, value, on):
    monkeypatch.setenv("KARPENTER_TOPOLOGY_CARVE", value)
    assert port_topo_solver.carve_enabled() is on
    assert JAX.st.carve_enabled() is on


def test_unannotated_window_is_shape_only():
    specs = [("ks", 4, None, "default")]
    enc, _, _ = window(PORT, specs, [("tpu-a", 4.0, (4, 4))])
    plain = PORT.og.encode_gang_window(
        [(e.key, e.pods, e.type_mask, None) for e in enc.gangs],
        [bn.free for bn in enc.bins[:1]], [4.0], ["tpu-a"])
    assert enc.carve is None and plain.carve is None
    for f in ("d_pods", "d_valid", "d_compat", "d_free0"):
        assert np.array_equal(getattr(enc, f), getattr(plain, f))
