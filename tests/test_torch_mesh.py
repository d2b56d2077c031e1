"""The port's solver mesh (parallel/mesh.py) against the JAX package's.

The JAX package splits every device window's batch axis over
``solver_mesh()``, here the eight virtual CPU devices of
``tests/conftest.py``. The port splits it over ``["cpu"] * n`` for n in 1,
2, 3 and 8: the batch padded to a multiple of n, a contiguous range of rows
a shard, each shard's launches and copies on its device, the results
gathered in batch order. Every window is built separately in both
packages from the same seeded numbers (the window functions of
``tests.test_torch_batch_solve``, ``tests.test_torch_global_solve``,
``tests.test_torch_whatif``, ``tests.test_torch_gang`` and
``tests.test_torch_carve``) and must give the same answer:

- the provisioning window (``solve_batch``), ``repack_plan_multi``, the
  what-if and the gang windows bit for bit, problem for problem;
- the global window the same plans and accept/decline verdicts, exactly:
  its relaxation is float32, but its rows are independent, so a shard's
  smaller batch changes no row's sums, and the shards' node counts are
  the one-device run's to the bit (tolerance 0).

A one-device mesh must take exactly the route it took before the mesh: one
launch a chunk over every row, no padding.
"""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.models import consolidate as jax_consolidate
from karpenter_tpu.ops import global_solve as jax_gops
from karpenter_tpu.solver import batch_solve as jax_batch
from karpenter_tpu.solver import global_solve as jax_gs
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu.solver.gang import GangConfig
from karpenter_tpu.solver.whatif import WhatIfConfig
from karpenter_tpu_torch.models import consolidate as port_consolidate
from karpenter_tpu_torch.ops import device_filter, pack_cuda
from karpenter_tpu_torch.ops import global_solve as port_gops
from karpenter_tpu_torch.parallel import batched_pack
from karpenter_tpu_torch.parallel import mesh as port_mesh
from karpenter_tpu_torch.solver import batch_solve, pipeline
from karpenter_tpu_torch.solver import global_solve as port_gs
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.solver import warmup
from tests import test_torch_carve as carve_t
from tests import test_torch_gang as gang_t
from tests import test_torch_global_solve as global_t
from tests import test_torch_whatif as whatif_t
from tests.test_torch_batch_solve import executors, window
from tests.test_torch_solve import canonical

MESHES = (1, 2, 3, 8)


def cpu_mesh(n):
    return port_mesh.solver_mesh(["cpu"] * n)


# -- the provisioning window ---------------------------------------------------

# (seed, problems, pods each, types, shapes, extra, config): B = 5 and 4
# divide over none or some of the meshes, B = 2 is fewer problems than 3 or
# 8 shards; chunk_iters=2 resumes every shard many times and compacts
# them at different chunks; the priced windows take the scoring program
# (fused) and the host loop, "mixed-prices" gives problem 1 an unpriced
# catalog (so the fused mask declines and its row is unpriced beside
# priced ones), "unencodable" leaves one member to the solo route
WINDOWS = {
    "fused": (1, 5, 90, 36, 40, None, {}),
    "host-filtered": (7, 4, 80, 30, 30, None, {"device_filter": False}),
    "two-problems": (6, 2, 60, 24, 20, None, {}),
    "chunked": (11, 4, 150, 30, 120, None, {"chunk_iters": 2}),
    "priced-fused": (12, 5, 100, 36, 40, None, {"cost_tiebreak": True}),
    "priced-host": (12, 4, 100, 36, 40, None, {"cost_tiebreak": True,
                                               "device_filter": False}),
    "mixed-prices": (13, 5, 80, 30, 30, "mixed-prices", {"cost_tiebreak": True}),
    "unencodable": (8, 4, 70, 24, 20, "unencodable", {}),
}
_JAX_ANSWERS: dict = {}


def build_window(pkg, name):
    seed, n, pods_each, n_types, n_shapes, extra, _ = WINDOWS[name]
    probs = window(pkg, seed, n, pods_each, n_types, n_shapes,
                   extra if extra != "mixed-prices" else None)
    if extra == "mixed-prices":
        unpriced = [dataclasses.replace(it, price=0.0) for it in probs[1].instance_types]
        probs[1] = dataclasses.replace(probs[1], instance_types=unpriced)
    return probs


def jax_answer(name):
    """The JAX package's window on its eight-device mesh, computed once."""
    if name not in _JAX_ANSWERS:
        probs = build_window("jax", name)
        got = jax_batch.solve_batch(probs, jax_solve_mod.SolverConfig(
            device_timeout_s=0, device_hedge=False, **WINDOWS[name][-1]))
        _JAX_ANSWERS[name] = [canonical(r, p.pods) for r, p in zip(got, probs)]
    return _JAX_ANSWERS[name]


def port_window(name, n, **extra_cfg):
    probs = build_window("port", name)
    port_solve_mod.reset_executor_counts()
    device_filter.reset_fallback_counts()
    cfg = port_solve_mod.SolverConfig(device_min_pods=0, **WINDOWS[name][-1], **extra_cfg)
    handle = batch_solve.dispatch_batch(probs, cfg, device=cpu_mesh(n))
    return handle, [canonical(r, p.pods) for r, p in zip(handle.fetch(), probs)]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_over_the_mesh_matches_jax(name, n):
    handle, got = port_window(name, n)
    assert got == jax_answer(name)
    run = handle.device_run
    assert run is not None and len(run.shards) == n
    B = len(run.encs)
    per = -(-B // n)
    assert [sh.rows for sh in run.shards] == [per] * n
    assert [sh.device for sh in run.shards] == list(cpu_mesh(n))
    assert device_filter.fallback_counts().get("device-mask-mismatch", 0) == 0
    batched = sum(v for k, v in executors().items() if k == "device-batch")
    assert batched == B
    if handle.fused is not None:
        assert len(handle.fused.shards) == n
        mask = torch.cat([m for m, _ in handle.fused.masks]).numpy()
        assert mask.shape[0] == per * n and not mask[B:].any()  # padding rejects all


@pytest.mark.parametrize("n", (2, 3, 8))
def test_chunked_shards_resume_and_compact_on_their_own(n):
    """Two node decisions a chunk: every shard with a real row resumes and
    compacts its own rows, a shard of padding rows finishes in its first
    chunk, and the shards finish at different chunks."""
    handle, got = port_window("chunked", n)
    assert got == jax_answer("chunked")
    run = handle.device_run
    live = [sh for sh in run.shards if any(r for r in sh.records)]
    assert all(sh.launches > 1 and len(sh.buckets) > 1 for sh in live)
    padding = [sh for sh in run.shards if sh.shard.start >= len(run.encs)]
    assert all(sh.launches == 1 and sh.buckets == [run.S0] for sh in padding)
    assert len(live) + len(padding) == n
    assert all(sh.buckets == sorted(sh.buckets, reverse=True) for sh in run.shards)
    assert len({sh.launches for sh in run.shards}) > 1
    assert run.launches == sum(sh.launches for sh in run.shards)


# -- the launches a mesh makes ---------------------------------------------------

@pytest.fixture
def launch_spy(monkeypatch):
    """Every pack launch of the window: (entry, rows, device)."""
    calls = []
    real_batch, real_chunk = batched_pack.pack_batch, pack_cuda.pack_chunk

    def spy_batch(shapes, *a, **k):
        calls.append(("pack_batch", shapes.shape[0], shapes.device))
        return real_batch(shapes, *a, **k)

    def spy_chunk(shapes, *a, **k):
        calls.append(("pack_chunk", 1, shapes.device))
        return real_chunk(shapes, *a, **k)

    monkeypatch.setattr(batched_pack, "pack_batch", spy_batch)
    monkeypatch.setattr(pack_cuda, "pack_chunk", spy_chunk)
    return calls


@pytest.mark.parametrize("name", ["fused", "chunked"])
def test_one_device_mesh_makes_todays_launches(name, launch_spy):
    """A one-device mesh is one shard of every row: one pack_batch launch a
    chunk over the B problems, no padding row, and no slot name of a
    second shard."""
    pipeline.reset_ring()
    handle, got = port_window(name, 1)
    assert got == jax_answer(name)
    run = handle.device_run
    B = len(run.encs)
    assert launch_spy == [("pack_batch", B, torch.device("cpu"))] * run.launches
    assert run.shards[0].rows == B and run.buckets == run.shards[0].buckets
    slot_names = {n for s in pipeline.get_ring()._slots for n in s.arrays}
    assert not any("@" in n for n in slot_names)


def test_the_default_device_mesh_is_the_one_shard_route(launch_spy):
    """``device="cpu"`` (one named device) and ``["cpu"]`` are the same
    mesh, and so the same launches."""
    probs = build_window("port", "fused")
    cfg = port_solve_mod.SolverConfig(device_min_pods=0)
    a = [canonical(r, p.pods) for r, p in
         zip(batch_solve.solve_batch(probs, cfg, device="cpu"), probs)]
    first = list(launch_spy)
    launch_spy.clear()
    b = [canonical(r, p.pods) for r, p in
         zip(batch_solve.solve_batch(probs, cfg, device=["cpu"]), probs)]
    assert a == b and launch_spy == first


@pytest.mark.parametrize("n", (3, 8))
def test_each_shard_launches_on_its_mesh_device(n, launch_spy):
    """The first chunk of a 5-problem window over n shards: one launch a
    shard, each over the shard's rows on its device, all enqueued before
    anything waits."""
    probs = build_window("port", "fused")
    cfg = port_solve_mod.SolverConfig(device_min_pods=0)
    mesh = cpu_mesh(n)
    handle = batch_solve.dispatch_batch(probs, cfg, device=mesh)
    per = -(-len(probs) // n)
    entry = "pack_chunk" if per == 1 else "pack_batch"
    assert launch_spy == [(entry, per, d) for d in mesh]
    run = handle.device_run
    for sh, d in zip(run.shards, mesh):
        assert sh.device == d and sh.shapes_d.device == d and sh.valid_d.device == d
    handle.fetch()


def test_a_failing_shard_launch_raises(monkeypatch):
    """No fallback: a launch that fails on the second shard raises out of
    dispatch_batch; no other shard or device answers the window."""
    real, calls = batched_pack.pack_batch, []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("pack kernel launch failed (injected)")
        return real(*a, **k)

    monkeypatch.setattr(batched_pack, "pack_batch", failing)
    probs = build_window("port", "host-filtered")
    port_solve_mod.reset_executor_counts()
    with pytest.raises(RuntimeError, match="injected"):
        batch_solve.dispatch_batch(probs, port_solve_mod.SolverConfig(
            device_min_pods=0, device_filter=False), device=cpu_mesh(2))
    assert executors() == {}


def test_a_failing_shard_copy_raises(monkeypatch):
    """A shard whose chunk cannot come back to the host makes fetch()
    raise, and raise again."""
    probs = build_window("port", "fused")
    handle = batch_solve.dispatch_batch(probs, port_solve_mod.SolverConfig(device_min_pods=0),
                                        device=cpu_mesh(2))
    shard = handle.device_run.shards[1]

    class Lost:
        def cpu(self):
            raise RuntimeError("injected copy fault")

    flat, counts_next, dropped_next = shard._pending
    shard._pending = (Lost(), counts_next, dropped_next)
    port_solve_mod.reset_executor_counts()
    with pytest.raises(RuntimeError, match="injected"):
        handle.fetch()
    with pytest.raises(RuntimeError, match="earlier fetch"):
        handle.fetch()
    assert executors() == {}


def test_a_repeat_window_over_the_mesh_refills_every_shard_in_place():
    """The ring holds a tensor a shard in one slot: the same window again
    over the same mesh makes no fresh allocation."""
    pipeline.reset_ring()
    mesh = cpu_mesh(3)
    cfg = port_solve_mod.SolverConfig(device_min_pods=0)
    batch_solve.solve_batch(build_window("port", "fused"), cfg, device=mesh)
    first = pipeline.get_ring().counters()
    names = {n for s in pipeline.get_ring()._slots for n in s.arrays}
    assert {"shapes", "shapes@1", "shapes@2", "counts@2"} <= names
    batch_solve.solve_batch(build_window("port", "fused"), cfg, device=mesh)
    again = pipeline.get_ring().counters()
    assert again["allocations"] == first["allocations"] and again["slots"] == first["slots"]


def test_an_all_padding_row_finishes_with_no_error():
    """pad_problems' padding problem (count 0, no valid type, pods_unit 1)
    through pack_batch: done in its first chunk, nothing packed or
    dropped, its error word 0 (unpack_batch_flat raises on one)."""
    from karpenter_tpu_torch.ops.encode import encode, pad_encoding
    from karpenter_tpu_torch.ops.pack import compute_maxfit

    probs = build_window("port", "host-filtered")
    prepared = batch_solve._prepare(probs[0], batch_solve.marshal_pods_interned(probs[0].pods))
    packables, _, vecs, sids, version = prepared
    enc = pad_encoding(encode(vecs, list(range(len(probs[0].pods))), packables, pad=False,
                              sids=sids, catalog_version=version))
    arrays = batched_pack.pad_problems([enc], 4)
    *host, B = arrays
    assert B == 1 and host[0].shape[0] == 4
    shapes, counts, dropped, totals, reserved0, valid, last_valid, pods_unit = (
        torch.from_numpy(a) for a in host)
    assert not valid[1:].any() and not counts[1:].any() and (pods_unit[1:] == 1).all()
    maxfit = compute_maxfit(shapes, totals, reserved0, valid)
    flat = batched_pack.pack_batch(shapes, counts, dropped, totals, reserved0, valid,
                                   last_valid, pods_unit, 8, maxfit=maxfit)
    S, L = shapes.shape[1], 8
    counts_f, dropped_f, done, chosen, q, packed = batched_pack.unpack_batch_flat(
        flat.numpy(), S, L)
    assert done[1:].all() and not counts_f[1:].any() and not dropped_f[1:].any()
    assert not q[1:].any() and not packed[1:].any()


def test_the_mask_shape_is_checked_against_the_padded_batch():
    from karpenter_tpu_torch.models.ffd import DeviceRun

    probs = build_window("port", "fused")
    handle = batch_solve.dispatch_batch(probs, port_solve_mod.SolverConfig(device_min_pods=0),
                                        device=cpu_mesh(2))
    encs, masks = handle.device_run.encs, handle.fused.masks
    handle.fetch()
    with pytest.raises(ValueError, match="mask shape"):
        DeviceRun(encs, [None] * len(encs), 8, cpu_mesh(3), mask=masks)


# -- repack_plan_multi ------------------------------------------------------------

def fleets(pkg, seed, n_fleets):
    """n_fleets fleets of the batch window's problems: problem b's pods
    spread over four nodes of fleet b."""
    core = pkg_core(pkg)
    mod = jax_consolidate if pkg == "jax" else port_consolidate
    out = []
    for b, prob in enumerate(window(pkg, seed, n_fleets, 70, 24, 20)):
        nodes = [core.Node(metadata=core.ObjectMeta(name=f"f{b}-n{i}")) for i in range(4)]
        pods_by = {nd.metadata.name: list(prob.pods[i::4]) for i, nd in enumerate(nodes)}
        out.append(mod.Fleet(nodes=nodes, pods_by_node=pods_by, constraints=prob.constraints,
                             catalog=prob.instance_types))
    return out


def pkg_core(pkg):
    from karpenter_tpu.api import core as jax_core
    from karpenter_tpu_torch.api import core as port_core
    return jax_core if pkg == "jax" else port_core


def plan_key(plan, pods):
    return (plan.current_nodes, [n.metadata.name for n in plan.nodes_to_remove],
            round(plan.planned_cost_per_hour, 9), canonical(plan.replacement, pods))


@pytest.mark.parametrize("n", MESHES)
def test_repack_plan_multi_over_the_mesh_matches_jax(n):
    jf, pf = fleets("jax", 21, 3), fleets("port", 21, 3)
    want = jax_consolidate.repack_plan_multi(jf, jax_solve_mod.SolverConfig(
        device_timeout_s=0, device_hedge=False))
    got = port_consolidate.repack_plan_multi(
        pf, port_solve_mod.SolverConfig(device_min_pods=0), device=cpu_mesh(n))
    movable = lambda f: [p for ps in f.pods_by_node.values() for p in ps]  # noqa: E731
    assert [plan_key(g, movable(f)) for g, f in zip(got, pf)] == \
        [plan_key(w, movable(f)) for w, f in zip(want, jf)]


# -- the global, what-if and gang windows ----------------------------------------

def global_plan(pprobs, device):
    port_gops.SUPPORT.reset()
    return port_gs.solve_window_global(pprobs, port_solve_mod.SolverConfig(), device=device)


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("which,arg", [("random", 1), ("random", 7), ("config14", 0)])
def test_global_window_over_the_mesh_matches_one_device_and_jax(which, arg, n):
    """The same plans and verdicts as the one-device window and the JAX
    package's (SUPPORT reset before each, as every window starts from the
    strict corner)."""
    jprobs, pprobs = global_t.both_windows(which, arg)
    jax_gops.SUPPORT.reset()
    want = jax_gs.solve_window_global(jprobs, jax_solve_mod.SolverConfig(),
                                      jax_gs.GlobalConfig(device_min_cells=0))
    one = global_plan(pprobs, "cpu")
    handle_mesh = cpu_mesh(n)
    port_gops.SUPPORT.reset()
    handle = port_gs.dispatch_global_window(pprobs, port_solve_mod.SolverConfig(),
                                            device=handle_mesh)
    got = handle.fetch()
    b = handle.win.b
    assert len(handle.shards) == (n if b % n == 0 else 1)
    for plan in (one, got):
        assert [global_t.info_tuple(i) for i in plan.infos] == \
            [global_t.info_tuple(i) for i in want.infos]
        assert [global_t.plan_canon(r, p.pods) for r, p in zip(plan.results, pprobs)] == \
            [global_t.plan_canon(r, p.pods) for r, p in zip(want.results, jprobs)]
    assert got.executor == one.executor


def test_global_shards_give_the_one_device_node_counts_bit_for_bit():
    """The program's rows are independent: each shard's node counts are the
    one-device run's rows, to the bit."""
    _, pprobs = global_t.both_windows("random", 7)
    one = port_gs.dispatch_global_window(pprobs, device="cpu")
    sharded = port_gs.dispatch_global_window(pprobs, device=cpu_mesh(4))
    assert len(sharded.shards) == 4
    whole = one.shards[0][0].numpy()
    parts = np.concatenate([n_d.numpy() for n_d, _, _ in sharded.shards])
    assert np.array_equal(parts, whole)
    one.fetch(), sharded.fetch()


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("seed", [3, 11])
def test_whatif_window_over_the_mesh_matches_jax(seed, n):
    (je, *_), (pe, *_) = whatif_t.encodings(seed)
    jf, js, _ = whatif_t.JAX.sw.solve_window(je, WhatIfConfig(device_min_cells=0))
    one_f, one_s, _ = whatif_t.PORT.sw.solve_window(pe, device="cpu")
    handle = whatif_t.PORT.sw.dispatch_window(pe, device=cpu_mesh(n))
    pf, ps, executor = handle.fetch()
    assert executor == "device-whatif"
    assert np.array_equal(pf, one_f) and np.array_equal(ps, one_s)
    assert np.array_equal(pf, np.asarray(jf)[:pe.n])
    # slots follow _whatif_jit on feasible rows (the kernel keeps placing a
    # failed candidate's later pods as the jit does)
    assert np.array_equal(ps[pf], np.asarray(js)[:pe.n][pf])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("seed", gang_t.SEEDS)
def test_gang_window_over_the_mesh_matches_jax(seed, n):
    je = gang_t.encode_window(gang_t.JAX, seed)
    pe = gang_t.encode_window(gang_t.PORT, seed)
    want = gang_t.solve_window(gang_t.JAX, je)
    one = gang_t.solve_window(gang_t.PORT, pe)
    handle = gang_t.PORT.sg.dispatch_gang_window(pe, device=cpu_mesh(n))
    feas, slots, executor = handle.fetch()
    assert executor == "device-gang"
    gb = pe.d_pods.shape[0]
    assert len(handle.shards) == (n if gb % n == 0 else 1)
    for got in (one, (feas, slots)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    # the gathered inputs replay the window whole
    f_all, s_all = gang_t.PORT.sg.gang_scan(*handle.inputs)
    assert np.array_equal(f_all.numpy()[:pe.g], feas)


@pytest.mark.parametrize("n", (1, 2, 8))
@pytest.mark.parametrize("case", range(len(carve_t.CARVE_WINDOWS)))
def test_carve_gang_window_over_the_mesh_matches_jax(case, n):
    """The carve program runs once, on the mesh's first device; each shard
    ANDs its rows of the verdict into its compat."""
    specs, types = carve_t.CARVE_WINDOWS[case]
    enc_j, _, _ = carve_t.window(carve_t.JAX, specs, types)
    enc_p, _, _ = carve_t.window(carve_t.PORT, specs, types)
    fj, sj, _ = carve_t.JAX.sg.solve_gang_window(enc_j, GangConfig(device_min_cells=0))
    fp, sp, ex = carve_t.PORT.sg.solve_gang_window(enc_p, device=cpu_mesh(n))
    assert ex == "device-gang"
    assert np.array_equal(fp, fj) and np.array_equal(sp, sj)
    assert carve_t.plan_sig(carve_t.PORT.sg.plan_gang_window(enc_p, fp)) == \
        carve_t.plan_sig(carve_t.JAX.sg.plan_gang_window(enc_j, fj))


# -- the mesh itself ---------------------------------------------------------------

def test_solver_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is every card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.solver_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.resolve_mesh("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.solver_mesh(["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_solve.solve_batch(build_window("port", "fused"))
    assert port_mesh.device_count() == 0 and port_mesh.device_bytes_in_use() == {}


def test_mesh_forms():
    cpu = torch.device("cpu")
    assert port_mesh.resolve_mesh("cpu") == (cpu,)
    assert port_mesh.resolve_mesh(torch.device("cpu")) == (cpu,)
    assert port_mesh.resolve_mesh(["cpu", "cpu", "cpu"]) == (cpu,) * 3
    assert port_mesh.distinct((cpu,) * 3) == (cpu,)
    with pytest.raises(ValueError, match="at least one device"):
        port_mesh.solver_mesh([])
    with pytest.raises(ValueError, match="unsupported device"):
        port_mesh.resolve_mesh("meta")
    shards = port_mesh.batch_sharding(6, (cpu,) * 3)
    assert [(s.index, s.start, s.stop) for s in shards] == [(0, 0, 2), (1, 2, 4), (2, 4, 6)]
    with pytest.raises(ValueError, match="do not divide"):
        port_mesh.batch_sharding(5, (cpu,) * 3)
    assert [(s.start, s.stop) for s in port_mesh.row_sharding(5, (cpu,) * 3)] == [(0, 5)]
    t = torch.arange(4)
    assert port_mesh.replicated(t, (cpu,) * 2) == {cpu: t}


def test_pad_problems_pads_to_the_mesh_size():
    from karpenter_tpu.parallel import sharded_pack

    probs = build_window("port", "host-filtered")
    encs = []
    for prob in probs:
        packables, _, vecs, sids, version = batch_solve._prepare(
            prob, batch_solve.marshal_pods_interned(prob.pods))
        from karpenter_tpu_torch.ops.encode import encode, pad_encoding
        encs.append(pad_encoding(encode(vecs, list(range(len(prob.pods))), packables,
                                        pad=False, sids=sids, catalog_version=version)))
    for n in (1, 3, 8):
        got = batched_pack.pad_problems(encs, n)
        want = sharded_pack.pad_problems(encs, n)
        assert got[-1] == want[-1] == len(encs)
        for g, w in zip(got[:-1], want[:-1]):
            assert g.shape[0] == -(-len(encs) // n) * n and np.array_equal(g, w)


def test_warmup_over_a_mesh_counts_each_entry_once():
    pipeline.reset_ring()
    one = warmup.warmup_pass(port_solve_mod.SolverConfig(), shape_buckets=[8],
                             type_buckets=[8], device="cpu")
    three = warmup.warmup_pass(port_solve_mod.SolverConfig(), shape_buckets=[8],
                               type_buckets=[8], device=cpu_mesh(3))
    assert one == three == 3


def test_the_controller_resolves_the_mesh_once():
    from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider
    from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
    from karpenter_tpu_torch.runtime.kubecore import KubeCore

    ctrl = ProvisioningController(KubeCore(), FakeCloudProvider(), device=["cpu"] * 2)
    assert ctrl.mesh == cpu_mesh(2) and ctrl.device == torch.device("cpu")
    ctrl = ProvisioningController(KubeCore(), FakeCloudProvider(), device="cpu")
    assert ctrl.mesh == cpu_mesh(1)
