"""The port's type-axis SPMD chunk (parallel/type_sharded.py, B12) against
the JAX package's.

The problems are the JAX suite's (tests/test_type_sharded.py): the fake
provider's incrementing catalog and pods over seven cpu and five memory
sizes, encoded by the JAX package; the same int32 arrays go to both
packages. The JAX chunk runs under shard_map on 1, 2, 4 and 8 of the
virtual CPU devices (tests/conftest.py), the port's on a virtual mesh of
as many ``cpu`` shards (the collectives' copies are no-ops, the fill walk
is ``type_fill_plain``). Exact: the work is all integer.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.cloudprovider.fake.provider import instance_types as jax_instance_types
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.models.ffd import device_args as jax_device_args
from karpenter_tpu.models.ffd import encode_prices
from karpenter_tpu.ops.encode import encode as jax_encode
from karpenter_tpu.parallel import type_sharded as jax_type_sharded
from karpenter_tpu.solver.adapter import build_packables as jax_build_packables
from karpenter_tpu.solver.adapter import pod_vectors as jax_pod_vectors
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.cloudprovider.fake.provider import instance_types
from karpenter_tpu_torch.models import ffd as port_ffd
from karpenter_tpu_torch.ops.pack import unpack_flat
from karpenter_tpu_torch.ops.pack_cuda import pack_chunk_plain
from karpenter_tpu_torch.ops.type_shard_cuda import type_fill, type_fill_plain
from karpenter_tpu_torch.parallel import mesh as port_mesh
from karpenter_tpu_torch.parallel import type_sharded
from karpenter_tpu_torch.solver import host_ffd
from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
from karpenter_tpu_torch.solver.solve import universe_constraints
from tests.conftest import cpu_mesh_devices
from tests.expectations import unschedulable_pod

L = 32
MESH_SIZES = (1, 2, 4, 8)
INT32_MAX = 2**31 - 1


def suite_pods(n_pods):
    """The JAX suite's record-stream pods."""
    return [unschedulable_pod(requests={
        "cpu": f"{(i % 7 + 1) * 250}m",
        "memory": f"{(i % 5 + 1) * 256}Mi"}) for i in range(n_pods)]


def jax_problem(n_types, pods, descending_prices=False):
    """The JAX package's encoding of ``pods`` over its fake catalog, as the
    JAX suite builds it, and the micro-$ price row (descending prices
    invert the default first-tie order)."""
    catalog = jax_instance_types(n_types)
    if descending_prices:
        for i, it in enumerate(catalog):
            it.price = 0.1 * (len(catalog) - i)
    packables, sorted_types = jax_build_packables(catalog, jax_universe(catalog), pods, [])
    enc = jax_encode(jax_pod_vectors(pods), list(range(len(pods))), packables)
    assert enc is not None
    prices = encode_prices([sorted_types[p.index].price for p in packables],
                           enc.totals.shape[0])
    return enc, prices


def port_args(jargs):
    """The JAX package's kernel arguments as CPU tensors (scalars as ints)."""
    return tuple(torch.as_tensor(np.asarray(a)) if np.ndim(a) else int(a) for a in jargs)


def run_jax(enc, n, prices=None, cost=False, num_iters=L):
    mesh = jax_type_sharded.type_mesh(cpu_mesh_devices(n))
    kw = dict(prices=prices, cost_tiebreak=cost) if cost else {}
    return np.asarray(jax_type_sharded.pack_chunk_type_sharded(
        *jax_device_args(enc), num_iters=num_iters, mesh=mesh, **kw))


def run_port(enc, n, prices=None, cost=False, num_iters=L):
    kw = dict(prices=torch.as_tensor(prices), cost_tiebreak=True) if cost else {}
    return type_sharded.pack_chunk_type_sharded(
        *port_args(jax_device_args(enc)), num_iters=num_iters,
        mesh=port_mesh.type_mesh(["cpu"] * n), **kw).numpy()


def check_against_plain(buf, enc, prices=None, cost=False):
    """The sharded buffer against the port's pack_chunk_plain: counts,
    dropped and done whole, the records on the rows with q > 0."""
    S = enc.shapes.shape[0]
    kw = dict(prices=torch.as_tensor(prices), cost_tiebreak=True) if cost else {}
    plain = pack_chunk_plain(*port_args(jax_device_args(enc)), L, **kw).numpy()
    got, want = unpack_flat(buf, S, L), unpack_flat(plain, S, L)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    rows = got[4] > 0
    np.testing.assert_array_equal(rows, want[4] > 0)
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(a[rows], b[rows])


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("n_types,n_pods", [(8, 60), (16, 250), (24, 400)])
def test_record_stream_matches_jax(n_types, n_pods, n):
    enc, _ = jax_problem(n_types, suite_pods(n_pods))
    got = run_port(enc, n)
    np.testing.assert_array_equal(got, run_jax(enc, n))
    assert unpack_flat(got, enc.shapes.shape[0], L)[2]  # one chunk reaches done
    check_against_plain(got, enc)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_cost_tiebreak_record_stream_matches_jax(n):
    enc, prices = jax_problem(16, suite_pods(250), descending_prices=True)
    got = run_port(enc, n, prices, cost=True)
    np.testing.assert_array_equal(got, run_jax(enc, n, prices, cost=True))
    check_against_plain(got, enc, prices, cost=True)
    # the tie-break decides: the stream differs from the priceless one
    assert not np.array_equal(got, run_port(enc, n))


@pytest.mark.parametrize("n", MESH_SIZES)
def test_unschedulable_drop_matches_jax(n):
    pods = [unschedulable_pod(requests={"cpu": "500", "memory": "1Ti"}),
            unschedulable_pod(requests={"cpu": "1", "memory": "512Mi"})]
    enc, _ = jax_problem(8, pods)
    got = run_port(enc, n)
    np.testing.assert_array_equal(got, run_jax(enc, n))
    _, dropped, done, _, _, _ = unpack_flat(got, enc.shapes.shape[0], L)
    assert done and dropped.sum() == 1
    check_against_plain(got, enc)


@pytest.mark.parametrize("n", [2, 8])
def test_resume_mid_chunk_matches_jax(n):
    """A chunk of 2 decisions stops before done: the partial stream and the
    counts a resume starts from are the JAX package's."""
    enc, _ = jax_problem(16, suite_pods(250))
    got = run_port(enc, n, num_iters=2)
    np.testing.assert_array_equal(got, run_jax(enc, n, num_iters=2))
    assert not unpack_flat(got, enc.shapes.shape[0], 2)[2]


def test_mesh_size_must_divide_types():
    enc, _ = jax_problem(8, [unschedulable_pod()])  # an 8-bucket; 8 % 3 != 0
    with pytest.raises(AssertionError):
        type_sharded.pack_chunk_type_sharded(
            *port_args(jax_device_args(enc)), num_iters=4,
            mesh=port_mesh.type_mesh(["cpu"] * 3))


def test_collectives_reduce_over_shards():
    mesh = port_mesh.type_mesh(["cpu"] * 3)
    parts = [torch.tensor([1, 5, -2], dtype=torch.int32),
             torch.tensor([4, 0, 7], dtype=torch.int32),
             torch.tensor([2, 2, 2], dtype=torch.int32)]
    for fn, want in ((type_sharded.psum, [7, 7, 7]), (type_sharded.pmax, [4, 5, 7]),
                     (type_sharded.pmin, [1, 0, -2])):
        out = fn(parts, mesh)
        assert len(out) == 3
        for t in out:
            assert t.dtype == torch.int32 and t.tolist() == want


# -- the fill walk against the JAX walk ---------------------------------------

def jax_walk(shapes, counts, totals, reserved0, valid, pods_unit):
    """One decision of the JAX ``_local_pack`` walk, type by type: a type's
    walk depends on no other type (only on the shared counts and smallest
    shape), so each type's fill column is the pack vector of a one-decision
    chunk over that type alone, and its pods packed the column's sum."""
    S, T = shapes.shape[0], totals.shape[0]
    mesh = jax_type_sharded.type_mesh(cpu_mesh_devices(1))
    k = np.zeros((S, T), np.int64)
    for t in range(T):
        buf = np.asarray(jax_type_sharded.pack_chunk_type_sharded(
            shapes, counts, np.zeros_like(counts), totals[t:t + 1], reserved0[t:t + 1],
            valid[t:t + 1], np.int32(0), np.int32(pods_unit), num_iters=1, mesh=mesh))
        k[:, t] = buf[2 * S + 3:2 * S + 3 + S]
    return k.sum(axis=0), k


def walk_problem(seed, S, T):
    """Seeded walk inputs: descending shapes (some asking for a fourth
    resource), count-0 shapes among the live ones, a few invalid types and
    initial reservations."""
    rng = np.random.default_rng(seed)
    pods_unit = int(rng.integers(1, 3))
    live = np.zeros((S, 8), np.int64)
    live[:, 0] = rng.integers(1, 24, S)
    live[:, 1] = rng.integers(1, 40, S)
    live[:, 2] = pods_unit
    live[:, 3] = (rng.random(S) < 0.2) * rng.integers(1, 3, S)
    shapes = np.array(sorted(live.tolist(), key=lambda r: tuple(-v for v in r)), np.int32)
    counts = rng.integers(0, 30, S).astype(np.int32)
    counts[rng.random(S) < 0.3] = 0
    totals = np.zeros((T, 8), np.int64)
    totals[:, 0] = rng.integers(8, 96, T)
    totals[:, 1] = rng.integers(8, 160, T)
    totals[:, 2] = rng.integers(5, 60, T) * pods_unit
    totals[:, 3] = rng.integers(0, 3, T)
    reserved0 = (totals * rng.random((T, 8)) * 0.2).astype(np.int64)
    valid = rng.random(T) < 0.85
    return (shapes, counts, totals.astype(np.int32), reserved0.astype(np.int32), valid,
            pods_unit)


@pytest.mark.parametrize("seed,S,T", [(1, 8, 8), (7, 16, 13), (42, 32, 24)])
def test_type_fill_plain_matches_the_jax_walk(seed, S, T):
    shapes, counts, totals, reserved0, valid, pods_unit = walk_problem(seed, S, T)
    want_np, want_k = jax_walk(shapes, counts, totals, reserved0, valid, pods_unit)
    stats = {}
    args = (torch.as_tensor(shapes), torch.as_tensor(counts), torch.as_tensor(totals),
            torch.as_tensor(reserved0), torch.as_tensor(valid), pods_unit)
    npacked, k = type_fill_plain(*args, stats=stats)
    np.testing.assert_array_equal(k.numpy(), want_k)
    np.testing.assert_array_equal(npacked.numpy(), want_np)
    assert stats["shape_steps"] >= 1 and stats["type_steps"] >= 1
    # the wrapper takes the plain version for a CPU tensor
    np_w, k_w = type_fill(*args)
    assert torch.equal(np_w, npacked) and torch.equal(k_w, k)


def test_type_fill_with_nothing_live_is_zero():
    shapes, counts, totals, reserved0, valid, pods_unit = walk_problem(3, 8, 8)
    npacked, k = type_fill_plain(torch.as_tensor(shapes), torch.zeros(8, dtype=torch.int32),
                                 torch.as_tensor(totals), torch.as_tensor(reserved0),
                                 torch.as_tensor(valid), pods_unit)
    assert not npacked.any() and not k.any()


def test_type_fill_refuses_another_device():
    with pytest.raises(ValueError):
        type_fill(torch.zeros((8, 8), dtype=torch.int32, device="meta"),
                  torch.zeros(8, dtype=torch.int32, device="meta"),
                  torch.zeros((8, 8), dtype=torch.int32, device="meta"),
                  torch.zeros((8, 8), dtype=torch.int32, device="meta"),
                  torch.zeros(8, dtype=torch.bool, device="meta"), 1)


# -- the route through solve_ffd_device and the solver ---------------------------

def port_problem(n_pods=120, n_types=16, descending_prices=False):
    """The JAX suite's routed-solve problem, built in the port."""
    catalog = instance_types(n_types)
    if descending_prices:
        for i, it in enumerate(catalog):
            it.price = 0.1 * (len(catalog) - i)
    pods = [port_core.Pod(spec=port_core.PodSpec(containers=[port_core.Container(
        resources=port_core.ResourceRequirements.make(requests={
            "cpu": f"{100 + 37 * (i % 9)}m", "memory": f"{64 * (1 + i % 5)}Mi"}))]))
        for i in range(n_pods)]
    packables, sorted_types = build_packables(catalog, universe_constraints(catalog), pods, [])
    prices = [sorted_types[p.index].price for p in packables]
    return pod_vectors(pods), list(range(len(pods))), packables, prices


def key(r):
    return (r.node_count, sorted(r.unschedulable),
            sorted((tuple(p.instance_type_indices), p.node_quantity) for p in r.packings))


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("chunk_iters", [64, 2])
def test_solve_ffd_device_on_a_mesh_matches_host(n, chunk_iters):
    vecs, ids, packables, _ = port_problem(n_pods=120 if chunk_iters == 64 else 90)
    want = host_ffd.pack(vecs, ids, packables)
    type_sharded.DECISIONS = type_sharded.DONE_READS = 0
    got = port_ffd.solve_ffd_device(vecs, ids, packables, device="cpu",
                                    chunk_iters=chunk_iters,
                                    mesh=port_mesh.type_mesh(["cpu"] * n))
    assert key(got) == key(want)
    # one read of done before the loop of each chunk and one a decision
    assert type_sharded.DONE_READS > type_sharded.DECISIONS > 0


def test_cost_tiebreak_on_a_mesh_matches_the_standard_kernel():
    vecs, ids, packables, prices = port_problem(descending_prices=True)
    kw = dict(device="cpu", prices=prices, cost_tiebreak=True)
    want = port_ffd.solve_ffd_device(vecs, ids, packables, **kw)
    plain = port_ffd.solve_ffd_device(vecs, ids, packables, device="cpu")
    assert key(want) != key(plain)  # the tie-break changes this packing
    got = port_ffd.solve_ffd_device(vecs, ids, packables,
                                    mesh=port_mesh.type_mesh(["cpu"] * 4), **kw)
    assert key(got) == key(want)


def test_a_mesh_that_does_not_divide_takes_the_standard_kernel():
    vecs, ids, packables, _ = port_problem()  # 16 types: a 16-bucket
    enc = port_ffd.pad_encoding(port_ffd.encode(vecs, ids, packables, pad=False))
    assert port_ffd.routes_type_spmd(enc, port_mesh.type_mesh(["cpu"] * 4))
    assert not port_ffd.routes_type_spmd(enc, port_mesh.type_mesh(["cpu"] * 3))
    assert not port_ffd.routes_type_spmd(enc, None)
    type_sharded.DECISIONS = 0
    got = port_ffd.solve_ffd_device(vecs, ids, packables, device="cpu",
                                    mesh=port_mesh.type_mesh(["cpu"] * 3))
    assert type_sharded.DECISIONS == 0
    assert key(got) == key(host_ffd.pack(vecs, ids, packables))


@pytest.mark.parametrize("mesh_size", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("num_types", [1, 7, 8, 9, 24, 400, 1000, 2000, 2048, 2049,
                                       3000, 4096, 4097, 5000])
def test_route_by_shape_matches_jax(num_types, mesh_size):
    """The route by shape is the JAX package's (karpenter_tpu/models/ffd.py,
    kernel "type-spmd"): the same padded type bucket, and the mesh taken
    exactly when its size divides that bucket; a problem past the largest
    bucket is not encodable, so no route is asked of it."""
    from karpenter_tpu.ops.encode import TYPE_BUCKETS as JAX_TYPE_BUCKETS
    from karpenter_tpu.ops.encode import bucket as jax_bucket
    from karpenter_tpu_torch.ops.encode import TYPE_BUCKETS, bucket

    t_pad = bucket(num_types, TYPE_BUCKETS)
    assert t_pad == jax_bucket(num_types, JAX_TYPE_BUCKETS)
    if t_pad is None:
        return
    enc = SimpleNamespace(totals=np.zeros((t_pad, 1), np.int32))
    mesh = port_mesh.type_mesh(["cpu"] * mesh_size)
    assert port_ffd.routes_type_spmd(enc, mesh) == (t_pad % mesh_size == 0)
    assert not port_ffd.routes_type_spmd(enc, None)


def test_type_mesh_names_its_devices(monkeypatch):
    assert port_mesh.type_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert port_mesh.AXIS == "types"
    with pytest.raises(ValueError):
        port_mesh.type_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_mesh.type_mesh()
    assert port_mesh.device_count() == 0
    # without a card, or with only CPU devices named, no CUDA bytes to report
    assert port_mesh.device_bytes_in_use() == {}
    assert port_mesh.device_bytes_in_use(["cpu"]) == {}
