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
from karpenter_tpu_torch.ops.type_shard_cuda import (
    HEADER, INT64_MAX, out_words, probe_row, row_key, shard_candidate, shard_candidate_plain,
    type_fill_plain,
)
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
    """pmax reduces elementwise onto every shard; least_key gathers the
    shards' candidate rows and takes the one with the least signed int64
    key (a negative price's key sorts first, the sentinel last)."""
    mesh = port_mesh.type_mesh(["cpu"] * 3)
    parts = [torch.tensor([1, 5, -2], dtype=torch.int32),
             torch.tensor([4, 0, 7], dtype=torch.int32),
             torch.tensor([2, 2, 2], dtype=torch.int32)]
    out = type_sharded.pmax(parts, mesh)
    assert len(out) == 3
    for t in out:
        assert t.dtype == torch.int32 and t.tolist() == [4, 5, 7]

    def row(key, tag):
        r = torch.full((out_words(3),), tag, dtype=torch.int32)
        r[:2] = torch.tensor([key], dtype=torch.int64).view(torch.int32)
        return r

    for keys, want in (([7, 3, 5], 1), ([2**32 + 1, 2**33, -(2**32) + 9], 2),
                       ([INT64_MAX, 4, INT64_MAX], 1), ([INT64_MAX] * 3, 0)):
        rows = [row(k, tag) for tag, k in enumerate(keys)]
        got = type_sharded.least_key(rows, mesh)
        assert torch.equal(got, rows[want]) and int(row_key(got)) == keys[want]


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
    # the wrapper takes the plain version for a CPU tensor, whose walk this is
    last = int(np.flatnonzero(valid)[-1])
    probe = probe_row(*args[2:5], last)
    got = shard_candidate(*args[:5], None, probe, 0, pods_unit)
    assert torch.equal(got, shard_candidate_plain(*args[:5], None, probe, 0, pods_unit))
    assert int(got[2]) == int(npacked[last])
    assert torch.equal(got[HEADER:HEADER + S], k[:, int(got[3])])


def test_type_fill_with_nothing_live_is_zero():
    shapes, counts, totals, reserved0, valid, pods_unit = walk_problem(3, 8, 8)
    npacked, k = type_fill_plain(torch.as_tensor(shapes), torch.zeros(8, dtype=torch.int32),
                                 torch.as_tensor(totals), torch.as_tensor(reserved0),
                                 torch.as_tensor(valid), pods_unit)
    assert not npacked.any() and not k.any()


def test_type_fill_refuses_another_device():
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        shard_candidate(torch.zeros((8, 8), **meta), torch.zeros(8, **meta),
                        torch.zeros((8, 8), **meta), torch.zeros((8, 8), **meta),
                        torch.zeros(8, dtype=torch.bool, device="meta"), None,
                        torch.zeros(17, **meta), 0, 1)


# -- one shard's candidate against the JAX decision ---------------------------

def jax_shard_reference(walk, valid, prices, last_valid, j, T_l, cost):
    """What ``_local_pack`` computes on shard ``j`` of ``T_l`` types before
    its cross-shard reductions, from the JAX walk of every type: max_pods
    (the probe of last_valid), best_price (the least price over the
    shard's ties; the shard's part of the cost pmin), local_first (its first
    tie at that price) and that type's column."""
    npacked, k = walk
    max_pods = int(npacked[last_valid]) if 0 <= last_valid < len(npacked) else 0
    lo = j * T_l
    ties = [t for t in range(lo, lo + T_l) if valid[t] and npacked[t] == max_pods]
    best_price = min((int(prices[t]) for t in ties), default=INT32_MAX) if cost else 0
    firsts = [t for t in ties if not cost or int(prices[t]) == best_price]
    local_first = firsts[0] if firsts else INT32_MAX
    col = k[:, local_first] if firsts else np.zeros(k.shape[0], np.int64)
    return max_pods, best_price, local_first, col


@pytest.mark.parametrize("cost", [False, True])
@pytest.mark.parametrize("owner", [0, 1, 2, 3])
def test_shard_candidate_matches_local_pack(owner, cost):
    """Four shards of 8 types; last_valid is put in each shard position in
    turn (the types after it made invalid). Each shard's candidate row
    holds the JAX walk's max_pods, the key (best_price, local_first) and
    local_first's column; the least key over the shards is the JAX chunk's
    first decision (chosen and pack vector, one decision on 4 devices)."""
    n, T = 4, 32
    T_l = T // n
    shapes, counts, totals, reserved0, valid, pods_unit = walk_problem(11 + owner, 16, T)
    last_valid = owner * T_l + 5
    valid[last_valid] = True
    valid[last_valid + 1:] = False
    totals[last_valid] = totals.max(axis=0)  # the largest type, as encode sorts them
    reserved0[last_valid] = 0
    rng = np.random.default_rng(owner)
    prices = rng.integers(-3, 4, T).astype(np.int32)  # many equal and negative prices
    walk = jax_walk(shapes, counts, totals, reserved0, valid, pods_unit)
    rows = []
    for j in range(n):
        sl = slice(j * T_l, (j + 1) * T_l)
        probe = probe_row(torch.as_tensor(totals), torch.as_tensor(reserved0),
                          torch.as_tensor(valid), last_valid)
        row = shard_candidate(torch.as_tensor(shapes), torch.as_tensor(counts),
                              torch.as_tensor(totals[sl]), torch.as_tensor(reserved0[sl]),
                              torch.as_tensor(valid[sl]),
                              torch.as_tensor(prices[sl]) if cost else None, probe, j * T_l,
                              pods_unit)
        max_pods, best_price, local_first, col = jax_shard_reference(
            walk, valid, prices, last_valid, j, T_l, cost)
        want_key = INT64_MAX if local_first == INT32_MAX else best_price * 2**32 + local_first
        assert int(row[2]) == max_pods
        assert int(row_key(row)) == want_key and int(row[3]) == local_first
        np.testing.assert_array_equal(row[HEADER:HEADER + 16].numpy(), col)
        rows.append(row)
    best = type_sharded.least_key(rows, port_mesh.type_mesh(["cpu"] * n))
    enc = SimpleNamespace(shapes=shapes, counts=counts, totals=totals, reserved0=reserved0,
                          valid=valid, last_valid=last_valid, pods_unit=pods_unit)
    buf = run_jax_arrays(enc, n, prices if cost else None, cost, 1)
    _, _, _, chosen, q, packed = unpack_flat(buf, 16, 1)
    assert q[0] > 0 and chosen[0] == int(best[3])
    np.testing.assert_array_equal(packed[0], best[HEADER:HEADER + 16].numpy())


def run_jax_arrays(enc, n, prices, cost, num_iters):
    """The JAX chunk on raw encoded arrays over ``n`` virtual devices."""
    mesh = jax_type_sharded.type_mesh(cpu_mesh_devices(n))
    kw = dict(prices=prices, cost_tiebreak=True) if cost else {}
    return np.asarray(jax_type_sharded.pack_chunk_type_sharded(
        enc.shapes, enc.counts, np.zeros_like(enc.counts), enc.totals, enc.reserved0,
        enc.valid, np.int32(enc.last_valid), np.int32(enc.pods_unit), num_iters=num_iters,
        mesh=mesh, **kw))


@pytest.mark.parametrize("n", [2, 4])
def test_no_shard_has_a_tie_when_every_type_is_invalid(n):
    """Every type invalid: the probe packs nothing, no shard has a tie, each
    row holds the sentinel key, INT32_MAX and a zero column; the chunk
    drops the largest shape each decision, as the JAX package's does."""
    shapes, counts, totals, reserved0, valid, pods_unit = walk_problem(5, 16, 32)
    valid[:] = False
    counts[:] = 0
    counts[[2, 9]] = (3, 4)
    probe = probe_row(torch.as_tensor(totals), torch.as_tensor(reserved0),
                      torch.as_tensor(valid), 31)
    T_l = 32 // n
    for j in range(n):
        sl = slice(j * T_l, (j + 1) * T_l)
        row = shard_candidate(torch.as_tensor(shapes), torch.as_tensor(counts),
                              torch.as_tensor(totals[sl]), torch.as_tensor(reserved0[sl]),
                              torch.as_tensor(valid[sl]), None, probe, j * T_l, pods_unit)
        assert int(row_key(row)) == INT64_MAX and int(row[2]) == 0
        assert int(row[3]) == INT32_MAX and not row[HEADER:].any()
    enc = SimpleNamespace(shapes=shapes, counts=counts, totals=totals, reserved0=reserved0,
                          valid=valid, last_valid=31, pods_unit=pods_unit)
    want = run_jax_arrays(enc, n, None, False, 4)
    got = type_sharded.pack_chunk_type_sharded(
        *(torch.as_tensor(a) for a in (shapes, counts, np.zeros_like(counts), totals,
                                       reserved0, valid)), 31, pods_unit, num_iters=4,
        mesh=port_mesh.type_mesh(["cpu"] * n)).numpy()
    np.testing.assert_array_equal(got, want)
    _, dropped, done, chosen, q, _ = unpack_flat(got, 16, 4)
    assert done and dropped.sum() == 7 and (q == 0).all() and (chosen == -1).all()


@pytest.mark.parametrize("n", [2, 8])
def test_a_price_tie_is_broken_by_index(n):
    """Every type at one price with the cost tie-break on: the least index
    among the ties wins across shards, as without prices, and the stream
    is the JAX package's."""
    enc, prices = jax_problem(16, suite_pods(250))
    flat = np.full_like(prices, 7)
    got = run_port(enc, n, flat, cost=True)
    np.testing.assert_array_equal(got, run_jax(enc, n, flat, cost=True))
    np.testing.assert_array_equal(got, run_port(enc, n))


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
