"""The pieces of the pack kernel's design that the CPU can check.

csrc/pack.cu runs only on the card, where chip_smoke.py holds it against
``pack_chunk_plain`` bit for bit. Here the plain emulation of its division
by per-shape constants is held against exact ``//`` (a hypothesis test and
the edge cases), the bound that sizes its per-type fill logs against the
plain version's walk (seeded ``make_problem`` cases and encoded catalogs in
the shapes of config_4 and of the high-cardinality cell), and the host-side
helpers that pick its launch (cluster size, walked resources) and read its
error word are checked directly. Tolerance is exact: the work is integer.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from karpenter_tpu_torch.models import ffd
from karpenter_tpu_torch.ops import pack_cuda
from karpenter_tpu_torch.ops.encode import TYPE_BUCKETS, encode, pad_encoding
from karpenter_tpu_torch.ops.pack import flat_size, unpack_flat
from karpenter_tpu_torch.ops.pack_cuda import (
    MAX_CLUSTER, MAX_TYPE_THREADS, compute_log_bound, divisor_constants,
    floor_div_by_constant, launch_shape, launch_threads, pack_chunk,
    pack_chunk_plain, requested_mask,
)
from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
from karpenter_tpu_torch.solver.solve import universe_constraints
from tests.test_torch_pack import CASES, SEEDS, make_problem, plain_flat, torch_args

INT32_MAX = 2**31 - 1


def kernel_floor_div(n, d):
    n_t = torch.tensor([n], dtype=torch.int64)
    d_t = torch.tensor([d], dtype=torch.int64)
    return int(floor_div_by_constant(n_t, d_t, divisor_constants(d_t))[0])


@settings(max_examples=400, deadline=None)
@given(st.integers(1, INT32_MAX), st.integers(0, INT32_MAX))
def test_division_by_constant_is_exact(d, n):
    assert kernel_floor_div(n, d) == n // d


DIVISORS = (1, 2, 3, 7, 2**16 + 1, INT32_MAX)
NUMERATORS = {
    "0": lambda d: 0,
    "d-1": lambda d: d - 1,
    "d": lambda d: d,
    "k*d": lambda d: INT32_MAX // d * d,
    "k*d-1": lambda d: INT32_MAX // d * d - 1,
    "INT32_MAX": lambda d: INT32_MAX,
}


@pytest.mark.parametrize("d", DIVISORS)
@pytest.mark.parametrize("numerator", sorted(NUMERATORS))
def test_division_by_constant_edges(d, numerator):
    n = NUMERATORS[numerator](d)
    assert kernel_floor_div(n, d) == n // d


def test_divisor_constants_of_zero_is_zero():
    m = divisor_constants(torch.tensor([0, 1, 3], dtype=torch.int32))
    assert m.tolist() == [0, 2**32 - 1, (2**32 - 1) // 3]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("S,T,drops,cost", CASES)
def test_log_bound_holds_on_seeded_problems(seed, S, T, drops, cost):
    p = make_problem(seed, S, T, drops=drops)
    stats = {}
    pack_chunk_plain(*torch_args(p), num_iters=64, prices=torch.as_tensor(p["prices"]),
                     cost_tiebreak=cost, stats=stats)
    bound = compute_log_bound(p["totals"], p["reserved0"], p["valid"], p["pods_unit"])
    assert 0 < stats["log_steps"] <= bound


def encoded(kind):
    """A small encoding in the shape of a cell: config_4's 32 mixed shapes
    or the high-cardinality generator, on the synthetic catalog."""
    catalog = chip_smoke.make_catalog(40)
    if kind == "config_4":
        pods = chip_smoke.make_pods(3000, chip_smoke.MIXED_SHAPES)
    else:
        pods = chip_smoke.highcard_pods(3000, 300, chip_smoke.SEED)
    packables, _ = build_packables(catalog, universe_constraints(catalog), pods, [])
    vecs, ids = pod_vectors(pods), list(range(len(pods)))
    return vecs, ids, packables, pad_encoding(encode(vecs, ids, packables, pad=False))


@pytest.mark.parametrize("kind", ["config_4", "high_cardinality"])
def test_log_bound_holds_on_encoded_catalogs(kind):
    *_, enc = encoded(kind)
    stats = {}
    pack_chunk_plain(*ffd.device_args(enc, torch.device("cpu")), num_iters=64, stats=stats)
    bound = compute_log_bound(enc.totals, enc.reserved0, enc.valid, enc.pods_unit)
    assert 0 < stats["log_steps"] <= bound
    assert requested_mask(enc.shapes) == 0b111  # cpu, memory and pods


def test_log_bound_edges():
    totals = np.zeros((3, 8), np.int32)
    totals[:, 2] = [10, 20, 30]
    reserved0 = np.zeros_like(totals)
    reserved0[1, 2] = 5
    valid = np.array([True, True, False])
    assert compute_log_bound(totals, reserved0, valid, 2) == 7  # (20 - 5) // 2
    assert compute_log_bound(totals, reserved0, np.zeros(3, bool), 1) == 0
    assert compute_log_bound(totals, reserved0, valid, 0) == INT32_MAX


def test_solve_path_passes_its_bound_and_resources(monkeypatch):
    vecs, ids, packables, enc = encoded("high_cardinality")
    seen = []
    real = pack_cuda.pack_chunk

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(pack_cuda, "pack_chunk", spy)
    result = ffd.solve_ffd_device(vecs, ids, packables, chunk_iters=8, device="cpu")
    assert result.node_count == ffd.solve_ffd_numpy(vecs, ids, packables).node_count
    want = (compute_log_bound(enc.totals, enc.reserved0, enc.valid, enc.pods_unit),
            requested_mask(enc.shapes))
    assert len(seen) > 1  # several chunks, compacted between them
    assert all((kw["log_bound"], kw["resource_mask"]) == want for kw in seen)


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_chunk_on_cpu_takes_the_plain_version_whatever_the_hints(seed):
    p = make_problem(seed, 32, 16, drops=True)
    got = pack_chunk(*torch_args(p), num_iters=8, log_bound=1, resource_mask=0xFF)
    np.testing.assert_array_equal(got.numpy(), plain_flat(p, 8))


@pytest.mark.parametrize("word", [-1, 2])
def test_unpack_flat_raises_on_the_error_word(word):
    S, L = 4, 2
    buf = np.zeros(flat_size(S, L), np.int32)
    buf[2 * S] = word
    with pytest.raises(RuntimeError, match="done word"):
        unpack_flat(buf, S, L)


@pytest.mark.parametrize("T", TYPE_BUCKETS)
def test_launch_shape_fits_the_kernel(T):
    cluster = launch_shape(T)
    threads = launch_threads(T, cluster)
    assert 1 <= cluster <= MAX_CLUSTER
    assert threads % 32 == 0 and threads <= MAX_TYPE_THREADS + 32
    assert cluster * (threads - 32) >= T  # a thread for every type
    assert T < 512 or cluster > 1


@pytest.mark.parametrize("kind", ["config_4", "high_cardinality"])
def test_bound_counts_only_the_requested_resources(kind):
    """chip_smoke's bound: 9 operations per requested resource and 6 more
    per type-step, at the op rate; cpu, memory and pods here."""
    *_, enc = encoded(kind)
    args = ffd.device_args(enc, torch.device("cpu"))
    got = chip_smoke.work_bound(args, 64, False, 1000)
    assert got["resources"] == 3 and got["ops"] == 33 * 1000
    assert got["bound_ms"] >= got["ops"] / chip_smoke.OPS_PER_S * 1e3


def test_requested_resources_counts_requested_dimensions():
    shapes = np.zeros((4, 8), np.int32)
    shapes[0, [0, 2]] = 1
    shapes[3, 5] = 7
    assert requested_mask(shapes) == 0b100101
    assert requested_mask(torch.as_tensor(shapes)) == 0b100101
    assert requested_mask(np.zeros((4, 8), np.int32)) == 0
