"""The port's pack chunk (karpenter_tpu_torch.ops) against the JAX package.

Inputs are built with numpy from a seed and handed to both packages:

- ``pack_chunk_plain`` ≡ ``karpenter_tpu.ops.pack.pack_chunk`` (the XLA
  scan) on counts, dropped, done and every committed (q > 0) row — the scan
  leaves stale values in its other rows by design;
- ``pack_chunk_plain`` ≡ ``pack_chunk_pallas_flat(..., interpret=True)``
  over the WHOLE flat buffer (the Pallas row contract);
- ``compute_maxfit`` exact.

Tolerance is exact: the work is all integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from karpenter_tpu.ops.pack import compute_maxfit as jax_compute_maxfit
from karpenter_tpu.ops.pack import pack_chunk as jax_pack_chunk
from karpenter_tpu.ops.pack_pallas import pack_chunk_pallas_flat
from karpenter_tpu_torch.ops import pack_cuda
from karpenter_tpu_torch.ops.pack import compute_maxfit, unpack_flat
from karpenter_tpu_torch.ops.pack_cuda import pack_chunk, pack_chunk_plain

SEEDS = (1, 7, 42)
R = 8
INT32_MAX = 2**31 - 1


def make_problem(seed, S, T, n_live=None, n_types=None, drops=False):
    """A random encoded problem in the kernel ABI: shapes descending,
    0 <= reserved0 <= totals, the first ``n_types`` types valid."""
    rng = np.random.default_rng(seed)
    n_live = n_live or max(1, S - rng.integers(0, S // 2 + 1))
    n_types = n_types or int(rng.integers(1, T + 1))
    pods_unit = int(rng.integers(1, 3))
    shapes = np.zeros((S, R), np.int64)
    live = np.zeros((n_live, R), np.int64)
    live[:, 0] = rng.integers(1, 24, n_live)       # cpu
    live[:, 1] = rng.integers(1, 40, n_live)       # memory
    live[:, 2] = pods_unit                         # pods (the implicit +1)
    live[:, 3] = rng.integers(0, 2, n_live) * (rng.random(n_live) < 0.15)
    if drops:
        live[0, 0] = 10_000                        # fits no type
    order = sorted(range(n_live), key=lambda i: tuple(-live[i]))
    shapes[:n_live] = live[order]
    counts = np.zeros(S, np.int64)
    counts[:n_live] = rng.integers(1, 40, n_live)
    totals = np.zeros((T, R), np.int64)
    totals[:n_types, 0] = np.sort(rng.integers(8, 96, n_types))
    totals[:n_types, 1] = rng.integers(8, 160, n_types)
    totals[:n_types, 2] = rng.integers(5, 60, n_types) * pods_unit
    totals[:n_types, 3] = rng.integers(0, 3, n_types)
    reserved0 = np.zeros((T, R), np.int64)
    reserved0[:n_types, :2] = (totals[:n_types, :2]
                               * rng.random((n_types, 2)) * 0.2).astype(np.int64)
    valid = np.zeros(T, bool)
    valid[:n_types] = True
    prices = np.full(T, INT32_MAX, np.int64)
    prices[:n_types] = rng.integers(1, 6, n_types) * 1000  # many ties
    return dict(shapes=shapes.astype(np.int32), counts=counts.astype(np.int32),
                dropped=np.zeros(S, np.int32), totals=totals.astype(np.int32),
                reserved0=reserved0.astype(np.int32), valid=valid,
                last_valid=n_types - 1, pods_unit=pods_unit,
                prices=prices.astype(np.int32))


def torch_args(p):
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    return (t(p["shapes"]), t(p["counts"]), t(p["dropped"]), t(p["totals"]),
            t(p["reserved0"]), t(p["valid"]), p["last_valid"], p["pods_unit"])


def jax_args(p):
    return (jnp.asarray(p["shapes"]), jnp.asarray(p["counts"]),
            jnp.asarray(p["dropped"]), jnp.asarray(p["totals"]),
            jnp.asarray(p["reserved0"]), jnp.asarray(p["valid"]),
            jnp.asarray(p["last_valid"], jnp.int32),
            jnp.asarray(p["pods_unit"], jnp.int32))


def plain_flat(p, L, cost=False):
    return pack_chunk_plain(*torch_args(p), num_iters=L,
                            prices=torch.as_tensor(p["prices"]),
                            cost_tiebreak=cost).numpy()


def committed(counts, dropped, done, chosen, q, packed):
    recs = [(int(chosen[i]), int(q[i]), tuple(int(v) for v in packed[i]))
            for i in range(len(q)) if q[i] > 0]
    return recs, np.asarray(counts).tolist(), np.asarray(dropped).tolist(), bool(done)


CASES = [  # (S, T, drops, cost)
    (32, 16, False, False),
    (32, 16, True, False),
    (64, 32, False, True),
    (64, 32, True, True),
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("S,T,drops,cost", CASES)
def test_plain_matches_xla_scan(seed, S, T, drops, cost):
    p = make_problem(seed, S, T, drops=drops)
    L = 64
    xla = jax_pack_chunk(*jax_args(p), num_iters=L,
                         prices=jnp.asarray(p["prices"]), cost_tiebreak=cost)
    got = unpack_flat(plain_flat(p, L, cost), S, L)
    assert committed(*got) == committed(*[np.asarray(x) for x in xla])
    if drops:
        assert got[1].sum() > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cost", [False, True])
def test_plain_matches_pallas_whole_buffer(seed, cost):
    S, T, L = 16, 8, 16
    p = make_problem(seed, S, T, drops=seed == 7)
    pallas = np.asarray(pack_chunk_pallas_flat(
        *jax_args(p), num_iters=L, interpret=True,
        prices=jnp.asarray(p["prices"]), cost_tiebreak=cost))
    np.testing.assert_array_equal(plain_flat(p, L, cost), pallas)


@pytest.mark.parametrize("seed", SEEDS)
def test_chunk_resume_matches_pallas(seed):
    """num_iters=2 forces done=False; each resumed chunk's whole buffer
    equals the Pallas kernel's on the same carried counts/dropped."""
    S, T, L = 16, 8, 2
    p = make_problem(seed, S, T, drops=True)
    for _ in range(64):
        want = np.asarray(pack_chunk_pallas_flat(
            *jax_args(p), num_iters=L, interpret=True))
        got = plain_flat(p, L)
        np.testing.assert_array_equal(got, want)
        counts, dropped, done, *_ = unpack_flat(got, S, L)
        if done:
            break
        p = dict(p, counts=np.array(counts), dropped=np.array(dropped))
    assert done


@pytest.mark.parametrize("seed", SEEDS)
def test_compute_maxfit_exact(seed):
    p = make_problem(seed, 64, 32)
    want = np.asarray(jax_compute_maxfit(
        jnp.asarray(p["shapes"]), jnp.asarray(p["totals"]),
        jnp.asarray(p["reserved0"]), jnp.asarray(p["valid"])))
    got = compute_maxfit(*(torch.as_tensor(p[k]) for k in
                           ("shapes", "totals", "reserved0", "valid")))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_wrapper_takes_plain_version_on_cpu(seed):
    p = make_problem(seed, 32, 16, drops=True)
    before = pack_cuda.LAUNCHES
    got = pack_chunk(*torch_args(p), num_iters=8)
    assert pack_cuda.LAUNCHES == before  # no kernel on a CPU tensor
    np.testing.assert_array_equal(got.numpy(), plain_flat(p, 8))


def test_all_counts_zero_is_done_with_empty_rows():
    p = make_problem(3, 16, 8)
    p["counts"][:] = 0
    counts, dropped, done, chosen, q, packed = unpack_flat(plain_flat(p, 4), 16, 4)
    assert done and not q.any() and not packed.any()
    assert (chosen == -1).all()


def test_plain_version_reports_the_work_it_walked():
    p = make_problem(5, 32, 16)
    stats = {}
    pack_chunk_plain(*torch_args(p), num_iters=64, stats=stats)
    assert 0 < stats["shape_steps"] <= stats["type_steps"]
