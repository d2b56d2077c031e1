"""The port's batched pack against the JAX package's batched call.

Batches are built with numpy from a seed (``tests.test_torch_pack``'s
problem generator, one problem per row inside one bucket) and handed to:

- ``ops.pack_cuda.pack_batch`` on the CPU, i.e. ``pack_batch_plain``, the
  twin the H100 kernel is held against;
- the JAX package's ``pack_batch_sharded_flat`` on a one-device mesh, with
  ``kernel="xla"`` (compared on counts, dropped, done and every committed
  (q > 0) row: the XLA scan leaves stale values in its other rows) and with
  ``kernel="pallas", interpret=True`` (the whole flat buffer).

Rows differ in live shapes, valid types and ``last_valid``; some rows are
all zero and one has no valid type at all (a device mask row with nothing
feasible). Tolerance is exact: the work is all integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops.compact import compact_rows as jax_compact_rows
from karpenter_tpu.ops.pack import compute_maxfit as jax_compute_maxfit
from karpenter_tpu.parallel.mesh import solver_mesh
from karpenter_tpu.parallel.sharded_pack import (
    pack_batch_sharded_flat, pack_batch_sharded_ring,
    pad_problems as jax_pad_problems, unpack_batch_flat as jax_unpack_batch_flat,
)
from karpenter_tpu_torch.ops import pack as port_pack
from karpenter_tpu_torch.ops import pack_cuda
from karpenter_tpu_torch.ops.compact import compact_rows
from karpenter_tpu_torch.ops.encode import encoding_from_arrays
from karpenter_tpu_torch.ops.pack import compute_maxfit, unpack_flat
from karpenter_tpu_torch.ops.pack_cuda import (
    batch_log_bound, compute_log_bound, pack_batch, pack_chunk_plain,
)
from karpenter_tpu_torch.parallel.batched_pack import (
    pack_batch_ring, pad_problems, unpack_batch_flat,
)
from tests.test_torch_pack import INT32_MAX, SEEDS, committed, make_problem

KEYS = ("shapes", "counts", "dropped", "totals", "reserved0", "valid",
        "last_valid", "pods_unit")


def make_batch(seed, B, S, T, drops=False):
    """B problems of one (S, T) bucket: row 1 is all zero (a finished or
    padding problem), row 2 has no valid type (last_valid 0), the others
    differ in live shapes and valid types."""
    rows = [make_problem(seed * 100 + b, S, T, drops=drops and b % 2 == 0)
            for b in range(B)]
    if B > 1:
        rows[1]["counts"][:] = 0
    if B > 2:
        rows[2]["valid"][:] = False
        rows[2]["last_valid"] = 0
    batch = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in KEYS + ("prices",)}
    batch["last_valid"] = batch["last_valid"].astype(np.int32)
    batch["pods_unit"] = batch["pods_unit"].astype(np.int32)
    return batch


def port_args(batch):
    return tuple(torch.as_tensor(batch[k]) for k in KEYS)


def jax_args(batch):
    return tuple(jnp.asarray(batch[k]) for k in KEYS)


def one_device_mesh():
    return solver_mesh(devices=jax.devices("cpu")[:1])


def port_flat(batch, L, cost=False, **kw):
    return pack_batch(*port_args(batch), L, prices=torch.as_tensor(batch["prices"]),
                      cost_tiebreak=cost, **kw).numpy()


def jax_flat(batch, L, kernel, cost=False):
    return np.asarray(pack_batch_sharded_flat(
        *jax_args(batch), num_iters=L, mesh=one_device_mesh(), kernel=kernel,
        interpret=kernel == "pallas", prices=jnp.asarray(batch["prices"]),
        cost_tiebreak=cost))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cost", [False, True])
def test_pack_batch_matches_xla_on_committed_rows(seed, cost):
    B, S, T, L = 5, 32, 16, 64
    batch = make_batch(seed, B, S, T, drops=True)
    got = unpack_batch_flat(port_flat(batch, L, cost), S, L)
    want = jax_unpack_batch_flat(jax_flat(batch, L, "xla", cost), S, L)
    for b in range(B):
        assert committed(*(x[b] for x in got)) == committed(*(x[b] for x in want)), b
    assert got[1][2].sum() == batch["counts"][2].sum()  # no valid type: all dropped


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cost", [False, True])
def test_pack_batch_matches_pallas_whole_buffer(seed, cost):
    B, S, T, L = 3, 16, 8, 16
    batch = make_batch(seed, B, S, T, drops=seed == 7)
    np.testing.assert_array_equal(port_flat(batch, L, cost),
                                  jax_flat(batch, L, "pallas", cost))


@pytest.mark.parametrize("seed", SEEDS)
def test_ring_contract_and_resume_match_the_jax_ring(seed):
    """pack_batch_ring returns (flat, counts_next, dropped_next) with
    counts_next = flat[:, :S] contiguous and zeroed dropped rows; chained
    through num_iters=2 chunks, every flat buffer and counts_next equal the
    JAX package's donating ring call on the Pallas kernel."""
    B, S, T, L = 3, 16, 8, 2
    batch = make_batch(seed, B, S, T, drops=True)
    args, jargs = list(port_args(batch)), list(jax_args(batch))
    for _ in range(64):
        flat, counts_next, dropped_next = pack_batch_ring(*args, L)
        jflat, jcounts, jdropped = pack_batch_sharded_ring(
            *jargs, num_iters=L, mesh=one_device_mesh(), kernel="pallas", interpret=True)
        np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
        np.testing.assert_array_equal(counts_next.numpy(), np.asarray(jcounts))
        assert counts_next.is_contiguous() and counts_next.dtype == torch.int32
        assert torch.equal(counts_next, flat[:, :S])
        assert not dropped_next.any() and dropped_next.shape == (B, S)
        assert not np.asarray(jdropped).any()
        if unpack_batch_flat(flat.numpy(), S, L)[2].all():
            break
        args[1], args[2] = counts_next, dropped_next
        jargs[1], jargs[2] = jcounts, jdropped
    assert unpack_batch_flat(flat.numpy(), S, L)[2].all()


@pytest.mark.parametrize("seed", SEEDS)
def test_each_row_is_the_one_problem_buffer(seed):
    """Row b of a batch equals pack_chunk_plain on problem b alone (B = 1
    included): the batch is the one-problem function with a batch axis."""
    S, T, L = 32, 16, 64
    for B in (1, 4):
        batch = make_batch(seed, B, S, T)
        flat = port_flat(batch, L)
        assert flat.shape == (B, port_pack.flat_size(S, L))
        for b in range(B):
            want = pack_chunk_plain(*(torch.as_tensor(batch[k][b]) for k in KEYS[:6]),
                                    int(batch["last_valid"][b]), int(batch["pods_unit"][b]), L)
            np.testing.assert_array_equal(flat[b], want.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_maxfit_matches_jax_in_both_passes(seed, monkeypatch):
    batch = make_batch(seed, 4, 32, 16)
    want = np.stack([np.asarray(jax_compute_maxfit(
        jnp.asarray(batch["shapes"][b]), jnp.asarray(batch["totals"][b]),
        jnp.asarray(batch["reserved0"][b]), jnp.asarray(batch["valid"][b])))
        for b in range(4)])
    args = [torch.as_tensor(batch[k]) for k in ("shapes", "totals", "reserved0", "valid")]
    got = compute_maxfit(*args)
    assert got.dtype == torch.int32 and got.shape == (4, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(port_pack, "_BATCHED_ELEMENTS", 0)  # problem by problem
    np.testing.assert_array_equal(compute_maxfit(*args).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_log_bound_bounds_every_row_without_the_mask(seed):
    batch = make_batch(seed, 5, 32, 16)
    bound = batch_log_bound(batch["totals"], batch["reserved0"], batch["pods_unit"])
    assert bound == max(compute_log_bound(batch["totals"][b], batch["reserved0"][b],
                                          np.ones(16, bool), int(batch["pods_unit"][b]))
                        for b in range(5))
    stats = {}
    pack_batch(*port_args(batch), 64, maxfit=None)
    pack_cuda.pack_batch_plain(*port_args(batch), 64, stats=stats)
    assert stats["log_steps"] <= bound
    pu = batch["pods_unit"].copy()
    pu[0] = 0
    assert batch_log_bound(batch["totals"], batch["reserved0"], pu) == INT32_MAX


def test_wrapper_takes_plain_version_on_cpu():
    batch = make_batch(1, 3, 16, 8)
    before = (pack_cuda.LAUNCHES, pack_cuda.BATCH_LAUNCHES)
    port_flat(batch, 8)
    assert (pack_cuda.LAUNCHES, pack_cuda.BATCH_LAUNCHES) == before


def test_pad_problems_matches_jax():
    """The same encodings stack to the same arrays (one device: no batch
    padding), across two S and T buckets."""
    encs = []
    for seed, S, T in ((1, 16, 8), (2, 32, 16), (3, 8, 8)):
        p = make_problem(seed, S, T)
        encs.append(encoding_from_arrays(
            p["shapes"], p["counts"], p["totals"], p["reserved0"], p["valid"],
            p["last_valid"], p["pods_unit"], [[] for _ in range(S)], S, T))
    got, want = pad_problems(encs), jax_pad_problems(encs, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_compact_rows_matches_jax_and_gathers_maxfit(seed):
    rng = np.random.default_rng(seed)
    B, S, R = 4, 32, 8
    shapes = rng.integers(0, 50, (B, S, R)).astype(np.int32)
    maxfit = rng.integers(-1, 99, (B, S)).astype(np.int32)
    counts = (rng.integers(0, 5, (B, S)) * (rng.random((B, S)) < 0.3)).astype(np.int32)
    counts[1] = 0
    perms = [None, None, np.arange(S)[::-1].copy(), None]
    got = compact_rows(counts, perms, shapes, maxfit, 16)
    want = jax_compact_rows(counts, perms, shapes, 16)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for b in range(B):
        n = len(got[0][b])
        np.testing.assert_array_equal(got[3][b][:n], maxfit[b][got[0][b]])
        assert not got[3][b][n:].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_of_one_resumes_through_pack_chunk(seed, monkeypatch):
    """A batch of one (solve()'s device run) launches through pack_chunk,
    the one-problem entry, with last_valid and pods_unit as (1,) tensors,
    and keeps the ring contract: the same buffer as the batched call."""
    batch = make_batch(seed, 1, 16, 8, drops=True)
    args = port_args(batch)
    seen = []
    real = pack_cuda.pack_chunk

    def spy(*a, **kw):
        seen.append((a[6].shape, a[7].shape))
        return real(*a, **kw)

    monkeypatch.setattr(pack_cuda, "pack_chunk", spy)
    flat, counts_next, dropped_next = pack_batch_ring(*args, 4)
    assert seen == [((1,), (1,))]
    np.testing.assert_array_equal(flat.numpy(), pack_cuda.pack_batch_plain(*args, 4).numpy())
    assert torch.equal(counts_next, flat[:, :16]) and not dropped_next.any()


def test_unpack_batch_flat_raises_on_a_rows_error_word():
    batch = make_batch(2, 2, 16, 8)
    flat = port_flat(batch, 4)
    flat[1, 2 * 16] = -1
    with pytest.raises(RuntimeError, match="done word -1"):
        unpack_batch_flat(flat, 16, 4)
    assert unpack_flat(flat[0], 16, 4)[2] in (True, False)


def test_batched_launch_checks_its_arguments():
    """launch_pack_batch refuses what the kernel cannot take before it
    builds or launches anything."""
    batch = make_batch(1, 2, 16, 8)
    args = list(port_args(batch))
    maxfit = compute_maxfit(args[0], args[3], args[4], args[5])
    bad = list(args)
    bad[6] = bad[6].long()
    with pytest.raises(ValueError, match="pack_batch: last_valid must be a contiguous torch.int32"):
        pack_cuda.launch_pack_batch(*bad, 4, None, False, maxfit, 8, 7, 1)
    with pytest.raises(ValueError, match="pack_batch: shapes and totals must be"):
        pack_cuda.launch_pack_batch(args[0][0], *args[1:], 4, None, False, maxfit, 8, 7, 1)
    with pytest.raises(ValueError, match="pack_batch: no launch of 9 CTAs"):
        pack_cuda.launch_pack_batch(*args, 4, None, False, maxfit, 8, 7, 9)
    with pytest.raises(ValueError, match="pack_batch: prices must be"):
        pack_cuda.launch_pack_batch(*args, 4, torch.zeros(2, 9, dtype=torch.int32), True,
                                    maxfit, 8, 7, 1)
