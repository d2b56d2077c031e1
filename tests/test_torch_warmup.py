"""Boot warm-up and the kernel library directory (solver/warmup.py),
against the JAX package's warm-up where the two agree.

One or two small buckets keep the tests fast: the pass drives the entries
the serving path launches (the solo pack with its maxfit, the batched pack
and a solo DeviceRun whose ring slot stays resident), and, unlike the JAX
package's, a failure raises. The CUDA libraries are built only on a CUDA
device; here the pass builds and loads the native ring.
"""

import pytest

from karpenter_tpu.solver import warmup as jax_warmup
from karpenter_tpu.solver.solve import SolverConfig as JaxSolverConfig
from karpenter_tpu_torch import build_dir, native
from karpenter_tpu_torch.solver import pipeline, warmup
from karpenter_tpu_torch.solver.solve import SolverConfig, solve
from tests.test_torch_solve import build


def test_empty_dir_keeps_the_build_directory():
    before = build_dir.PATH
    assert warmup.configure_compilation_cache("") is False
    assert build_dir.PATH == before


def test_cache_dir_becomes_the_library_directory(tmp_path, monkeypatch):
    """The libraries are built into the named directory and a second build
    there loads what the first left (named by digest)."""
    monkeypatch.setattr(build_dir, "PATH", build_dir.PATH)
    cache = tmp_path / "kernels"
    assert warmup.configure_compilation_cache(str(cache)) is True
    assert cache.is_dir() and build_dir.PATH == cache
    path = native.build()
    assert path.parent == cache
    assert native.build() == path


@pytest.mark.parametrize("include_ring", [True, False])
def test_run_count_matches_the_jax_warmup(include_ring):
    """One (8, 8) bucket: the JAX package counts one solo entry, one batch
    entry and, with include_ring, the ring prebuild, and so does the port."""
    got = warmup.warmup_pass(SolverConfig(), shape_buckets=[8], type_buckets=[8],
                             device="cpu", include_ring=include_ring)
    assert got == jax_warmup.warmup_pass(JaxSolverConfig(), shape_buckets=[8],
                                         type_buckets=[8], include_ring=include_ring)
    assert got == 2 + include_ring


def test_ring_prebuild_leaves_a_warm_slot():
    pipeline.reset_ring()
    warmup.warmup_pass(SolverConfig(), shape_buckets=[8], type_buckets=[8],
                       device="cpu")
    c1 = pipeline.get_ring().counters()
    assert c1["slots"] == 1 and c1["allocations"] >= 1
    # a second pass over the same bucket refills, never allocates
    warmup.warmup_pass(SolverConfig(), shape_buckets=[8], type_buckets=[8],
                       device="cpu")
    c2 = pipeline.get_ring().counters()
    assert c2["allocations"] == c1["allocations"] and c2["refills"] > c1["refills"]


def test_first_solve_at_a_warmed_bucket_allocates_no_ring_buffer():
    """The default ladder walks shape buckets largest first, so the ring's
    four slots end on the smallest shape bucket: a first solve of a few
    shapes over 20 types (the (8, 32) bucket) refills what warm-up left."""
    pipeline.reset_ring()
    n = warmup.warmup_pass(SolverConfig(), device="cpu")
    assert n == 3 * 9 * 6
    warm = pipeline.get_ring().counters()
    assert warm["slots"] == pipeline.get_ring().max_slots
    constraints, pods, catalog = build("port", 2, 600, 20, 6)
    solve(constraints, pods, catalog, device="cpu", config=SolverConfig(device_min_pods=0))
    after = pipeline.get_ring().counters()
    assert after["allocations"] == warm["allocations"]
    assert after["refills"] > warm["refills"]


def test_a_warmup_error_raises(monkeypatch):
    """The JAX package logs and swallows a failed bucket (its
    test_failed_bucket_is_swallowed); the port's boot fails instead."""
    def boom(S, T):
        raise RuntimeError("synthetic failure")

    monkeypatch.setattr(warmup, "synthetic_encoding", boom)
    with pytest.raises(RuntimeError, match="synthetic failure"):
        warmup.warmup_pass(SolverConfig(), shape_buckets=[8], type_buckets=[8],
                           device="cpu")


def test_a_failed_library_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "ffd.cc"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(build_dir, "PATH", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        warmup.warmup_pass(SolverConfig(), shape_buckets=[8], type_buckets=[8],
                           device="cpu")
