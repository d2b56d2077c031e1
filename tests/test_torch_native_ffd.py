"""The port's native host ring (karpenter_tpu_torch/native/ffd.cc through
solver/native_ffd.py) against the JAX package's ring and the per-pod
oracle host_ffd.pack, and the routing under ``device_min_pods``.

The cases of tests/test_native_ffd.py: a randomized differential, the
per-pod kernel's full result key, and the record-buffer bound at tiny
S × T (the fuzz soak's case 1897). Both packages build their own pods,
catalog and packables from the same seeded numbers (test_torch_solve's
``build``); every comparison is exact. The ring is built with the host's
C++ compiler into the kernel library directory.
"""

import random

import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.solver import batch_solve as jax_batch
from karpenter_tpu.solver import native_ffd as jax_native
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu.solver.adapter import build_packables as jax_build_packables
from karpenter_tpu.solver.adapter import pod_vector as jax_pod_vector
from karpenter_tpu_torch import build_dir, native
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.solver import batch_solve as port_batch
from karpenter_tpu_torch.solver import host_ffd
from karpenter_tpu_torch.solver import native_ffd
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
from tests.test_torch_solve import build, canonical


def key(r):
    """A host result's full key: per-node pod sets, options, quantities."""
    return (sorted((tuple(p.instance_type_indices), p.node_quantity,
                    sorted(tuple(sorted(n)) for n in p.pod_ids))
                   for p in r.packings),
            sorted(r.unschedulable))


def problems(seed, n_pods, n_types, n_shapes, too_big=0):
    """The same problem in each package: (vecs, ids, packables)."""
    jc, jpods, jcat = build("jax", seed, n_pods, n_types, n_shapes, too_big)
    pc, ppods, pcat = build("port", seed, n_pods, n_types, n_shapes, too_big)
    jpack, _ = jax_build_packables(jcat, jc, jpods, [])
    ppack, _ = build_packables(pcat, pc, ppods, [])
    ids = list(range(len(ppods)))
    return ([jax_pod_vector(p) for p in jpods], ids, jpack), (pod_vectors(ppods), ids, ppack)


@pytest.mark.parametrize("trial", range(8))
def test_ring_matches_the_jax_ring_and_the_oracle(trial):
    rng = random.Random(20260729 + trial)
    (jv, ids, jp), (pv, _, pp) = problems(rng.randint(1, 10**6), rng.randint(1, 400),
                                          rng.randint(1, 25), rng.randint(1, 30),
                                          too_big=rng.choice([0, 0, 3]))
    assert pv == [tuple(v) for v in jv]
    got = native_ffd.solve_ffd_native(pv, ids, pp)
    want = jax_native.solve_ffd_native(jv, ids, jp)
    oracle = host_ffd.pack(pv, ids, pp)
    assert key(got) == key(want)
    assert got.node_count == oracle.node_count
    assert sorted(got.unschedulable) == sorted(oracle.unschedulable)
    placed = sorted(i for p in got.packings for node in p.pod_ids for i in node)
    assert placed == sorted(set(ids) - set(got.unschedulable))


@pytest.mark.parametrize("seed", [3, 17])
def test_cost_tiebreak_matches_the_jax_ring(seed):
    (jv, ids, jp), (pv, _, pp) = problems(seed, 300, 20, 12)
    prices = [round(0.1 + 0.37 * ((i * 7) % 5), 2) for i in range(len(pp))]
    got = native_ffd.solve_ffd_native(pv, ids, pp, prices=prices, cost_tiebreak=True)
    want = jax_native.solve_ffd_native(jv, ids, jp, prices=prices, cost_tiebreak=True)
    assert key(got) == key(want)


@pytest.mark.parametrize("trial", range(6))
def test_per_pod_ring_equals_the_python_oracle(trial):
    """kt_ffd_pack_per_pod transcribes packer.go:109-141: it reproduces
    host_ffd.pack to the full result key, in both packages."""
    rng = random.Random(3_2026 + trial)
    (jv, ids, jp), (pv, _, pp) = problems(rng.randint(1, 10**6), rng.randint(1, 300),
                                          rng.randint(1, 25), rng.randint(1, 20))
    got = native_ffd.solve_ffd_per_pod_native(pv, ids, pp)
    assert key(got) == key(host_ffd.pack(pv, ids, pp))
    assert key(got) == key(jax_native.solve_ffd_per_pod_native(jv, ids, jp))


def test_auto_takes_the_per_pod_ring_above_the_crossover(monkeypatch):
    (jv, ids, jp), (pv, _, pp) = problems(5, 400, 12, 40)
    monkeypatch.setattr(native_ffd, "PER_POD_SHAPE_CROSSOVER", 8)
    monkeypatch.setattr(jax_native, "PER_POD_SHAPE_CROSSOVER", 8)
    calls = []
    real = native_ffd.solve_ffd_per_pod_native
    monkeypatch.setattr(native_ffd, "solve_ffd_per_pod_native",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = native_ffd.solve_ffd_native_auto(pv, ids, pp)
    assert calls == [1]
    assert key(got) == key(jax_native.solve_ffd_native_auto(jv, ids, jp))


def test_record_buffer_bound_at_tiny_shape_type_cardinality():
    """The fuzz soak's case 1897 (tests/test_native_ffd.py): 2 shapes × 2
    types needing more records than the old min(4·S·T, pods+S)+16 cap. The
    JAX generator's pods go through each package's own encoder; the port's
    shape-level ring must answer (no overflow decline) with the oracle's
    key."""
    from karpenter_tpu.controllers.provisioning import universe_constraints
    from karpenter_tpu_torch.ops.encode import encode
    from tests.test_fuzz_parity import _random_catalog, _random_daemons, _random_pods

    rng = random.Random(20260729)  # the fuzz seed
    for _ in range(1898):          # walk the stream to case 1897
        catalog = _random_catalog(rng)
        pods = _random_pods(rng)
        daemons = _random_daemons(rng)
    jpack, _ = jax_build_packables(catalog, universe_constraints(catalog), pods, daemons)
    vecs = [tuple(jax_pod_vector(p)) for p in pods]
    ids = list(range(len(pods)))
    pp = [host_ffd.Packable(p.index, list(p.total), list(p.reserved)) for p in jpack]
    enc = encode(vecs, ids, pp, pad=False)
    S, T = enc.num_shapes, enc.num_types
    old_cap = min(4 * S * max(T, 1), len(pods) + S) + 16
    oracle = host_ffd.pack(vecs, ids, pp)
    assert oracle.node_count > old_cap, "case 1897 no longer exercises the record cap"
    got = native_ffd.solve_ffd_native(vecs, ids, pp)
    assert got is not None, "the shape-level ring declined a tiny-S·T many-record problem"
    assert (got.node_count, sorted(got.unschedulable)) == \
        (oracle.node_count, sorted(oracle.unschedulable))
    assert key(got) == key(jax_native.solve_ffd_native(vecs, ids, jpack))


def test_empty_packables_report_every_pod():
    got = native_ffd.solve_ffd_native([(10**9,) + (0,) * 7], [0], [])
    assert got.node_count == 0 and got.unschedulable == [0]


def test_library_is_named_by_digest_and_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(build_dir, "PATH", tmp_path)
    path = native.build()
    assert path.parent == tmp_path and path.name.startswith("libkt_ffd_")
    assert [p.name for p in tmp_path.iterdir()] == [path.name]  # no temp left
    mtime = path.stat().st_mtime_ns
    assert native.build() == path and path.stat().st_mtime_ns == mtime


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No toolchain or a broken source is an error, never a quiet
    fallback to the Python oracle."""
    broken = tmp_path / "ffd.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(build_dir, "PATH", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.load()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()


@pytest.mark.parametrize("n_pods,executor", [(16, "native"), (511, "native"),
                                             (512, "device"), (700, "device")])
def test_solve_routes_by_device_min_pods(n_pods, executor):
    """Below 512 pods the ring answers, at and above it the device path:
    the same plans as the JAX package's solve() under its default gate."""
    jc, jpods, jcat = build("jax", 4, n_pods, 20, 40)
    pc, ppods, pcat = build("port", 4, n_pods, 20, 40)
    want = jax_solve_mod.solve(jc, jpods, jcat,
                               config=jax_solve_mod.SolverConfig(device_timeout_s=0))
    port_solve_mod.reset_executor_counts()
    got = port_solve_mod.solve(pc, ppods, pcat, device="cpu")
    assert port_solve_mod.solver_health()["executor_counts"] == {executor: 1}
    assert canonical(got, ppods) == canonical(want, jpods)


def test_unencodable_problem_takes_the_python_oracle():
    """A pod of 1n cpu beside whole-Mi memory has no int32 scale: the exact
    encoding fails, so under the gate neither the device nor the ring can
    take the problem and host_ffd.pack answers, as in the JAX package."""
    def with_odd_pod(pkg):
        core = jax_core if pkg == "jax" else port_core
        constraints, pods, catalog = build(pkg, 6, 40, 8, 6)
        pods.append(core.Pod(spec=core.PodSpec(containers=[core.Container(
            resources=core.ResourceRequirements.make(
                requests={"cpu": "1n", "memory": "64Mi"}))])))
        return constraints, pods, catalog

    jc, jpods, jcat = with_odd_pod("jax")
    pc, ppods, pcat = with_odd_pod("port")
    want = jax_solve_mod.solve(jc, jpods, jcat,
                               config=jax_solve_mod.SolverConfig(device_timeout_s=0))
    port_solve_mod.reset_executor_counts()
    got = port_solve_mod.solve(pc, ppods, pcat, device="cpu")
    assert port_solve_mod.solver_health()["executor_counts"] == {"host": 1}
    assert canonical(got, ppods) == canonical(want, jpods)


def batch_window(pkg, seed, n, pods_each):
    from tests.test_torch_batch_solve import window

    return window(pkg, seed, n, pods_each, 24, 20)


@pytest.mark.parametrize("pods_each,executors", [(40, {"native": 3}),
                                                 (200, {"device-batch": 3})])
def test_window_joins_the_batch_at_the_gate(pods_each, executors):
    """A window joins the device batch only when its problems hold 512 pods
    together (JAX batch_solve.py:106-107); a smaller one is answered
    problem by problem on the ring. Plans equal the JAX package's."""
    from tests.test_torch_batch_solve import canonical as bcanon

    jprobs = batch_window("jax", 6, 3, pods_each)
    pprobs = batch_window("port", 6, 3, pods_each)
    want = jax_batch.solve_batch(jprobs, jax_solve_mod.SolverConfig(
        device_timeout_s=0, device_hedge=False))
    port_solve_mod.reset_executor_counts()
    handle = port_batch.dispatch_batch(pprobs, device="cpu")
    got = handle.fetch()
    assert port_solve_mod.solver_health()["executor_counts"] == executors
    assert (handle.device_run is not None) == ("device-batch" in executors)
    for g, w, pp, jp in zip(got, want, pprobs, jprobs):
        assert bcanon(g, pp.pods) == bcanon(w, jp.pods)
