"""The port's batched window (solver/batch_solve) against the JAX package's.

Each window is built separately in both packages from the same seeded
numbers (``tests.test_torch_solve``'s catalog and pod generators): a
catalog of priced types offered in a random subset of three zones, and
schedules that are the universe constraints narrowed to one zone, each with
its own pods. Both packages' ``solve_batch`` solve it; node counts, every
packing's option names and pod lists, and the unschedulable pods must be
equal problem for problem. The port runs on the CPU (``device="cpu"``): the
mask program as torch ops, the pack kernel's plain version. Exact: the
work is all integer.
"""

import numpy as np
import pytest

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.api import wellknown as jax_wellknown
from karpenter_tpu.solver import batch_solve as jax_batch
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch.api.constraints import Constraints as PortConstraints
from karpenter_tpu_torch.ops import device_filter
from karpenter_tpu_torch.parallel import batched_pack
from karpenter_tpu_torch.solver import batch_solve
from karpenter_tpu_torch.solver import solve as port_solve_mod
from tests.test_torch_solve import build, canonical

ZONES = ("z-1", "z-2", "z-3")


def window(pkg, seed, n_problems, pods_each, n_types, n_shapes, extra=None):
    """One window in package ``pkg`` over one catalog: problem b is the
    universe constraints narrowed to zone b mod 3, with its own seeded pods
    (``pods_each + 7b`` of them over ``n_shapes`` shapes, or
    ``n_shapes[b]`` when a list, and one pod that fits no type in every odd
    problem). ``extra="unencodable"`` adds to problem 0 a pod whose 1n cpu
    no int32 scale can hold; ``extra="empty"`` gives problem 1 an empty
    zone set."""
    core = jax_core if pkg == "jax" else port_core
    wk = jax_wellknown if pkg == "jax" else port_wellknown
    mod = jax_batch if pkg == "jax" else batch_solve
    universe, _, catalog = build(pkg, seed, 0, n_types, 1)
    problems = []
    for b in range(n_problems):
        shapes = n_shapes[b] if isinstance(n_shapes, list) else n_shapes
        _, pods, _ = build(pkg, seed * 31 + b, pods_each + 7 * b, 1, shapes, too_big=b % 2)
        zones = [] if (extra == "empty" and b == 1) else [ZONES[b % 3]]
        reqs = universe.requirements.add(core.NodeSelectorRequirement(
            key=wk.LABEL_TOPOLOGY_ZONE, operator="In", values=zones))
        if pkg == "jax":
            constraints = universe.deepcopy()
            constraints.requirements = reqs
        else:
            constraints = PortConstraints(requirements=reqs)
        if extra == "unencodable" and b == 0:
            pods.append(core.Pod(spec=core.PodSpec(containers=[core.Container(
                resources=core.ResourceRequirements.make(
                    requests={"cpu": "1n", "memory": "64Mi"}))])))
        problems.append(mod.Problem(constraints=constraints, pods=pods,
                                    instance_types=catalog))
    return problems


def solve_both(seed, n_problems, pods_each, n_types, n_shapes, extra=None, **cfg):
    """Both packages' solve_batch on the same window. The port's batched
    device path is taken at any window size (device_min_pods=0) unless
    ``device_min_pods`` is passed, which then applies to both packages; the
    JAX package keeps its gate otherwise (its plans do not depend on the
    executor)."""
    jprobs = window("jax", seed, n_problems, pods_each, n_types, n_shapes, extra)
    pprobs = window("port", seed, n_problems, pods_each, n_types, n_shapes, extra)
    want = jax_batch.solve_batch(jprobs, jax_solve_mod.SolverConfig(
        device_timeout_s=0, device_hedge=False, **cfg))
    port_solve_mod.reset_executor_counts()
    device_filter.reset_fallback_counts()
    port_cfg = {"device_min_pods": 0, **cfg}
    handle = batch_solve.dispatch_batch(pprobs, port_solve_mod.SolverConfig(**port_cfg),
                                        device="cpu")
    got = handle.fetch()
    for b, (g, w, pp, jp) in enumerate(zip(got, want, pprobs, jprobs)):
        assert canonical(g, pp.pods) == canonical(w, jp.pods), f"problem {b}"
    return handle, got, pprobs


def executors():
    return port_solve_mod.solver_health()["executor_counts"]


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_fused_window_matches_jax(seed):
    handle, got, probs = solve_both(seed, 5, 90, 36, 40)
    assert handle.device_run is not None and handle.fused is not None
    assert executors() == {"device-batch": 5}
    assert device_filter.fallback_counts() == {}
    assert handle.device_run.launches == len(handle.device_run.buckets) == 1
    assert [len(r.unschedulable) for r in got] == [0, 1, 0, 1, 0]  # the too-big pods


@pytest.mark.parametrize("seed", [1, 7])
def test_host_filtered_window_matches_jax(seed):
    handle, _, _ = solve_both(seed, 4, 80, 30, 30, device_filter=False)
    assert handle.device_run is not None and handle.fused is None
    assert executors() == {"device-batch": 4}


def test_kill_switch_takes_the_host_filter(monkeypatch):
    monkeypatch.setenv("KARPENTER_DEVICE_FILTER", "0")
    handle, _, _ = solve_both(3, 3, 60, 24, 20)
    assert handle.device_run is not None and handle.fused is None
    assert executors() == {"device-batch": 3}


def test_lone_problem_is_solved_alone():
    handle, _, _ = solve_both(5, 1, 120, 24, 30)
    assert handle.device_run is None and executors() == {"device": 1}


@pytest.mark.parametrize("gate", ["default", "off"])
def test_small_window_joins_the_batch(gate):
    """135 pods: under the default gate (device_min_pods=512) both packages
    solve them one by one on the native host ring; with the gate off
    (device_min_pods=0) the window is one batched launch."""
    if gate == "default":
        handle, _, _ = solve_both(6, 3, 40, 24, 20, device_min_pods=512)
        assert handle.device_run is None and executors() == {"native": 3}
    else:
        handle, _, _ = solve_both(6, 3, 40, 24, 20)
        assert handle.device_run.launches == 1 and executors() == {"device-batch": 3}


@pytest.mark.parametrize("device_filter_on", [True, False])
def test_unencodable_member_goes_to_the_host_oracle(device_filter_on):
    handle, _, _ = solve_both(8, 4, 70, 24, 20, extra="unencodable",
                              device_filter=device_filter_on)
    assert handle.device_run is not None
    assert executors() == {"device-batch": 3, "host": 1}


def test_empty_allowed_set_member_is_solved_alone():
    handle, got, probs = solve_both(9, 4, 70, 24, 20, extra="empty")
    assert 1 not in handle.fused.batch_idx
    assert executors() == {"device-batch": 3}  # no executor runs for no types
    assert got[1].node_count == 0 and len(got[1].unschedulable) == len(probs[1].pods)


def test_member_beyond_the_largest_shape_bucket_is_solved_alone(monkeypatch):
    """The encoder's own limit: a member with more distinct shapes than the
    largest bucket (cut to 64 here) cannot be padded, so it leaves the
    batch, and the solo path hands it to the native host ring, which takes
    the exact-size encoding (the JAX package's order of executors)."""
    from karpenter_tpu_torch.ops import encode as port_encode

    monkeypatch.setattr(port_encode, "SHAPE_BUCKETS", (8, 16, 32, 64))
    handle, _, probs = solve_both(10, 4, 120, 24, [400, 8, 8, 8])
    assert 0 not in handle.fused.batch_idx
    assert executors() == {"device-batch": 3, "native": 1}


@pytest.mark.parametrize("seed", [2, 11])
def test_chunk_resume_with_compaction_matches_jax(seed):
    """Two node decisions a chunk: the batch resumes many times and the
    shapes of the whole batch compact down the buckets as they run out."""
    handle, _, _ = solve_both(seed, 4, 150, 30, 120, chunk_iters=2)
    run = handle.device_run
    assert run.launches > 2 and len(run.buckets) > 1
    assert run.buckets == sorted(run.buckets, reverse=True)
    assert executors() == {"device-batch": 4}


@pytest.mark.parametrize("device_filter_on", [True, False])
def test_cost_tiebreak_matches_jax(device_filter_on):
    handle, _, _ = solve_both(12, 4, 100, 36, 40, cost_tiebreak=True,
                              device_filter=device_filter_on)
    assert handle.device_run.use_cost
    assert executors() == {"device-batch": 4}


def test_sabotaged_mask_self_heals_and_is_counted(monkeypatch):
    """A mask program that wrongly admits every type for schedule 0: the
    probe check catches it, the problem is solved again on the host path
    (scalar wins, so the answer is still the JAX package's), and the
    mismatch is counted."""
    real = device_filter._mask_expr

    def sabotaged(*args):
        mask = real(*args).clone()
        mask[0, :] = True
        return mask

    monkeypatch.setattr(device_filter, "_mask_expr", sabotaged)
    solve_both(13, 4, 80, 30, 30)
    assert device_filter.fallback_counts() == {"device-mask-mismatch": 1}
    assert executors() == {"device-batch": 3, "device": 1}


def test_a_failing_launch_raises_out_of_fetch_and_dispatch(monkeypatch):
    """No fallback hides a kernel failure: a pack_batch that raises on the
    resumed chunk makes fetch() raise (and raise again), with no executor
    counted; one that raises on the first chunk makes dispatch_batch
    raise."""
    probs = window("port", 14, 3, 120, 24, 60)
    cfg = port_solve_mod.SolverConfig(chunk_iters=1, device_min_pods=0)
    real, calls = batched_pack.pack_batch, []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) >= 2:
            raise RuntimeError("pack kernel launch failed (injected)")
        return real(*args, **kw)

    monkeypatch.setattr(batched_pack, "pack_batch", failing)
    port_solve_mod.reset_executor_counts()
    handle = batch_solve.dispatch_batch(probs, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        handle.fetch()
    with pytest.raises(RuntimeError, match="earlier fetch"):
        handle.fetch()
    assert executors() == {}
    calls.append(1)
    with pytest.raises(RuntimeError, match="injected"):
        batch_solve.dispatch_batch(probs, cfg, device="cpu")
    assert executors() == {}


def test_fetch_is_idempotent():
    probs = window("port", 15, 3, 100, 24, 30)
    port_solve_mod.reset_executor_counts()
    cfg = port_solve_mod.SolverConfig(device_min_pods=0)
    handle = batch_solve.dispatch_batch(probs, cfg, device="cpu")
    assert handle.in_flight
    first = handle.fetch()
    assert not handle.in_flight
    assert handle.fetch() is first
    assert executors() == {"device-batch": 3}
    solo = [port_solve_mod.solve(p.constraints, p.pods, p.instance_types, device="cpu",
                                 config=cfg) for p in probs]
    assert [canonical(r, p.pods) for r, p in zip(first, probs)] == \
        [canonical(r, p.pods) for r, p in zip(solo, probs)]


def test_fused_mask_reaches_the_kernel_as_valid():
    """The fused run's valid and last_valid are the mask program's tensors
    (never rebuilt on the host), and a batch of B problems is one launch."""
    probs = window("port", 16, 4, 80, 30, 20)
    handle = batch_solve.dispatch_batch(probs, port_solve_mod.SolverConfig(device_min_pods=0),
                                        device="cpu")
    run = handle.device_run
    assert run.valid_d is handle.fused.mask_d and run.last_valid_d is handle.fused.last_valid_d
    assert run.valid_d.shape == (4, 32) and run.launches == 1
    lv = run.last_valid_d.numpy()
    mask = run.valid_d.numpy()
    assert all(mask[b, lv[b]] and not mask[b, lv[b] + 1:].any() for b in range(4))
    assert np.array_equal(run.maxfit_d.numpy().shape, (4, run.S0))
    handle.fetch()
