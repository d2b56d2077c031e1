"""The type-axis SPMD route (B12) through the port's public entry points
against the JAX package's.

The JAX package reaches its type-sharded kernel from ``solve()`` through
``SolverConfig.device_kernel="type-spmd"``, and a window's lone problems
are solved with the same config; a batched window demotes the kernel with
a log line. The port does the same over the mesh its ``device`` argument
resolves to. The JAX package's automatic gate (``_maybe_type_spmd``,
``type_spmd_min_types``) has no counterpart: the port routes only where
the config names the kernel (an intended difference). Here the JAX side runs on its eight
virtual CPU devices (tests/conftest.py), the port's on a virtual mesh of
``["cpu"] * n``. The problems are the JAX suite's (tests/test_type_sharded.py
``TestTypeSpmdSolvePath``): the fake provider's incrementing catalog and
pods over nine cpu and five memory sizes, built separately in each
package. Every comparison is exact: the work is all integer.
"""

import logging
from types import SimpleNamespace

import pytest
import torch

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.cloudprovider.fake import provider as jax_fake
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.models.ffd import solve_ffd_device as jax_solve_ffd_device
from karpenter_tpu.solver import batch_solve as jax_batch
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu.solver.adapter import build_packables as jax_build_packables
from karpenter_tpu.solver.adapter import pod_vectors as jax_pod_vectors
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.cloudprovider.fake import provider as port_fake
from karpenter_tpu_torch.models import ffd as port_ffd
from karpenter_tpu_torch.ops import encode as enc_mod
from karpenter_tpu_torch.parallel import mesh as port_mesh
from karpenter_tpu_torch.parallel import type_sharded
from karpenter_tpu_torch.solver import batch_solve
from karpenter_tpu_torch.solver import host_ffd
from karpenter_tpu_torch.solver import pipeline
from karpenter_tpu_torch.solver import solve as solve_mod
from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
from tests.test_torch_solve import canonical

ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]


def problem(pkg, n_pods=120, n_types=16, descending_prices=False, offset=0):
    """The JAX suite's routed-solve problem in ``pkg``: (constraints, pods,
    catalog); descending prices invert the default first-tie order."""
    core, fake = (jax_core, jax_fake) if pkg == "jax" else (port_core, port_fake)
    universe = jax_universe if pkg == "jax" else solve_mod.universe_constraints
    catalog = fake.instance_types(n_types)
    if descending_prices:
        for i, it in enumerate(catalog):
            it.price = 0.1 * (len(catalog) - i)
    pods = [core.Pod(spec=core.PodSpec(containers=[core.Container(
        resources=core.ResourceRequirements.make(requests={
            "cpu": f"{100 + 37 * ((i + offset) % 9)}m",
            "memory": f"{64 * (1 + (i + offset) % 5)}Mi"}))]))
        for i in range(n_pods)]
    return universe(catalog), pods, catalog


def jax_config(**cfg):
    """The JAX package's device path at any size, inline, unhedged."""
    return jax_solve_mod.SolverConfig(device_min_pods=1, device_timeout_s=0,
                                      device_hedge=False, **cfg)


def port_config(**cfg):
    return solve_mod.SolverConfig(**{"device_min_pods": 0, **cfg})


def cpu_mesh(n):
    return ["cpu"] * n


def host_key(r):
    return (r.node_count, sorted(r.unschedulable),
            sorted((tuple(p.instance_type_indices), p.node_quantity) for p in r.packings))


@pytest.fixture(autouse=True)
def fresh_state():
    enc_mod.reset_marshal_arena()
    pipeline.reset_ring()
    solve_mod.reset_executor_counts()
    type_sharded.DECISIONS = type_sharded.DONE_READS = 0
    yield
    enc_mod.reset_marshal_arena()
    pipeline.reset_ring()


def executors():
    return solve_mod.solver_health()["executor_counts"]


# -- TestTypeSpmdSolvePath's counterparts ----------------------------------------

@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("chunk_iters", [64, 2])
def test_solve_ffd_device_over_a_mesh_matches_jax_and_host(n, chunk_iters):
    """solve_ffd_device over a mesh of n against the JAX package's
    kernel="type-spmd" and host_ffd.pack; chunk_iters=2 resumes many times."""
    n_pods = 120 if chunk_iters == 64 else 90
    jc, jpods, jcat = problem("jax", n_pods)
    pc, ppods, pcat = problem("port", n_pods)
    jpack, _ = jax_build_packables(jcat, jc, jpods, [])
    ppack, _ = build_packables(pcat, pc, ppods, [])
    ids = list(range(n_pods))
    want = jax_solve_ffd_device(jax_pod_vectors(jpods), ids, jpack, kernel="type-spmd",
                                chunk_iters=chunk_iters, hedge=False)
    vecs = pod_vectors(ppods)
    got = port_ffd.solve_ffd_device(vecs, ids, ppack, device="cpu", chunk_iters=chunk_iters,
                                    mesh=port_mesh.solver_mesh(cpu_mesh(n)))
    assert host_key(got) == host_key(want) == host_key(host_ffd.pack(vecs, ids, ppack))
    assert type_sharded.DECISIONS > 0


@pytest.mark.parametrize("n", [1, 4, 8])
def test_public_solve_with_device_kernel_type_spmd_matches_jax(n):
    jc, jpods, jcat = problem("jax")
    pc, ppods, pcat = problem("port")
    want = jax_solve_mod.solve(jc, jpods, jcat, config=jax_config(device_kernel="type-spmd"))
    got = solve_mod.solve(pc, ppods, pcat, config=port_config(device_kernel="type-spmd"),
                          device=cpu_mesh(n))
    assert canonical(got, ppods) == canonical(want, jpods)
    assert not got.unschedulable
    assert executors() == {"device-type-spmd": 1}
    assert type_sharded.DECISIONS > 0
    # the pack kernel over the same mesh gives the same node set
    default = solve_mod.solve(pc, ppods, pcat, config=port_config(), device=cpu_mesh(n))
    assert canonical(default, ppods) == canonical(got, ppods)
    assert executors() == {"device-type-spmd": 1, "device": 1}


def test_cost_tiebreak_in_the_route_matches_jax():
    """Descending prices: the tie-break changes the packing, and the route
    over a mesh of 4 gives the JAX package's type-spmd answer."""
    jc, jpods, jcat = problem("jax", descending_prices=True)
    pc, ppods, pcat = problem("port", descending_prices=True)
    want = jax_solve_mod.solve(jc, jpods, jcat, config=jax_config(
        device_kernel="type-spmd", cost_tiebreak=True))
    plain = solve_mod.solve(pc, ppods, pcat, config=port_config(), device="cpu")
    got = solve_mod.solve(pc, ppods, pcat, config=port_config(
        device_kernel="type-spmd", cost_tiebreak=True), device=cpu_mesh(4))
    assert canonical(got, ppods) != canonical(plain, ppods), (
        "precondition: the tie-break must change this packing")
    assert canonical(got, ppods) == canonical(want, jpods)
    assert executors() == {"device": 1, "device-type-spmd": 1}


# -- where the route runs ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16])
def test_the_route_runs_where_the_mesh_divides_the_bucket(n):
    """device_kernel="type-spmd" over a mesh of n: the route where n divides
    the 16-type bucket, else the pack kernel on the mesh's first device
    (the JAX package's fall-back to its scan), bit for bit either way."""
    pc, ppods, pcat = problem("port")
    got = solve_mod.solve(pc, ppods, pcat, config=port_config(device_kernel="type-spmd"),
                          device=cpu_mesh(n))
    routed = 16 % n == 0
    assert executors() == ({"device-type-spmd": 1} if routed else {"device": 1})
    assert (type_sharded.DECISIONS > 0) == routed
    want = solve_mod.solve(pc, ppods, pcat, config=port_config(), device="cpu")
    assert canonical(got, ppods) == canonical(want, ppods)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_nothing_routes_without_the_kernel_named(n):
    """No automatic gate: with device_kernel None a mesh of n that divides
    the bucket still runs the pack kernel, where the JAX package's gate at a
    threshold of 0 would route (an intended difference)."""
    assert not hasattr(solve_mod.SolverConfig(), "type_spmd_min_types")
    assert jax_solve_mod._maybe_type_spmd(jax_solve_mod.SolverConfig(type_spmd_min_types=0),
                                          SimpleNamespace(num_types=16)) == "type-spmd"
    pc, ppods, pcat = problem("port")
    solve_mod.solve(pc, ppods, pcat, config=port_config(), device=cpu_mesh(n))
    assert executors() == {"device": 1}
    assert type_sharded.DECISIONS == 0


def test_a_mesh_of_three_takes_the_pack_kernel_at_the_2048_bucket():
    """2,000 types (the 2,048 bucket, config_8's width) over a mesh of 3:
    device_kernel="type-spmd" runs the pack kernel on the mesh's first
    device, as solve_ffd_device's route by shape decides."""
    pc, ppods, pcat = problem("port", n_pods=40, n_types=2000)
    packables, _ = build_packables(pcat, pc, ppods, [])
    vecs, ids = pod_vectors(ppods), list(range(len(ppods)))
    enc = enc_mod.encode(vecs, ids, packables, pad=False)
    assert enc_mod.bucket(enc.num_types, enc_mod.TYPE_BUCKETS) == 2048
    assert not port_ffd.routes_type_spmd(enc_mod.pad_encoding(enc),
                                         port_mesh.solver_mesh(cpu_mesh(3)))
    got = solve_mod.solve(pc, ppods, pcat, config=port_config(device_kernel="type-spmd"),
                          device=cpu_mesh(3))
    assert executors() == {"device": 1}
    assert type_sharded.DECISIONS == 0
    want = solve_mod.solve(pc, ppods, pcat, config=port_config(), device="cpu")
    assert canonical(got, ppods) == canonical(want, ppods)
    assert got.node_count == host_ffd.pack(vecs, ids, packables).node_count


# -- kernel names and the batched window -------------------------------------------

def window(pkg, n_problems=3, per=40):
    """``n_problems`` schedules over one 12-type catalog, one zone each."""
    core = jax_core if pkg == "jax" else port_core
    universe = jax_universe if pkg == "jax" else solve_mod.universe_constraints
    Problem = jax_batch.Problem if pkg == "jax" else batch_solve.Problem
    cat = (jax_fake if pkg == "jax" else port_fake).instance_types(12)
    base = universe(cat)
    probs = []
    for b in range(n_problems):
        req = core.NodeSelectorRequirement(key="topology.kubernetes.io/zone", operator="In",
                                           values=[ZONES[b % 3]])
        if pkg == "jax":
            cons = base.deepcopy()
            cons.requirements = cons.requirements.add(req)
        else:
            cons = type(base)(requirements=base.requirements.add(req))
        _, pods, _ = problem(pkg, n_pods=per + 5 * b, offset=b)
        probs.append(Problem(constraints=cons, pods=pods, instance_types=cat))
    return probs


def window_key(results, probs):
    return [canonical(r, p.pods) for r, p in zip(results, probs)]


def test_a_batched_window_demotes_type_spmd_with_a_log_line(caplog):
    jprobs, pprobs = window("jax"), window("port")
    with caplog.at_level(logging.INFO, logger="karpenter.solver.batch"):
        got = batch_solve.solve_batch(pprobs, port_config(device_kernel="type-spmd"),
                                      device=cpu_mesh(4))
    lines = [r for r in caplog.records if r.name == "karpenter.solver.batch"]
    assert any(r.levelno == logging.INFO and "type-spmd" in r.getMessage()
               and "solo" in r.getMessage() for r in lines)
    assert executors() == {"device-batch": 3}
    assert type_sharded.DECISIONS == 0
    want = jax_batch.solve_batch(jprobs, jax_config(device_kernel="type-spmd"))
    assert window_key(got, pprobs) == window_key(want, jprobs)
    default = batch_solve.solve_batch(pprobs, port_config(), device=cpu_mesh(4))
    assert window_key(default, pprobs) == window_key(got, pprobs)


@pytest.mark.parametrize("name", ["xla", "pallas", "type_spmd"])
def test_an_unknown_kernel_raises_on_both_paths(name):
    pc, ppods, pcat = problem("port", n_pods=20)
    # under the device gate too: the name is checked before any route
    for cfg in (port_config(device_kernel=name),
                solve_mod.SolverConfig(device_kernel=name)):
        with pytest.raises(ValueError, match="type-spmd"):
            solve_mod.solve(pc, ppods, pcat, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="type-spmd"):
        batch_solve.solve_batch(window("port"), port_config(device_kernel=name),
                                device="cpu")
    with pytest.raises(ValueError, match="type-spmd"):
        batch_solve.dispatch_batch(window("port"), port_config(device_kernel=name),
                                   device=cpu_mesh(2))
    assert executors() == {}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_a_windows_lone_problem_takes_the_named_kernel(n):
    """A window of one problem is solved alone with the window's config and
    mesh: device_kernel="type-spmd" routes it over a mesh of n where n
    divides its 16-type bucket, as the JAX package routes it over its eight
    devices, and bit for bit either way."""
    jc, jpods, jcat = problem("jax")
    pc, ppods, pcat = problem("port")
    jprobs = [jax_batch.Problem(constraints=jc, pods=jpods, instance_types=jcat)]
    pprobs = [batch_solve.Problem(constraints=pc, pods=ppods, instance_types=pcat)]
    got = batch_solve.solve_batch(pprobs, port_config(device_kernel="type-spmd"),
                                  device=cpu_mesh(n))
    routed = 16 % n == 0
    assert executors() == ({"device-type-spmd": 1} if routed else {"device": 1})
    assert (type_sharded.DECISIONS > 0) == routed
    want = jax_batch.solve_batch(jprobs, jax_config(device_kernel="type-spmd"))
    assert window_key(got, pprobs) == window_key(want, jprobs)
    default = batch_solve.solve_batch(pprobs, port_config(), device=cpu_mesh(n))
    assert window_key(default, pprobs) == window_key(got, pprobs)


def test_solve_on_cpu_is_a_one_device_mesh():
    """``device="cpu"`` is a one-device mesh: the default kernel runs the pack
    kernel, the explicit kernel runs the route over that one device, and a
    mesh of two runs it over two, all bit for bit."""
    assert port_mesh.resolve_mesh("cpu") == (torch.device("cpu"),)
    pc, ppods, pcat = problem("port")
    base = solve_mod.solve(pc, ppods, pcat, config=port_config(), device="cpu")
    assert executors() == {"device": 1} and type_sharded.DECISIONS == 0
    cfg = port_config(device_kernel="type-spmd")
    one = solve_mod.solve(pc, ppods, pcat, config=cfg, device="cpu")
    two = solve_mod.solve(pc, ppods, pcat, config=cfg, device=cpu_mesh(2))
    assert executors() == {"device": 1, "device-type-spmd": 2}
    assert canonical(one, ppods) == canonical(two, ppods) == canonical(base, ppods)
