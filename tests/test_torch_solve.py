"""The port's public solve() against the JAX package's, node for node.

Pods and catalogs are built separately in each package from the same
seeded numbers; both solve, and the node count, every packing's option
names and pod lists, and the unschedulable list must be equal. Exact: the
work is all integer. The port runs on the CPU here (``device="cpu"``), with
the plain versions of its kernels.
"""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.api import core as jax_core
from karpenter_tpu.cloudprovider import spi as jax_spi
from karpenter_tpu.cloudprovider.fake.provider import make_instance_type as jax_make_it
from karpenter_tpu.controllers.provisioning import universe_constraints as jax_universe
from karpenter_tpu.models.ffd import solve_ffd_device as jax_solve_ffd_device
from karpenter_tpu.ops.encode import encode as jax_encode
from karpenter_tpu.solver import solve as jax_solve_mod
from karpenter_tpu.solver.adapter import build_packables as jax_build_packables
from karpenter_tpu.solver.adapter import pod_vector as jax_pod_vector
from karpenter_tpu_torch.api import core as port_core
from karpenter_tpu_torch.cloudprovider import spi as port_spi
from karpenter_tpu_torch.models.ffd import solve_ffd_device, solve_ffd_numpy
from karpenter_tpu_torch.ops.encode import encoding_from_arrays
from karpenter_tpu_torch.solver import solve as port_solve_mod
from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors

SEEDS = (1, 7, 42)


def catalog_spec(seed, n_types):
    rng = random.Random(seed)
    cpus = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96]
    spec = []
    for i in range(n_types):
        cpu = rng.choice(cpus)
        ratio = rng.choice([2, 4, 8])
        zones = rng.sample(["z-1", "z-2", "z-3"], rng.randint(1, 3))
        spec.append(dict(name=f"t-{cpu}x{ratio}-{i}", cpu=str(cpu),
                         memory=f"{cpu * ratio}Gi", pods=str(min(110, cpu * 15)),
                         price=round(0.05 * cpu * (1 + 0.1 * rng.randint(0, 3)), 4),
                         offerings=[(ct, z) for z in zones
                                    for ct in ("on-demand", "spot")]))
    return spec


def pod_spec(seed, n_pods, n_shapes, too_big=0):
    rng = random.Random(seed + 1000)
    shapes = sorted({(rng.randint(50, 4000), rng.randint(64, 8192))
                     for _ in range(n_shapes)})
    reqs = [shapes[rng.randrange(len(shapes))] for _ in range(n_pods)]
    reqs += [(200_000, 1024)] * too_big  # 200 cpus: fits no type
    rng.shuffle(reqs)
    return reqs


def build(pkg, seed, n_pods, n_types, n_shapes, too_big=0):
    core, spi = (jax_core, jax_spi) if pkg == "jax" else (port_core, port_spi)
    make_it = jax_make_it if pkg == "jax" else port_spi.make_instance_type
    universe = (jax_universe if pkg == "jax"
                else port_solve_mod.universe_constraints)
    catalog = [make_it(name=s["name"], cpu=s["cpu"], memory=s["memory"],
                       pods=s["pods"], price=s["price"],
                       offerings=[spi.Offering(ct, z) for ct, z in s["offerings"]])
               for s in catalog_spec(seed, n_types)]
    pods = [core.Pod(spec=core.PodSpec(containers=[core.Container(
        resources=core.ResourceRequirements.make(
            requests={"cpu": f"{c}m", "memory": f"{m}Mi"}))]))
        for c, m in pod_spec(seed, n_pods, n_shapes, too_big)]
    return universe(catalog), pods, catalog


def canonical(result, pods):
    index = {id(p): i for i, p in enumerate(pods)}
    packings = [(tuple(it.name for it in p.instance_type_options),
                 p.node_quantity,
                 [[index[id(x)] for x in node] for node in p.pods])
                for p in result.packings]
    return result.node_count, packings, [index[id(p)] for p in result.unschedulable]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("too_big,cost", [(0, False), (25, False), (25, True)])
def test_solve_matches_jax_package(seed, too_big, cost):
    args = (seed, 2000, 40, 60, too_big)
    jc, jpods, jcat = build("jax", *args)
    pc, ppods, pcat = build("port", *args)
    want = jax_solve_mod.solve(jc, jpods, jcat, config=jax_solve_mod.SolverConfig(
        cost_tiebreak=cost, device_timeout_s=0))
    got = port_solve_mod.solve(pc, ppods, pcat, device="cpu",
                               config=port_solve_mod.SolverConfig(cost_tiebreak=cost))
    assert port_solve_mod.solver_health()["last_executor"] == "device"
    assert canonical(got, ppods) == canonical(want, jpods)
    assert len(got.unschedulable) == too_big


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_ffd_device_matches_jax_through_the_same_encoding(seed):
    """Both packages' solve_ffd_device on ONE encoding (the JAX package's,
    carried across by encoding_from_arrays), with short chunks so the loop
    resumes and compacts."""
    jc, jpods, jcat = build("jax", seed, 1500, 24, 400, too_big=3)
    packables, _ = jax_build_packables(jcat, jc, jpods, [])
    vecs = [jax_pod_vector(p) for p in jpods]
    ids = list(range(len(jpods)))
    jenc = jax_encode(vecs, ids, packables, pad=False)
    want = jax_solve_ffd_device(vecs, ids, packables, kernel="xla",
                                chunk_iters=8, enc=jenc, hedge=False)
    enc = encoding_from_arrays(
        jenc.shapes, jenc.counts, jenc.totals, jenc.reserved0, jenc.valid,
        jenc.last_valid, jenc.pods_unit, jenc.shape_pods, jenc.num_shapes,
        jenc.num_types, jenc.scales)
    got = solve_ffd_device(vecs, ids, packables, chunk_iters=8, enc=enc,
                           device="cpu")
    key = lambda r: (r.node_count, sorted(r.unschedulable),  # noqa: E731
                     [(tuple(p.instance_type_indices), p.node_quantity, p.pod_ids)
                      for p in r.packings])
    assert key(got) == key(want)
    assert len(got.unschedulable) == 3


@pytest.mark.parametrize("seed", SEEDS)
def test_device_path_matches_numpy_mirror(seed):
    pc, ppods, pcat = build("port", seed, 1200, 30, 200, too_big=2)
    packables, _ = build_packables(pcat, pc, ppods, [])
    vecs, ids = pod_vectors(ppods), list(range(len(ppods)))
    dev = solve_ffd_device(vecs, ids, packables, chunk_iters=16, device="cpu")
    ref = solve_ffd_numpy(vecs, ids, packables)
    assert dev.node_count == ref.node_count
    assert sorted(dev.unschedulable) == sorted(ref.unschedulable)


def test_unencodable_problem_goes_to_host_oracle():
    """A quantity that cannot be scaled into int32 exactly sends the solve
    to host_ffd.pack, counted as the "host" executor, with the JAX
    package's answer."""
    results = []
    for pkg, core in (("jax", jax_core), ("port", port_core)):
        c, pods, cat = build(pkg, 3, 40, 6, 8)
        pods.append(core.Pod(spec=core.PodSpec(containers=[core.Container(
            resources=core.ResourceRequirements.make(
                requests={"cpu": "1n", "memory": "64Mi"}))])))
        results.append((c, pods, cat))
    (jc, jpods, jcat), (pc, ppods, pcat) = results
    want = jax_solve_mod.solve(jc, jpods, jcat, config=jax_solve_mod.SolverConfig(
        device_timeout_s=0))
    got = port_solve_mod.solve(pc, ppods, pcat, device="cpu")
    assert port_solve_mod.solver_health()["last_executor"] == "host"
    assert canonical(got, ppods)[0] == canonical(want, jpods)[0]
    assert canonical(got, ppods)[2] == canonical(want, jpods)[2]


def test_chunk_loop_that_does_not_finish_raises(monkeypatch):
    """A device solve cut off by MAX_CHUNKS raises out of solve(); it is
    not handed to the host oracle."""
    from karpenter_tpu_torch.models import ffd as port_ffd

    monkeypatch.setattr(port_ffd, "MAX_CHUNKS", 2)
    pc, ppods, pcat = build("port", 5, 200, 8, 40)
    port_solve_mod.reset_executor_counts()
    with pytest.raises(RuntimeError, match="did not converge in 2 chunks"):
        port_solve_mod.solve(pc, ppods, pcat, device="cpu",
                             config=port_solve_mod.SolverConfig(chunk_iters=1,
                                                                device_min_pods=0))
    assert port_solve_mod.solver_health()["executor_counts"] == {}
    # the same problem with room to finish is answered by the device
    got = port_solve_mod.solve(pc, ppods, pcat, device="cpu",
                               config=port_solve_mod.SolverConfig(chunk_iters=64,
                                                                  device_min_pods=0))
    assert port_solve_mod.solver_health()["executor_counts"] == {"device": 1}
    assert got.node_count > 2


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc, ppods, pcat = build("port", 1, 20, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_solve_mod.solve(pc, ppods, pcat)
    packables, _ = build_packables(pcat, pc, ppods, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_ffd_device(pod_vectors(ppods), list(range(20)), packables)


def test_no_viable_types_reports_every_pod_unschedulable():
    pc, ppods, pcat = build("port", 2, 10, 4, 4)
    got = port_solve_mod.solve(port_solve_mod.Constraints(), ppods, pcat,
                               device="cpu")
    assert got.node_count == 0 and len(got.unschedulable) == 10
    assert np.all([a is b for a, b in zip(got.unschedulable, ppods)])
