#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build the kernel, hold it against
its plain version, and drive the public solve() at full size on one card.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one, printing no result) and
nvcc (the pack kernel is built from karpenter_tpu_torch/csrc/pack.cu at
first use). Phases, each printing one JSON record:

1. the card (nvidia-smi name and power limit) and the kernel build;
2. kernel vs plain: a seeded fuzz over shape buckets 32/512/8192, type
   buckets 8/512/4096, cost tie-break off and on, drops, and chunk resume
   at num_iters=2; the CUDA flat buffer must equal the plain version's bit
   for bit;
3. the main path at full size (config_4): solve() on 50k pods × 400
   instance types; node count equal to solve_ffd_numpy's (774), zero
   unschedulable, every solve answered by the "device" executor, the
   kernel launched; p50/p99 of solve() over warm runs, the kernel's time
   from CUDA events, the plain version's time;
4. high cardinality: 50k pods with 8000 distinct shapes (the 8192 bucket
   and compaction); the first chunk equals the plain version's, every pod
   appears exactly once, and the node count equals solve_ffd_numpy's when
   that finishes in time (it runs in a child process from the end of
   phase 3 on);
5. the kernels line, the card line, and the final ok line.

Any failed check exits non-zero.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

SEED = 11
HIGHCARD_PODS, HIGHCARD_SHAPES = 50_000, 8_000
ORACLE_DEADLINE_S = 780.0      # from script start; the run's limit is 1200 s
WARM_RUNS = 25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM INT32 issue rate: 64 INT32 lanes per SM per clock (NVIDIA
# Hopper architecture whitepaper, SM throughput table) x 132 SMs x the
# 1.98 GHz maximum boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit operations of one (type, shape) greedy step, as transcribed in
# karpenter_tpu_torch/csrc/pack.cu greedy_step: per resource a subtract,
# a division, a compare and a min (kfit), a multiply-add (reserve), an add,
# two compares and an or (full); then clamp, failure test, npacked add and
# the stop test. A division counts as one operation though it compiles to
# several instructions, so the bound is a lower bound.
OPS_PER_TYPE_STEP = 8 * 9 + 6

MIXED_SHAPES = [
    (c, m)
    for c in (100, 250, 500, 750, 1000, 1500, 2000, 4000)
    for m in (128, 512, 1024, 4096)
]


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# -- workload generators (bench.py:121-164 and :724-735) ---------------------

def make_catalog(n_types, zones=3, price_base=0.05):
    from karpenter_tpu_torch.cloudprovider.spi import Offering, make_instance_type

    catalog = []
    cpus = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96]
    ratios = [2, 4, 8]
    i = 0
    while len(catalog) < n_types:
        cpu = cpus[i % len(cpus)]
        ratio = ratios[(i // len(cpus)) % len(ratios)]
        offerings = [Offering(ct, f"bench-zone-{z + 1}")
                     for z in range(zones) for ct in ("on-demand", "spot")]
        catalog.append(make_instance_type(
            name=f"syn-{cpu}x{ratio}-{i}",
            cpu=str(cpu), memory=f"{cpu * ratio}Gi",
            pods=str(min(110, cpu * 15)),
            offerings=offerings,
            price=price_base * cpu * (1 + 0.1 * (ratio // 4)),
        ))
        i += 1
    return catalog


def _pod(c, m):
    from karpenter_tpu_torch.api.core import Container, Pod, PodSpec, ResourceRequirements

    return Pod(spec=PodSpec(containers=[Container(resources=ResourceRequirements.make(
        requests={"cpu": f"{c}m", "memory": f"{m}Mi"}))]))


def make_pods(n, shapes):
    return [_pod(*shapes[i % len(shapes)]) for i in range(n)]


def highcard_pods(n, distinct, seed):
    rng = random.Random(seed)
    shapes = set()
    while len(shapes) < distinct:
        shapes.add((rng.randint(50, 4000), rng.randint(64, 4096)))
    return make_pods(n, sorted(shapes))


# -- timing and bounds -------------------------------------------------------

def cuda_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(args, L, cost, type_steps):
    """Least time for one chunk: the larger of its bytes (inputs read once,
    the flat buffer written once) over HBM bandwidth and its integer
    operations (the type-steps this input needs) over the op rate."""
    from karpenter_tpu_torch.ops.pack import flat_size

    shapes, counts, dropped, totals, reserved0, valid = args[:6]
    S, T = shapes.shape[0], totals.shape[0]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (shapes, counts, dropped, totals, reserved0, valid))
    nbytes += S * 4 + (T * 4 if cost else 0) + flat_size(S, L) * 4  # maxfit, prices, out
    ops = OPS_PER_TYPE_STEP * type_steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# -- phase 2: kernel vs plain fuzz ------------------------------------------

def fuzz_problem(rng, S, T, drops, device):
    """A random problem in the kernel ABI: live shapes descending, placed at
    sorted random rows of the bucket (count-0 rows between them),
    0 <= reserved0 <= totals, a prefix of valid types."""
    import numpy as np
    import torch

    R = 8
    n_live = int(rng.integers(1, min(S, 300) + 1))
    n_types = int(rng.integers(max(1, T // 2), T + 1))
    pods_unit = int(rng.integers(1, 3))
    live = np.zeros((n_live, R), np.int64)
    live[:, 0] = rng.integers(1, 24, n_live)
    live[:, 1] = rng.integers(1, 40, n_live)
    live[:, 2] = pods_unit
    live[:, 3] = rng.integers(0, 2, n_live) * (rng.random(n_live) < 0.15)
    if drops:
        live[0, 0] = 10_000
    live = live[np.lexsort(live.T[::-1])[::-1]]
    rows = np.sort(rng.choice(S, n_live, replace=False))
    shapes = np.zeros((S, R), np.int32)
    shapes[rows] = live
    counts = np.zeros(S, np.int32)
    counts[rows] = rng.integers(1, 40, n_live)
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
    prices = np.full(T, 2**31 - 1, np.int32)
    prices[:n_types] = rng.integers(1, 6, n_types) * 1000
    t = lambda a, dt: torch.as_tensor(a, dtype=dt).to(device)  # noqa: E731
    args = (t(shapes, torch.int32), t(counts, torch.int32),
            torch.zeros(S, dtype=torch.int32, device=device),
            t(totals, torch.int32), t(reserved0, torch.int32), t(valid, torch.bool),
            n_types - 1, pods_unit)
    return args, t(prices, torch.int32)


def compare(args, L, prices, cost, maxfit):
    """One kernel launch and one plain run on the same inputs: returns
    (equal, max_abs_err, kernel flat, plain stats with the plain run's
    milliseconds under "ms")."""
    import torch

    from karpenter_tpu_torch.ops.pack_cuda import pack_chunk, pack_chunk_plain

    stats = {}
    got = pack_chunk(*args, num_iters=L, prices=prices, cost_tiebreak=cost, maxfit=maxfit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pack_chunk_plain(*args, num_iters=L, prices=prices, cost_tiebreak=cost,
                            maxfit=maxfit, stats=stats)
    torch.cuda.synchronize()
    stats["ms"] = (time.perf_counter() - t0) * 1000.0
    err = int((got.long() - want.long()).abs().max())
    return torch.equal(got, want), err, got, stats


def phase_fuzz(device):
    import numpy as np

    from karpenter_tpu_torch.ops.pack import compute_maxfit

    rng = np.random.default_rng(SEED)
    cases, worst, t0 = 0, 0, time.perf_counter()
    for S in (32, 512, 8192):
        for T in (8, 512, 4096):
            for cost in (False, True):
                drops = bool(rng.random() < 0.5)
                args, prices = fuzz_problem(rng, S, T, drops, device)
                maxfit = compute_maxfit(args[0], args[3], args[4], args[5])
                ok, err, _, _ = compare(args, 64, prices, cost, maxfit)
                worst = max(worst, err)
                cases += 1
                check(ok, f"kernel != plain at S={S} T={T} cost={cost} drops={drops}")
        # chunk resume: num_iters=2, carrying counts/dropped three chunks on
        args, prices = fuzz_problem(rng, S, 512, True, device)
        maxfit = compute_maxfit(args[0], args[3], args[4], args[5])
        for _ in range(3):
            ok, err, got, _ = compare(args, 2, prices, True, maxfit)
            worst = max(worst, err)
            cases += 1
            check(ok, f"kernel != plain on chunk resume at S={S}")
            counts, dropped, done = got[:S], got[S:2 * S], bool(got[2 * S])
            if done:
                break
            args = (args[0], counts.clone(), dropped.clone(), *args[3:])
    emit({"phase": "fuzz", "cases": cases, "bit_identical": True,
          "max_abs_err": worst, "seconds": time.perf_counter() - t0})
    return worst


# -- phase 3/4: the main path -----------------------------------------------

def chunk_inputs(pods, catalog, constraints, device):
    """The first chunk's kernel arguments, exactly as solve() builds them."""
    from karpenter_tpu_torch.models.ffd import device_args
    from karpenter_tpu_torch.ops.encode import encode, pad_encoding
    from karpenter_tpu_torch.ops.pack import compute_maxfit
    from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors

    packables, _ = build_packables(catalog, constraints, pods, [])
    vecs, ids = pod_vectors(pods), list(range(len(pods)))
    enc = pad_encoding(encode(vecs, ids, packables, pad=False))
    args = device_args(enc, device)
    maxfit = compute_maxfit(args[0], args[3], args[4], args[5])
    return args, maxfit, packables, vecs, ids


def time_kernel(args, maxfit, L):
    from karpenter_tpu_torch.ops.pack_cuda import pack_chunk

    ok, err, _, stats = compare(args, L, None, False, maxfit)
    check(ok, "first chunk: kernel != plain")
    ms = cuda_ms(lambda: pack_chunk(*args, num_iters=L, maxfit=maxfit), 20)
    return {"ms": ms, "plain_ms": stats["ms"], "max_abs_err": err,
            "shape_steps": stats["shape_steps"], "type_steps": stats["type_steps"],
            **bound(args, L, False, stats["type_steps"])}


def phase_config4(device):
    import torch

    from karpenter_tpu_torch.models.ffd import solve_ffd_numpy
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.solver.solve import (
        reset_executor_counts, solve, solver_health, universe_constraints,
    )

    catalog = make_catalog(400)
    pods = make_pods(50_000, MIXED_SHAPES)
    constraints = universe_constraints(catalog)

    pack_cuda.LAUNCHES = 0
    reset_executor_counts()
    result = solve(constraints, pods, catalog, device=device)  # the main path
    torch.cuda.synchronize()
    launches = pack_cuda.LAUNCHES
    check(launches > 0, "config_4: the pack kernel was never launched")
    check(solver_health()["executor_counts"] == {"device": 1},
          f"config_4 answered by {solver_health()['executor_counts']}")

    args, maxfit, packables, vecs, ids = chunk_inputs(pods, catalog, constraints, device)
    ref = solve_ffd_numpy(vecs, ids, packables)
    check(result.node_count == ref.node_count == 774,
          f"config_4 nodes {result.node_count}, numpy {ref.node_count}, expected 774")
    check(not result.unschedulable, "config_4 left pods unschedulable")

    reset_executor_counts()
    times = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        r = solve(constraints, pods, catalog, device=device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
        check(r.node_count == 774, "warm config_4 solve changed its node count")
    check(solver_health()["executor_counts"] == {"device": WARM_RUNS},
          f"warm solves answered by {solver_health()['executor_counts']}")
    times.sort()
    kern = time_kernel(args, maxfit, 64)
    rec = {"phase": "config_4", "pods": len(pods), "types": len(catalog),
           "shape_bucket": int(args[0].shape[0]), "type_bucket": int(args[3].shape[0]),
           "node_count": result.node_count, "numpy_node_count": ref.node_count,
           "unschedulable": 0, "executor": "device", "launches_per_solve": launches,
           "warm_runs": len(times), "p50_ms": times[len(times) // 2],
           "p99_ms": times[min(len(times) - 1, int(0.99 * len(times)))],
           "kernel": kern}
    emit(rec)
    return rec


def oracle_main() -> int:
    """Child-process mode: solve_ffd_numpy's node count for phase 4."""
    from karpenter_tpu_torch.models.ffd import solve_ffd_numpy
    from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
    from karpenter_tpu_torch.solver.solve import universe_constraints

    catalog = make_catalog(400)
    pods = highcard_pods(HIGHCARD_PODS, HIGHCARD_SHAPES, SEED)
    packables, _ = build_packables(catalog, universe_constraints(catalog), pods, [])
    r = solve_ffd_numpy(pod_vectors(pods), list(range(len(pods))), packables)
    print(json.dumps({"node_count": r.node_count,
                      "unschedulable": len(r.unschedulable)}), flush=True)
    return 0


def phase_highcard(device, oracle, t_start):
    import torch

    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.solver.solve import (
        reset_executor_counts, solve, solver_health, universe_constraints,
    )

    catalog = make_catalog(400)
    pods = highcard_pods(HIGHCARD_PODS, HIGHCARD_SHAPES, SEED)
    constraints = universe_constraints(catalog)
    pack_cuda.LAUNCHES = 0
    reset_executor_counts()
    t0 = time.perf_counter()
    result = solve(constraints, pods, catalog, device=device)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1000.0
    launches = pack_cuda.LAUNCHES
    check(launches > 0, "high-cardinality: the pack kernel was never launched")
    check(solver_health()["executor_counts"] == {"device": 1},
          f"high-cardinality answered by {solver_health()['executor_counts']}")
    seen = [id(p) for pk in result.packings for node in pk.pods for p in node]
    seen += [id(p) for p in result.unschedulable]
    check(len(seen) == len(pods) and set(seen) == {id(p) for p in pods},
          "high-cardinality: a pod is missing or placed twice")

    args, maxfit, *_ = chunk_inputs(pods, catalog, constraints, device)
    check(int(args[0].shape[0]) == 8192, "high-cardinality did not reach the 8192 bucket")
    kern = time_kernel(args, maxfit, 64)

    remaining = ORACLE_DEADLINE_S - (time.perf_counter() - t_start)
    oracle_nodes = None
    try:
        out, _ = oracle.communicate(timeout=max(1.0, remaining))
        check(oracle.returncode == 0, f"numpy oracle failed ({oracle.returncode})")
        oracle_nodes = json.loads(out.strip().splitlines()[-1])["node_count"]
    except subprocess.TimeoutExpired:
        oracle.kill()
        oracle.communicate()
    if oracle_nodes is None:
        oracle_check = "skipped: solve_ffd_numpy did not finish within the run's time"
    else:
        check(result.node_count == oracle_nodes,
              f"high-cardinality nodes {result.node_count} != numpy {oracle_nodes}")
        oracle_check = "equal"
    rec = {"phase": "high_cardinality", "pods": len(pods),
           "distinct_shapes": HIGHCARD_SHAPES, "node_count": result.node_count,
           "unschedulable": len(result.unschedulable),
           "numpy_node_count": oracle_nodes, "numpy_check": oracle_check,
           "executor": "device", "launches_per_solve": launches,
           "solve_ms": solve_ms, "first_chunk_bit_identical": True, "kernel": kern}
    emit(rec)
    return rec


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from karpenter_tpu_torch.ops import pack_cuda

    device = torch.device("cuda")
    card = card_line()
    oracle = None
    try:
        emit({"phase": "card", "nvidia_smi": card,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        pack_cuda.build()
        pack_cuda._library()
        emit({"phase": "build", "seconds": pack_cuda.BUILD_SECONDS,
              "ptxas": [ln for ln in pack_cuda.BUILD_LOG.splitlines()
                        if "registers" in ln or "spill" in ln]})
        fuzz_err = phase_fuzz(device)
        c4 = phase_config4(device)
        # the numpy oracle of phase 4 runs on the host from here on, after
        # the timed config_4 solves, so that it does not contend with them
        oracle = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--oracle"],
            stdout=subprocess.PIPE, text=True)
        hc = phase_highcard(device, oracle, t_start)
    finally:
        if oracle is not None and oracle.poll() is None:
            oracle.kill()
            oracle.communicate()
    k4 = c4["kernel"]
    emit({"kernels": [{
        "name": "pack_chunk",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/pack.cu",
        "replaces": "karpenter_tpu/ops/pack_pallas.py:95",
        "launches": c4["launches_per_solve"],
        "max_abs_err": max(fuzz_err, k4["max_abs_err"], hc["kernel"]["max_abs_err"]),
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None,
    }]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(oracle_main() if sys.argv[1:] == ["--oracle"] else main())
