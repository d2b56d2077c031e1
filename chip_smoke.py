#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build the kernels, hold each against
its plain version, and drive the public solve(), the batched window, the
provisioning controller, the global window backend, node removal
(consolidation, termination, emptiness), pod-(anti-)affinity, the
packing policies, gangs, torus carving and preemption, the delta-marshal
window stream and the columnar controller at full size on one card, and
observe a window through the port's metrics, traces, SLO engine and flight
recorder; then the native host ring and its gate, the boot warm-up, the
controller process (main.build_manager under its Manager, and
``python -m karpenter_tpu_torch.main`` as a process of its own), the
Manager over HTTP against a stub API server through the API client, and
the admission webhook server.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one, printing no result) and
nvcc (the pack kernel is built from karpenter_tpu_torch/csrc/pack.cu and the
what-if kernel from karpenter_tpu_torch/csrc/whatif.cu at first use, one
nvcc each, both at once). Phases, each printing one JSON record:

1. the card (nvidia-smi name and power limit) and the kernels' builds,
   with ptxas's registers and spills and the cluster size and threads the
   pack kernel launches with at type buckets 8, 512 and 4096;
1b. whatif_fuzz: the what-if kernel against whatif_scan_plain bit for bit
   (feasible and every slot) over seeded windows from 4 x 4 x 4 to
   4 x 4 x 2**22 (NB x KB x BB), the staged kernel (BB <= 4096) and the
   global one, negative free values, own bins of -1, all-invalid rows,
   all-zero compat rows and a candidate that fails then places; then the
   staged design's edges (WHATIF_EDGE_FUZZ): BB at each geometry
   boundary, own bins on word edges, folded resources with negative free
   values, five to eight active resources, scattered valid flags, one
   long candidate, compat at an odd address and runs of replicas;
2. kernel vs plain: a seeded fuzz over shape buckets 32/512/8192, type
   buckets 8/512/4096, cost tie-break off and on, drops, chunk resume at
   num_iters=2, and the edges of the cluster design (fewer types than
   CTAs, half the types valid, ties across CTAs, numerators near
   INT32_MAX, counts past 2**18); each case is launched at every cluster
   size the kernel takes at its T, and every flat buffer must equal the
   plain version's bit for bit;
3. the main path at full size (config_4): solve() on 50k pods × 400
   instance types; node count equal to solve_ffd_numpy's (774), zero
   unschedulable, every solve answered by the "device" executor, the
   kernel launched; p50/p99 of solve() over warm runs, the kernel's time
   from CUDA events, the plain version's time, and the kernel's time at
   each cluster size;
4. high cardinality: 50k pods with 8000 distinct shapes (the 8192 bucket
   and compaction); 1070 nodes, the first chunk equals the plain
   version's, every pod appears exactly once; the same cluster-size table;
   one solve under torch.profiler for the kernel's device time and the
   device's idle share;
5. batch fuzz (before phase 3): the batched launch (a cluster per problem)
   against pack_batch_plain bit for bit at B = 1, 2, 5 and 24, S <= 512,
   random valid subsets, an all-zero row and a row with no valid type,
   cost tie-break off and on, at every cluster size; B = 1 also against
   pack_chunk;
6. mask: config_12's 192 constraint variants in 8 windows of 24 over 400
   types, the device mask against the scalar _validate type for type (0
   divergence), and the mask program's time per window;
7. window: config_12's window through solve_batch, 24 schedules over 400
   types, at 416 pods a schedule (9,984) and at 2,084 (50,016): every
   problem equal to solo solve() and to solve_ffd_numpy, every one by
   "device-batch", 0 mask mismatches, the launches per window, p50/p99
   over warm runs; the batched launch against its plain version, against
   the 24 solo launches on the same encodings, its bound, and its time at
   every cluster size;
8. mixed window: 23 of those schedules and one of 25,000 high-cardinality
   pods (the 8192 bucket, compaction across problems), every problem equal
   to solo solve(), the buckets walked and the launches;
8a. marshal_delta: config_10 at full size (20,000 pods over
   MIXED_SHAPES, make_catalog(100), 12 windows of 10 % object churn, seed
   42) through marshal_pods_interned, build_packables_versioned and
   encode, delta and cold: 12 of 12 encodings bit-identical, the last
   window's solve() equal delta and cold, a repeat solve() with 0 fresh
   ring allocations; delta and cold p50/p99, the bytes each window's
   solve() copies with and without the content tokens, and the ring's
   in-place refill (B13) timed by CUDA events against the host link;
8b. controller: pending pods created in the port's in-memory API server,
   enqueued by SelectionController.reconcile, batched, scheduled, solved,
   launched and bound by the ProvisioningController's worker thread
   (phase_controller has the five runs and their checks: config_12's
   window through the controller as deployed, with every default, in a
   process of its own, at pressure level 0 with the global leg run;
   config_12's window in one chunk, with the default pipeline, at 50,016
   pods, and config_14's window on the global backend with its kill
   switch), the kernel rebuilt and launched on the worker thread, one
   record a run;
8c. controller_columnar: config_12's 9,984-pod window through the
   controller in one chunk, twice on the columnar path (the default) and
   twice on the scalar path (compile_constraints patched to give None):
   the binds identical, no self-heal, 0 ring allocations in the steady
   window; reconcile_s and schedule_s both ways and the ring's counts;
8d. observability: that window with tracing and the SLO engine on (every
   pod bound once, the binds controller_columnar's, all five SLO stages
   stamped, no band burning, the window's spans under one provision span
   with marshal, dispatch, device_solve and launch_bind among them, every
   series in the exposition with its help, the ring's series equal to
   DeviceRing.counters()); the tracing and stamping tax by the JAX
   package's method (spans x ns a span, SLO record calls x ns a record,
   over the window's wall) beside tracing and stamps on and off
   alternated over 3 windows each (p50 walls, context only); one traced
   window and a one-schedule window under torch.profiler with the
   tracer's annotations on: the record_function range of every entered
   span and of the three karpenter.solve labels, with the host ms and
   the device ms launched inside each (a session is taken only when it
   saw every pack kernel launched); and the flight recorder's slo-burn
   and pressure-l3 dumps (phase_observability);
8e. journal: crash safety at full width (phase_journal): that window
   through the controller with the intent journal (fsync on, on the
   machine's disk: binds equal, the appends, bytes, µs an append and the
   journal's tax), a crash inside it at six fleet-launch and bind kill
   points (JOURNAL_CRASH_POINTS) with a restart (RecoveryController.run)
   and a re-drive (no leak, no ghost Node, every pod bound once, no open
   intent, the re-drive's pack launches equal to the plain version's),
   config_15's recovery wall (16 replays of 72 open intents), and the 50
   kill points on the crash-restart soak's scenario
   (karpenter_tpu_torch/chaos/soak.py);
9. global_program: the relaxation program of the global window backend
   (solver/global_solve.relax_node_counts) on the encoding of the
   9,984-pod window (B = 32, SB = 32, TB = 512) on the card and on the CPU:
   node counts within the stated tolerance, the supports equal row for row
   (flips counted and printed), with TF32 turned on for the card's run
   (the program uses no matmul, so it must not matter); the card's time
   from CUDA events, its kernel launches per call, device-busy time and
   idle share (torch.profiler), its bound, the CPU's time and the TF32
   flags;
10. global_window: config_14's window (12 schedules, 270 pods, 6 priced
   types) as the controller runs it, dispatch_batch beside
   dispatch_global_window, every accepted plan in place of its FFD result:
   each accepted plan passes verify_plan, holds each pod once and is
   strictly cheaper in int micro-$, each decline leaves its FFD result
   untouched, the verdicts equal the port's CPU run, the executor is
   "device-global"; fleet $/h and nodes of FFD and
   of the composed window, p50/p99 of solve_window_global; relax_pack
   (B8) on one schedule on the card and on the CPU, with its program's
   time, launches, device-busy time and bound;
11. global_window_400: the 9,984-pod window through the global backend
   once (a run is ~30 s of host rounding), the time split (encode,
   program on the card, host rounding, total) and the verdicts by reason;
12. whatif_window: config_5's 2,000-node consolidation window
   (bench.py:417-560) encoded and answered by one launch of the what-if
   kernel: equal to its plain version and to host_whatif, executor
   "device-whatif", every drain replayed on the surviving bins; the
   kernel's time (median of 25), the plain version's, the bound and the
   host seconds of encode_window, host_whatif and plan_window; config_5's
   repack_plan on 2,000 fragmented nodes equal to the host oracle;
13. deprovision: config_4's 50,000 pods provisioned through the
   controller, the nodes made Ready and reconciled by NodeController, two
   PDBs, a scale-down, three ConsolidationController windows with their
   drained nodes terminated (cordon, eviction through the PDBs, provider
   delete, finalizer strip), two nodes drained by hand under a web
   budget at its edge (429s, then the eviction queue's retries once the
   first node's replacement pods are bound), then the emptiness TTL on
   the port's clock (see phase_deprovision for every check); one record
   a window, one for the budget;
14. affinity_fuzz (B5): the selectors × peers match program against the
   scalar matches() oracle on every cell, its numpy twin and the host
   columnar leg, from 4 × 8 up to 1,024 selectors × 4,096 peers, 0 heals,
   and the program's time, launches and bound (phase_affinity_fuzz);
15. policy_window (B6 and the pack kernel's price seam): config_13's
   priced window under interruption-priced and cheapest (rows equal to
   the mirror and to encode_prices, solve_batch equal to solo solve(),
   the frontier sweep) and config_18's soft-affinity window (rows, steering,
   node count), the program's time and the priced batched launch's
   (phase_policy_window);
16. controller_affinity: config_12's window plus replicas with hostname
   anti-affinity, cohorts with required and preferred zone affinity and
   two unsatisfiable cases through the controller, under cheapest and
   interruption-priced, and the affinity pods alone on the card against
   the CPU (phase_controller_affinity);
17. gang_fuzz (B10): gang windows through dispatch_gang_window on the
   card (a one-member gang, a 4,096-member gang, all-incompatible rows,
   runs of identical members, padded rows, slices with and without seed
   bins, a gang that fails then places, BB = 8,192 on the global kernel)
   against whatif_scan_plain bit for bit and host_gang, and padded gang
   tensors through gang_scan (phase_gang_fuzz);
18. carve_fuzz (B11 and the member column): the carve program against
   host_carve on every cell up to 256 gangs × 1,024 bins, at 1,024 ×
   4,096 against a numpy evaluation per (slice class, bin) and 4,096
   cells of scalar_carve_cell, 0 heals; the program and the member
   column timed (phase_carve_fuzz);
19. gang_window: config_11's window (256 gangs over 100 types) and the
   full-width window (1,024 gangs × 16 members × 4,096 bins), the kernel
   against its plain version and host_gang, the card-filtered plan equal
   to the plain host plan, their times (phase_gang_window);
20. carve_window: config_16's legs with their gates (phase_carve_window);
21. controller_gang: 144 gangs (96 slice gangs of three shapes, 48 plain)
   and 4,096 pods through the controller on tpu_catalog(), a second wave
   on the carved nodes, high-band gangs preempting low-band ones, a
   carved node terminated; each gang window's answer against
   whatif_scan_plain on the tensors it launched (phase_controller_gang);
21b. gang_journal: controller_gang's scenario journaled, then 10 cold
   replays that rebuild the occupancy ledger bit for bit from the open
   carve intents (timed), and a crash at each of six gang, carve and
   preempt kill points with recovery and re-drives: gangs whole or
   absent, the ledger exactly the bound slice gangs' carves, no leak
   (phase_gang_journal);
21c. native_ring: the native host ring and its gate (device_min_pods,
   512 pods) on config_4's catalog: solve() at 16 to 9,984 pods equal to
   the per-pod oracle, "native" below the gate and "device" at and above
   it; the ring's and the card's median walls at each size and the
   crossover; config_12's window batched on the card against each problem
   alone on the ring; the per-pod ring's node counts on the 50,016-pod
   window's problems equal to the device's (phase_native_ring);
21d. warmup: solver/warmup.warmup_pass twice into a library directory of
   its own, cold (three builds) then warm (three loads), and a first solve
   at a warmed bucket that allocates no ring buffer (phase_warmup);
21e. main: main.build_manager in process with the defaults, a journal and
   a flight directory: config_12's window at 104 pods a schedule (2,496
   pods; the full width runs over the wire in 21g) through the Manager's
   watch pumps and workqueues, every pod bound once, no leak, no open
   intent, the pack launches held against the plain version; a
   40-pod window on
   the ring; the four HTTP endpoints; no thread left after stop
   (phase_main);
21f. main_process: python -m karpenter_tpu_torch.main on the card with
   --solver-warmup --leader-elect --journal-dir: boot to /readyz 200 and
   the warm-up's share, rc 0 on SIGTERM with the Lease released, rc 1
   without --cluster-name (phase_main_process);
21g. wire: the Manager over HTTP at full width: the stub API server
   (runtime/stubserver.py) in a child process, config_12's 9,984-pod
   window created through a second client, main.build_manager over
   KubeApiClient at the default 200 QPS / 300 burst; a 410 Expired on the
   Pod watch after the first window; every pod but the ENI group bound
   once and read back over the wire, nodes within capacity, no leak, no
   open intent, the pack launches held against the plain version, an
   expired relist counted, no thread left, the stub's process exits 0;
   the requests by verb and resource, the limiter's waits, the pressure
   level and each thread group's CPU seconds (phase_wire);
21h. webhook: webhooks.server.serve over plain HTTP with the fake
   provider: a defaulting review (its JSON patch), a valid and a denied
   validating review, a logging-config review, /healthz, and the shutdown
   (phase_webhook);
22. each phase's seconds on a line of its own as it ends; the
   device-programs line (B7, B8, B5, B6, B11, the member column, B13), the
   kernels line (pack_chunk, pack_batch with the price-row launch beside
   it, whatif_scan with its times from the deprovision window 0, the shape
   the main path gives it, and whatif_scan for gang co-pack with its times
   from the full-width gang window and config_11's and the controller
   window's shapes beside them), the card line, and
   the final ok line.

Any failed check exits non-zero.

    python3 chip_smoke.py --kernel-times

times the kernel alone on the first chunks of config_4, of the
high-cardinality problem and of two four-resource variants of it (GPU
types, every fourth shape asking for a GPU), each with a digest of its
output.
Copied into another tree (a git archive of an earlier commit, unpacked
into a fresh directory outside this package's directory, e.g. one made
by mktemp -d, where the import test does not scan it), it times that
tree's kernel on the same inputs: the A/B of PERF.md.

    python3 chip_smoke.py --whatif-times

times the what-if kernel alone, through whatif_scan's public signature,
on a window of the deprovision phase's shape built straight from
encode_window (deprovision_shaped_window: 512 x 128 x 1024) and on
config_5's window: the CUDA-event median, the device time from
torch.profiler, the host enqueue time, the bound and a digest of
(feasible, slots). Copied into another tree, it times that tree's kernel
on the same windows: the parent/change A/B of PERF.md.

    python3 chip_smoke.py --controller-deployed

runs the controller phase's run 0 alone (phase_controller_deployed): the
controller with every default, in a process that holds nothing else.

    python3 chip_smoke.py --solve-times

times the public solve() on config_4 (one cold run, then the warm runs
of phase 3), the same way in any tree it is copied into: the parent/change
A/B of solve()'s host path.

     python3 chip_smoke.py --wire

builds the kernels and runs the wire and webhook phases alone.

    python3 chip_smoke.py --manager-flood

drives config_12's window through main.build_manager with every default
at 2,496, 4,992 and 9,984 pods (each until bound or 240 s): the seconds,
the pods bound, and the CPU seconds of each thread group (selection
workers, pumps, the provisioning worker) over the flood.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import time

SEED = 11
HIGHCARD_PODS, HIGHCARD_SHAPES = 50_000, 8_000
# solve_ffd_numpy's node count on this generator (seed 11, 8000 shapes, 400
# types): 1070 in every H100 run that held the device solve against it
# (PERF.md sections 2 and 6); the oracle takes minutes on the host
HIGHCARD_NODES = 1070
# node decisions of the first high-cardinality chunk held against the plain
# version, its bound and its plain time: the plain run walks the 8192 bucket
# in Python steps (about two minutes at the solve's 64), so it is cut to a
# quarter to keep the whole script inside its limit; the kernel is also
# timed at the solve's 64 (``ms_64``, the series PERF.md tracks)
HIGHCARD_CHECK_ITERS = 16
WARM_RUNS = 25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# the host link of an H100 SXM: PCIe 5.0 x16, 64 GB/s each way (the data
# sheet's 128 GB/s counts both directions); the bound of a host→device copy
PCIE_BYTES_PER_S = 64e9
# H100 SXM peak rate of 32-bit operations of any mix of integer pipes (the
# INT32 ALUs and IMAD on the FMA pipe): each of an SM's 4 schedulers issues
# one warp instruction, 32 lanes, a clock, so 128 lanes x 132 SMs x the
# 1.98 GHz boost clock = 33.45 T ops/s. It is the data sheet's float32 peak
# (67 TFLOP/s, on-chip-measurement table) with an FMA counted as one
# operation.
OPS_PER_S = 128 * 132 * 1.98e9
# every cluster size the kernel can be launched at
CLUSTER_SIZES = (1, 2, 4, 8)

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

def card_config(**kw):
    """The solver configuration of the phases written before the native
    ring's gate came back: ``device_min_pods=0`` sends every problem and
    window to the pack kernel, whatever its size, so those phases launch
    what they launched before (the gate's default, 512 pods, would answer
    their sub-512-pod problems on the ring)."""
    from karpenter_tpu_torch.solver.solve import SolverConfig

    return SolverConfig(device_min_pods=0, **kw)


def make_catalog(n_types, zones=3, price_base=0.05, cpus_per_gpu=0, spot_rate=None):
    """The synthetic catalog; with ``cpus_per_gpu`` every type carries
    NVIDIA GPUs, one per that many cpus and at least one; ``spot_rate(i,
    z)`` stamps type i's spot offering in zone z with that interruption
    rate."""
    from karpenter_tpu_torch.cloudprovider.spi import Offering, make_instance_type

    catalog = []
    cpus = [1, 2, 4, 8, 16, 24, 32, 48, 64, 96]
    ratios = [2, 4, 8]
    i = 0
    while len(catalog) < n_types:
        cpu = cpus[i % len(cpus)]
        ratio = ratios[(i // len(cpus)) % len(ratios)]
        offerings = [Offering(ct, f"bench-zone-{z + 1}", interruption_rate=(
            spot_rate(i, z) if spot_rate and ct == "spot" else 0.0))
                     for z in range(zones) for ct in ("on-demand", "spot")]
        catalog.append(make_instance_type(
            name=f"syn-{cpu}x{ratio}-{i}",
            cpu=str(cpu), memory=f"{cpu * ratio}Gi",
            pods=str(min(110, cpu * 15)),
            nvidia_gpus=str(max(1, cpu // cpus_per_gpu)) if cpus_per_gpu else "0",
            offerings=offerings,
            price=price_base * cpu * (1 + 0.1 * (ratio // 4)),
        ))
        i += 1
    return catalog


def _pod(c, m, gpus=0):
    from karpenter_tpu_torch.api.core import Container, Pod, PodSpec, ResourceRequirements

    requests = {"cpu": f"{c}m", "memory": f"{m}Mi"}
    if gpus:
        requests["nvidia.com/gpu"] = str(gpus)
    return Pod(spec=PodSpec(containers=[Container(resources=ResourceRequirements.make(
        requests=requests))]))


def make_pods(n, shapes):
    return [_pod(*shapes[i % len(shapes)]) for i in range(n)]


def highcard_pods(n, distinct, seed, gpus=False):
    """``n`` pods over ``distinct`` random (cpu, memory) shapes; with
    ``gpus`` every fourth shape also asks for one NVIDIA GPU, so the shapes
    request four resources."""
    rng = random.Random(seed)
    shapes = set()
    while len(shapes) < distinct:
        shapes.add((rng.randint(50, 4000), rng.randint(64, 4096)))
    return make_pods(n, [(c, m, int(gpus and i % 4 == 0))
                         for i, (c, m) in enumerate(sorted(shapes))])


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


def ops_per_type_step(resources):
    """32-bit operations of one (type, shape) greedy step of the algorithm
    (packable.go:111-130, for a whole shape at once): for each resource
    some shape of the input requests, a subtract, a division, a compare and
    a min (kfit), a multiply-add (reserve), an add, two compares and an or
    (full); then clamp, failure test, npacked add and the stop test. A
    division counts as one operation. A resource no shape requests does no
    work: its reservation never moves, so its part of the full test is
    fixed per type."""
    return 9 * resources + 6


def work_bound(args, L, cost, type_steps):
    """Least time for one chunk, of one problem or of a batch (every
    tensor with a leading axis of B): the larger of its bytes (inputs read
    once, the flat buffers written once) over HBM bandwidth and its integer
    operations (the type-steps this input needs, at the resources its
    shapes request) over the op rate."""
    import torch

    from karpenter_tpu_torch.ops.pack import flat_size

    shapes, totals = args[0], args[3]
    S, T = shapes.shape[-2], totals.shape[-2]
    B = shapes.numel() // (S * shapes.shape[-1])
    nbytes = sum(t.numel() * t.element_size() for t in args[:8] if isinstance(t, torch.Tensor))
    # maxfit, prices, out
    nbytes += B * (S * 4 + (T * 4 if cost else 0) + flat_size(S, L) * 4)
    resources = int((shapes.reshape(-1, shapes.shape[-1]) > 0).any(dim=0).sum())
    ops = ops_per_type_step(resources) * type_steps
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "resources": resources,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# -- phase 2: kernel vs plain fuzz ------------------------------------------

def fuzz_problem(rng, S, T, drops, device, n_types=None):
    """A random problem in the kernel ABI: live shapes descending, placed at
    sorted random rows of the bucket (count-0 rows between them),
    0 <= reserved0 <= totals, a prefix of valid types."""
    import numpy as np

    R = 8
    n_live = int(rng.integers(1, min(S, 300) + 1))
    if n_types is None:
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
    shapes = np.zeros((S, R), np.int64)
    shapes[rows] = live
    counts = np.zeros(S, np.int64)
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
    prices = np.full(T, 2**31 - 1, np.int64)
    prices[:n_types] = rng.integers(1, 6, n_types) * 1000
    return as_args(shapes, counts, totals, reserved0, valid, n_types - 1,
                   pods_unit, prices, device)


def as_args(shapes, counts, totals, reserved0, valid, last_valid, pods_unit,
            prices, device):
    """numpy problem → (kernel argument tuple, prices) on ``device``."""
    import torch

    t = lambda a, dt: torch.as_tensor(a, dtype=dt).to(device)  # noqa: E731
    args = (t(shapes, torch.int32), t(counts, torch.int32),
            torch.zeros(shapes.shape[0], dtype=torch.int32, device=device),
            t(totals, torch.int32), t(reserved0, torch.int32), t(valid, torch.bool),
            int(last_valid), int(pods_unit))
    return args, t(prices, torch.int32)


def edge_problems(rng, device):
    """The edges of the cluster design, each (name, args, prices, cost)."""
    import numpy as np

    out = []
    # T=8 with 3 valid types: at 8 CTAs most CTAs own no valid type
    args, prices = fuzz_problem(rng, 32, 8, False, device, n_types=3)
    out.append(("few_types_t8", args, prices, True))
    # 520 valid of 1024: the valid prefix ends inside a CTA
    args, prices = fuzz_problem(rng, 512, 1024, True, device, n_types=520)
    out.append(("half_valid_t1024", args, prices, False))
    # T=4096 with cost tie-break (prices in five levels: many ties)
    args, prices = fuzz_problem(rng, 512, 4096, False, device)
    out.append(("t4096_cost", args, prices, True))
    # ties across CTAs: identical types, the cheapest price from type 300 on
    R, S, T = 8, 64, 512
    shapes = np.zeros((S, R), np.int64)
    shapes[:40, 0] = np.sort(rng.integers(1, 24, 40))[::-1]
    shapes[:40, 1] = 7
    shapes[:40, 2] = 1
    counts = np.zeros(S, np.int64)
    counts[:40] = rng.integers(1, 40, 40)
    totals = np.tile(np.array([64, 256, 30, 0, 0, 0, 0, 0], np.int64), (T, 1))
    reserved0 = np.zeros((T, R), np.int64)
    prices = np.where(np.arange(T) < 300, 5000, 3000)
    for cost in (False, True):
        args, p = as_args(shapes, counts, totals, reserved0, np.ones(T, bool),
                          T - 1, 1, prices, device)
        out.append((f"ties_across_ctas_cost{int(cost)}", args, p, cost))
    # numerators near INT32_MAX: cpu totals of 2**31-1, cpu shapes of 2**30
    # and of 1 (reserve + smallest_fits wraps in the early-exit test)
    S, T, n = 64, 512, 48
    shapes = np.zeros((S, R), np.int64)
    shapes[:n, 0] = np.where(np.arange(n) < n // 2, 2**30, 1)
    shapes[:n, 1] = rng.integers(1, 4, n)
    shapes[:n, 2] = 1
    shapes[:n] = shapes[:n][np.lexsort(shapes[:n].T[::-1])[::-1]]
    counts = np.zeros(S, np.int64)
    counts[:n] = rng.integers(1, 6, n)
    totals = np.zeros((T, R), np.int64)
    totals[:, 0] = 2**31 - 1
    totals[:, 1] = np.sort(rng.integers(8, 200, T))
    totals[:, 2] = rng.integers(5, 60, T)
    reserved0 = np.zeros((T, R), np.int64)
    reserved0[:, 0] = rng.integers(0, 2**20, T)
    args, p = as_args(shapes, counts, totals, reserved0, np.ones(T, bool),
                      T - 1, 1, np.full(T, 1000), device)
    out.append(("int32_max_numerators", args, p, False))
    # per-shape counts of 2**18 and more (past the TPU kernel's DIV_CAP)
    args, prices = fuzz_problem(rng, 512, 512, False, device)
    big = args[1].clone()
    big[big > 0] = torch_randint_like(big[big > 0], 2**18, 2**20, rng)
    out.append(("counts_past_2pow18", (args[0], big, *args[2:]), prices, False))
    # the largest shape bucket: the live list fills most of shared memory
    for T, cost in ((4096, True), (512, False)):
        args, prices = fuzz_problem(rng, 32768, T, True, device)
        out.append((f"s32768_t{T}", args, prices, cost))
    return out


def torch_randint_like(t, lo, hi, rng):
    import torch

    return torch.as_tensor(rng.integers(lo, hi, t.numel()), dtype=t.dtype).to(t.device)


def kernel_clusters(T):
    """Every cluster size the kernel takes at T."""
    from karpenter_tpu_torch.ops.pack_cuda import MAX_TYPE_THREADS, launch_threads

    return [c for c in CLUSTER_SIZES if launch_threads(T, c) <= MAX_TYPE_THREADS + 32]


def host_facts(args):
    """(log bound, requested-resource mask) of a problem, as solve() passes
    them."""
    from karpenter_tpu_torch.ops.pack_cuda import compute_log_bound, requested_mask

    return (compute_log_bound(args[3].cpu().numpy(), args[4].cpu().numpy(),
                              args[5].cpu().numpy(), args[7]),
            requested_mask(args[0].cpu().numpy()))


def on_device_scalars(args):
    """``args`` with last_valid and pods_unit as (1,) int32 tensors on the
    card, as a solve passes them: no host→device copy before each timed
    launch."""
    import torch

    dev = args[0].device
    return (*args[:6], *(torch.tensor([int(v)], dtype=torch.int32, device=dev)
                         for v in args[6:8]))


def launch_at(args, L, prices, cost, maxfit, facts, cluster):
    from karpenter_tpu_torch.ops.pack_cuda import launch_pack

    return launch_pack(*args, L, prices, cost, maxfit, *facts, cluster)


def compare(args, L, prices, cost, maxfit, all_clusters=False):
    """One pack_chunk launch and one plain run on the same inputs, and with
    ``all_clusters`` one launch at every cluster size the kernel takes:
    returns (equal, max_abs_err, kernel flat, plain stats with the plain
    run's milliseconds under "ms")."""
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
    outs = [got]
    if all_clusters:
        facts = host_facts(args)
        outs += [launch_at(args, L, prices, cost, maxfit, facts, c)
                 for c in kernel_clusters(args[3].shape[0])]
    err = max(int((o.long() - want.long()).abs().max()) for o in outs)
    return all(torch.equal(o, want) for o in outs), err, got, stats


def phase_fuzz(device):
    import numpy as np

    from karpenter_tpu_torch.ops.pack import compute_maxfit

    rng = np.random.default_rng(SEED)
    cases, launches, worst, t0 = 0, 0, 0, time.perf_counter()

    def run(args, L, prices, cost, what):
        nonlocal cases, launches, worst
        maxfit = compute_maxfit(args[0], args[3], args[4], args[5])
        ok, err, got, _ = compare(args, L, prices, cost, maxfit, all_clusters=True)
        worst = max(worst, err)
        cases += 1
        launches += 1 + len(kernel_clusters(args[3].shape[0]))
        check(ok, f"kernel != plain: {what}")
        return got

    for S in (32, 512, 8192):
        for T in (8, 512, 4096):
            for cost in (False, True):
                drops = bool(rng.random() < 0.5)
                args, prices = fuzz_problem(rng, S, T, drops, device)
                run(args, 64, prices, cost, f"S={S} T={T} cost={cost} drops={drops}")
        # chunk resume: num_iters=2, carrying counts/dropped three chunks on
        args, prices = fuzz_problem(rng, S, 512, True, device)
        for _ in range(3):
            got = run(args, 2, prices, True, f"chunk resume at S={S}")
            counts, dropped, done = got[:S], got[S:2 * S], bool(got[2 * S])
            if done:
                break
            args = (args[0], counts.clone(), dropped.clone(), *args[3:])
    edges = []
    for name, args, prices, cost in edge_problems(rng, device):
        run(args, 64, prices, cost, name)
        edges.append(name)
    errors = phase_error_word(rng, device)
    emit({"phase": "fuzz", "cases": cases, "edge_cases": edges,
          "launches_compared": launches, "bit_identical": True,
          "max_abs_err": worst, "error_word_cases": errors,
          "seconds": time.perf_counter() - t0})
    return worst


def phase_error_word(rng, device):
    """A log bound below what the chosen type logs ends the chunk with the
    done word -1, on which unpack_flat raises: never a silent wrong row."""
    from karpenter_tpu_torch.ops.pack import compute_maxfit, unpack_flat
    from karpenter_tpu_torch.ops.pack_cuda import launch_shape, pack_chunk_plain

    args, prices = fuzz_problem(rng, 512, 512, False, device)
    maxfit = compute_maxfit(args[0], args[3], args[4], args[5])
    stats = {}
    pack_chunk_plain(*args, num_iters=64, maxfit=maxfit, stats=stats)
    check(stats["log_steps"] >= 2, "error-word case: no type logs two steps")
    mask = host_facts(args)[1]
    got = launch_at(args, 64, None, False, maxfit, (1, mask), launch_shape(args[3].shape[0]))
    buf = got.cpu().numpy()
    S = args[0].shape[0]
    check(int(buf[2 * S]) == -1, f"log_bound_1: done word {int(buf[2 * S])}, expected -1")
    try:
        unpack_flat(buf, S, 64)
    except RuntimeError:
        return ["log_bound_1"]
    check(False, "log_bound_1: unpack_flat accepted the error word")


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


def time_kernel(args, maxfit, L, iters):
    """The kernel against its plain version at the rule's cluster size, its
    time, its bound, and its time at every cluster size it takes (each
    launch bit-identical to the plain version)."""
    from karpenter_tpu_torch.ops.pack_cuda import launch_shape, pack_chunk

    ok, err, want, stats = compare(args, L, None, False, maxfit)
    check(ok, "first chunk: kernel != plain")
    facts = host_facts(args)
    dargs = on_device_scalars(args)
    ms = cuda_ms(lambda: pack_chunk(*dargs, num_iters=L, maxfit=maxfit, log_bound=facts[0],
                                    resource_mask=facts[1]), iters)
    T = args[3].shape[0]
    table = []
    for c in kernel_clusters(T):
        got = launch_at(dargs, L, None, False, maxfit, facts, c)
        check(bool((got == want).all()), f"cluster {c}: kernel != plain")
        table.append({"cluster": c, "ms": cuda_ms(
            lambda: launch_at(dargs, L, None, False, maxfit, facts, c), iters)})
    return {"ms": ms, "cluster": launch_shape(T), "plain_ms": stats["ms"],
            "max_abs_err": err, "shape_steps": stats["shape_steps"],
            "type_steps": stats["type_steps"], "log_steps": stats["log_steps"],
            **work_bound(args, L, False, stats["type_steps"]), "by_cluster": table}


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
    kern = time_kernel(args, maxfit, 64, 20)
    rec = {"phase": "config_4", "pods": len(pods), "types": len(catalog),
           "shape_bucket": int(args[0].shape[0]), "type_bucket": int(args[3].shape[0]),
           "node_count": result.node_count, "numpy_node_count": ref.node_count,
           "unschedulable": 0, "executor": "device", "launches_per_solve": launches,
           "warm_runs": len(times), "p50_ms": times[len(times) // 2],
           "p99_ms": times[min(len(times) - 1, int(0.99 * len(times)))],
           "kernel": kern}
    emit(rec)
    return rec


def device_events(prof):
    """(start, end, name) of every device activity a torch.profiler session
    saw: kernels, copies and sets. The GPU side of a record_function range
    (a user annotation spanning the kernels launched inside it) is not
    device work and is left out."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_us(spans):
    """The union of the (start, end, name) device intervals, in µs."""
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, _ in sorted(spans):
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return busy + (cur_end - cur_start if cur_end is not None else 0.0)


def profile_solve(fn):
    """Run ``fn`` once under torch.profiler: the pack kernel's device time
    summed over its launches, the device's busy time (the union of its
    kernel, copy and set intervals) and its idle share of the wall time;
    None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted(device_events(prof))
    if not spans:
        return {"wall_ms": wall_us / 1e3, "pack_kernel_ms": None, "device_busy_ms": None,
                "idle_share": None, "note": "not measured: no device activity traced"}
    busy = busy_us(spans)
    kernel_us = sum(end - start for start, end, name in spans if "pack_kernel" in name)
    return {"wall_ms": wall_us / 1e3, "pack_kernel_ms": kernel_us / 1e3,
            "pack_kernel_launches": sum(1 for *_, name in spans if "pack_kernel" in name),
            "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall_us}


def phase_highcard(device):
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
    check(result.node_count == HIGHCARD_NODES,
          f"high-cardinality nodes {result.node_count}, expected {HIGHCARD_NODES}")
    seen = [id(p) for pk in result.packings for node in pk.pods for p in node]
    seen += [id(p) for p in result.unschedulable]
    check(len(seen) == len(pods) and set(seen) == {id(p) for p in pods},
          "high-cardinality: a pod is missing or placed twice")

    args, maxfit, *_ = chunk_inputs(pods, catalog, constraints, device)
    check(int(args[0].shape[0]) == 8192, "high-cardinality did not reach the 8192 bucket")
    kern = time_kernel(args, maxfit, HIGHCARD_CHECK_ITERS, 3)
    facts, dargs = host_facts(args), on_device_scalars(args)
    kern["ms_64"] = cuda_ms(lambda: pack_cuda.pack_chunk(
        *dargs, num_iters=64, maxfit=maxfit, log_bound=facts[0], resource_mask=facts[1]), 3)
    prof = profile_solve(lambda: solve(constraints, pods, catalog, device=device))
    rec = {"phase": "high_cardinality", "pods": len(pods),
           "distinct_shapes": HIGHCARD_SHAPES, "node_count": result.node_count,
           "expected_node_count": HIGHCARD_NODES,
           "unschedulable": len(result.unschedulable),
           "executor": "device", "launches_per_solve": launches,
           "solve_ms": solve_ms, "first_chunk_bit_identical": True,
           "check_iters": HIGHCARD_CHECK_ITERS, "kernel": kern,
           "profiled_solve": prof}
    emit(rec)
    return rec


def phase_kernel_times(device):
    """``--kernel-times``: the pack kernel alone, through pack_chunk's
    public signature, on the first chunk of config_4, of the
    high-cardinality problem, and of that problem on GPU types with every
    fourth shape asking for a GPU (four requested resources): with a GPU
    per 8 cpus, where the first chunk walks as long as without GPUs, and
    with one per 32, where GPUs run out and the walks are short. Each record
    holds the CUDA-event time and a digest of the flat buffer, so a run of
    another tree's kernel (this script copied into it) compares launch for
    launch. Where the tree's kernel takes a resource mask, an input of at
    most 3 resources is also timed through the kernel's 8-resource body (a
    mask of all 8 bits, the same buffer)."""
    import hashlib
    import inspect

    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.solver.solve import universe_constraints

    params = inspect.signature(pack_cuda.pack_chunk).parameters
    has_hints = "resource_mask" in params
    # a tree whose pack_chunk takes last_valid/pods_unit as device tensors
    # gets them so, as its solve passes them
    tensor_scalars = "Tensor" in str(params["last_valid"].annotation)
    for name, catalog, pods, iters in (
            ("config_4", make_catalog(400), make_pods(50_000, MIXED_SHAPES), 20),
            ("high_cardinality", make_catalog(400),
             highcard_pods(HIGHCARD_PODS, HIGHCARD_SHAPES, SEED), 3),
            ("high_cardinality_gpu", make_catalog(400, cpus_per_gpu=8),
             highcard_pods(HIGHCARD_PODS, HIGHCARD_SHAPES, SEED, gpus=True), 3),
            ("high_cardinality_gpu_scarce", make_catalog(400, cpus_per_gpu=32),
             highcard_pods(HIGHCARD_PODS, HIGHCARD_SHAPES, SEED, gpus=True), 20)):
        args, maxfit, *_ = chunk_inputs(pods, catalog, universe_constraints(catalog), device)
        rec = {"phase": "kernel_times", "input": name, "shape_bucket": int(args[0].shape[0]),
               "type_bucket": int(args[3].shape[0]),
               "resources": int((args[0] > 0).any(dim=0).sum())}
        hints = host_facts(args) if has_hints else ()
        kw = dict(zip(("log_bound", "resource_mask"), hints))
        if tensor_scalars:
            args = on_device_scalars(args)

        def run(**extra):
            return pack_cuda.pack_chunk(*args, num_iters=64, maxfit=maxfit, **{**kw, **extra})

        out = run()
        rec["digest"] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        rec["ms"] = cuda_ms(run, iters)
        if has_hints and rec["resources"] <= 3:
            got = run(resource_mask=0xFF)
            check(torch_equal(got, out), f"{name}: the 8-resource body differs")
            rec["body_8_ms"] = cuda_ms(lambda: run(resource_mask=0xFF), iters)
        emit(rec)


def phase_solve_times(device):
    """``--solve-times``: solve() on config_4, one cold run and WARM_RUNS
    warm runs; the node count, p50, p99 and the extremes."""
    import torch

    from karpenter_tpu_torch.solver.solve import solve, universe_constraints

    catalog = make_catalog(400)
    pods = make_pods(50_000, MIXED_SHAPES)
    constraints = universe_constraints(catalog)
    times = []
    for _ in range(1 + WARM_RUNS):
        t0 = time.perf_counter()
        result = solve(constraints, pods, catalog, device=device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
        check(result.node_count == 774, f"config_4 nodes {result.node_count}, expected 774")
    cold, warm = times[0], sorted(times[1:])
    emit({"phase": "solve_times", "input": "config_4", "node_count": 774, "cold_ms": cold,
          "warm_runs": len(warm), "p50_ms": warm[len(warm) // 2],
          "p99_ms": warm[min(len(warm) - 1, int(0.99 * len(warm)))],
          "min_ms": warm[0], "max_ms": warm[-1]})


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


# -- the batched window: kernel vs plain over a batch -----------------------

def fuzz_batch(rng, B, S, T, device, n_live_max=40):
    """B random problems of one (S, T) bucket as the batched kernel takes
    them: each row's live shapes at sorted random rows of the bucket, a
    random (not prefix) subset of valid types with last_valid its largest,
    as a device mask gives them; row 1 all zero (a finished problem), row 3
    with no valid type (last_valid 0), rows in between with drops."""
    import numpy as np
    import torch

    rows = []
    for b in range(B):
        args, prices = fuzz_problem(rng, S, T, drops=b % 4 == 2, device="cpu")
        shapes, counts = args[0].clone(), args[1].clone()
        live = counts > 0
        if int(live.sum()) > n_live_max:  # keep the plain version cheap
            counts[torch.nonzero(live).flatten()[n_live_max:]] = 0
        valid = torch.as_tensor(rng.random(T) < 0.7) & args[5]
        if b == 1:
            counts[:] = 0
        if b == 3 or not bool(valid.any()):
            valid[:] = False
        lv = int(torch.nonzero(valid).flatten().max()) if bool(valid.any()) else 0
        rows.append((shapes, counts, args[3], args[4], valid, lv, args[7], prices))
    t = lambda i, dt=torch.int32: torch.stack([r[i] for r in rows]).to(dt).to(device)  # noqa: E731
    args = (t(0), t(1), torch.zeros((B, S), dtype=torch.int32, device=device), t(2), t(3),
            t(4, torch.bool), torch.tensor([r[5] for r in rows], dtype=torch.int32, device=device),
            torch.tensor([r[6] for r in rows], dtype=torch.int32, device=device))
    return args, t(7)


def compare_batch(args, L, prices, cost, maxfit, clusters):
    """pack_batch and each cluster size's launch against pack_batch_plain
    on the same inputs: (equal, max_abs_err, kernel flat, plain stats with
    the plain run's milliseconds under "ms")."""
    import torch

    from karpenter_tpu_torch.ops.pack_cuda import (
        batch_log_bound, launch_pack_batch, pack_batch, pack_batch_plain, requested_mask,
    )

    stats = {}
    facts = (batch_log_bound(args[3].cpu().numpy(), args[4].cpu().numpy(), args[7].cpu().numpy()),
             requested_mask(args[0].cpu().numpy().reshape(-1, 8)))
    got = pack_batch(*args, L, prices=prices, cost_tiebreak=cost, maxfit=maxfit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pack_batch_plain(*args, L, prices=prices, cost_tiebreak=cost, maxfit=maxfit,
                            stats=stats)
    torch.cuda.synchronize()
    stats["ms"] = (time.perf_counter() - t0) * 1000.0
    outs = [got] + [launch_pack_batch(*args, L, prices, cost, maxfit, *facts, c)
                    for c in clusters]
    err = max(int((o.long() - want.long()).abs().max()) for o in outs)
    return all(torch.equal(o, want) for o in outs), err, got, stats


def phase_batch_fuzz(device):
    """pack_batch against pack_batch_plain bit for bit at B = 1, 2, 5 and
    24, S <= 512, cost tie-break off and on, every cluster size; each batch
    row of B = 1 also against pack_chunk."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops.pack import compute_maxfit
    from karpenter_tpu_torch.ops.pack_cuda import pack_chunk

    rng = np.random.default_rng(SEED + 1)
    cases, launches, worst, t0 = [], 0, 0, time.perf_counter()
    for B, S, T, L in ((1, 32, 512, 64), (1, 512, 8, 16), (2, 64, 512, 32),
                       (5, 128, 1024, 16), (5, 512, 4096, 8), (24, 32, 512, 16),
                       (24, 256, 64, 16)):
        for cost in (False, True):
            args, prices = fuzz_batch(rng, B, S, T, device)
            maxfit = compute_maxfit(args[0], args[3], args[4], args[5])
            clusters = kernel_clusters(T)
            ok, err, got, _ = compare_batch(args, L, prices, cost, maxfit, clusters)
            check(ok, f"pack_batch != plain: B={B} S={S} T={T} cost={cost}")
            if B == 1:
                one = pack_chunk(args[0][0], args[1][0], args[2][0], args[3][0], args[4][0],
                                 args[5][0], int(args[6][0]), int(args[7][0]), num_iters=L,
                                 prices=prices[0], cost_tiebreak=cost, maxfit=maxfit[0])
                check(torch.equal(one, got[0]), f"B=1 pack_batch != pack_chunk: S={S} T={T}")
            worst = max(worst, err)
            launches += 1 + len(clusters)
            cases.append(f"B={B} S={S} T={T} cost={int(cost)}")
    emit({"phase": "batch_fuzz", "cases": cases, "launches_compared": launches,
          "bit_identical": True, "b1_equals_pack_chunk": True, "max_abs_err": worst,
          "seconds": time.perf_counter() - t0})
    return worst


# -- the provisioning window (bench.py:1190-1263, config_12) -----------------

WINDOW_SCHEDULES, WINDOW_TYPES, MASK_VARIANTS = 24, 400, 192


def config12_variants(catalog):
    """bench.py:1210-1233: 192 distinct (allowed, required) keys over the
    universe of ``catalog``: capacity type rotated, one zone dropped, a
    rotating prefix of type names dropped, an ENI requirement on every
    16th."""
    from karpenter_tpu_torch.solver import adapter
    from karpenter_tpu_torch.solver.solve import universe_constraints
    from karpenter_tpu_torch.utils import resources as res

    base = adapter._allowed_sets(universe_constraints(catalog))
    cts, zones, names = sorted(base[0]), sorted(base[1]), sorted(base[2])
    pairs = []
    for v in range(MASK_VARIANTS):
        allowed = (frozenset(cts if v % 4 else cts[:1]),
                   frozenset(z for j, z in enumerate(zones) if j != v % len(zones)),
                   frozenset(names[(v * 7) % 50:]), base[3], base[4])
        required = frozenset([res.AWS_POD_ENI]) if v % 16 == 15 else frozenset()
        pairs.append((allowed, required))
    return pairs


def window_problems(catalog, per):
    """bench.py:1246-1263: 24 schedules, schedule b the universe
    constraints narrowed to zone bench-zone-{1 + b % 3}, with ``per`` pods
    cycling MIXED_SHAPES rotated by b."""
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.api.constraints import Constraints
    from karpenter_tpu_torch.api.core import NodeSelectorRequirement
    from karpenter_tpu_torch.solver.batch_solve import Problem
    from karpenter_tpu_torch.solver.solve import universe_constraints

    universe = universe_constraints(catalog)
    problems = []
    for b in range(WINDOW_SCHEDULES):
        constraints = Constraints(requirements=universe.requirements.add(NodeSelectorRequirement(
            key=wellknown.LABEL_TOPOLOGY_ZONE, operator="In", values=[f"bench-zone-{1 + b % 3}"])))
        r = b % len(MIXED_SHAPES)
        problems.append(Problem(constraints=constraints, instance_types=catalog,
                                pods=make_pods(per, MIXED_SHAPES[r:] + MIXED_SHAPES[:r])))
    return problems


def canonical(result, pods):
    """A SolveResult as pod indices: node count, every packing's option
    names, quantity and pod lists, and the unschedulable pods."""
    index = {id(p): i for i, p in enumerate(pods)}
    return (result.node_count,
            [(tuple(it.name for it in p.instance_type_options), p.node_quantity,
              [[index[id(x)] for x in node] for node in p.pods]) for p in result.packings],
            [index[id(p)] for p in result.unschedulable])


def numpy_result(prob):
    """solve_ffd_numpy on one problem, materialized like solve()."""
    from karpenter_tpu_torch.models.ffd import solve_ffd_numpy
    from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
    from karpenter_tpu_torch.solver.solve import SolverConfig, materialize

    packables, sorted_types = build_packables(prob.instance_types, prob.constraints,
                                              prob.pods, prob.daemons)
    host = solve_ffd_numpy(pod_vectors(prob.pods), list(range(len(prob.pods))), packables)
    return materialize(host, prob.pods, sorted_types, prob.constraints, SolverConfig())


def reset_counts():
    from karpenter_tpu_torch.ops import device_filter, pack_cuda, whatif_cuda
    from karpenter_tpu_torch.ops import policy as ops_policy
    from karpenter_tpu_torch.solver import global_solve, topology
    from karpenter_tpu_torch.solver.solve import reset_executor_counts

    pack_cuda.LAUNCHES = 0
    pack_cuda.BATCH_LAUNCHES = 0
    whatif_cuda.LAUNCHES = 0
    global_solve.RUNS = 0
    topology.RUNS = 0
    device_filter.AFFINITY_RUNS = 0
    device_filter.GANG_COLUMN_RUNS = 0
    ops_policy.RUNS = 0
    reset_executor_counts()
    device_filter.reset_fallback_counts()


def executor_counts():
    from karpenter_tpu_torch.solver.solve import solver_health

    return solver_health()["executor_counts"]


def phase_mask(device):
    """config_12's 192 variants in 8 windows of 24 over make_catalog(400):
    the device mask against the port's scalar _validate, type for type, and
    the mask program's time per window."""
    from karpenter_tpu_torch.backend import to_device_int32
    from karpenter_tpu_torch.ops import device_filter
    from karpenter_tpu_torch.solver.adapter import _validate

    catalog = make_catalog(WINDOW_TYPES)
    pairs = config12_variants(catalog)
    divergence, feasible, t0 = 0, 0, time.perf_counter()
    for w in range(0, MASK_VARIANTS, WINDOW_SCHEDULES):
        window = pairs[w:w + WINDOW_SCHEDULES]
        mask = device_filter.compute_mask(catalog, window, device=device)
        check(mask is not None and mask.shape == (len(window), len(catalog)),
              "mask: the catalog was refused")
        for s, (allowed, required) in enumerate(window):
            ref = [_validate(it, allowed, required) is None for it in catalog]
            divergence += sum(int(m) != int(r) for m, r in zip(mask[s], ref))
            feasible += sum(ref)
    check_s = time.perf_counter() - t0
    check(divergence == 0, f"mask: {divergence} verdicts differ from _validate")
    planes = device_filter.planes_for(catalog)
    rows = [device_filter.schedule_row(planes, a, r) for a, r in pairs[:WINDOW_SCHEDULES]]
    stacked = device_filter._stack_rows(planes, rows, WINDOW_SCHEDULES)
    probe = device_filter._probe_indices(planes.n)
    *rows_d, probe_d = to_device_int32([*stacked, probe], device)
    planes_d = device_filter.resident_planes(planes, device)
    probe_d = probe_d.long()
    ms = cuda_ms(lambda: device_filter.window_mask(planes_d, tuple(rows_d), probe_d), 50)
    t0 = time.perf_counter()
    for _ in range(10):
        device_filter.compute_mask(catalog, pairs[:WINDOW_SCHEDULES], device=device)
    wall = (time.perf_counter() - t0) * 100.0
    emit({"phase": "mask", "variants": MASK_VARIANTS, "windows": MASK_VARIANTS // WINDOW_SCHEDULES,
          "types": len(catalog), "type_bucket": planes.TB, "verdicts": MASK_VARIANTS * len(catalog),
          "feasible": feasible, "divergence": 0, "mask_program_ms_per_window": ms,
          "compute_mask_wall_ms_per_window": wall, "scalar_check_s": check_s})


def time_batch_kernel(run, iters):
    """The batched launch of a window's first chunk (the inputs
    dispatch_batch built) against pack_batch_plain, its CUDA-event time,
    its bound, the 24 solo pack_chunk launches on the same encodings (each
    row bit-identical to the batch's), and its time at every cluster size."""
    import torch

    from karpenter_tpu_torch.ops.pack_cuda import (
        launch_pack_batch, launch_shape, pack_batch, pack_chunk,
    )

    args = (run.shapes_d, run.counts_d, run.dropped_d, run.totals_d, run.reserved0_d,
            run.valid_d, run.last_valid_d, run.pods_unit_d)
    L, B, T = run.L, run.shapes_d.shape[0], run.totals_d.shape[1]
    hints = dict(maxfit=run.maxfit_d, log_bound=run.log_bound, resource_mask=run.resource_mask)
    clusters = kernel_clusters(T)
    ok, err, got, stats = compare_batch(args, L, None, False, run.maxfit_d, clusters)
    check(ok, "window: batched kernel != plain")
    ms = cuda_ms(lambda: pack_batch(*args, L, **hints), iters)
    def solo(b):
        return pack_chunk(*(a[b] for a in args[:6]), *(a[b:b + 1] for a in args[6:]),
                          num_iters=L, **{k: (v[b] if k == "maxfit" else v)
                                          for k, v in hints.items()})

    for b in range(B):
        check(torch.equal(solo(b), got[b]), f"window: solo launch of row {b} != batch row")
    solo_ms = cuda_ms(lambda: [solo(b) for b in range(B)], iters)
    table = [{"cluster": c, "ms": cuda_ms(lambda: launch_pack_batch(
        *args, L, None, False, run.maxfit_d, run.log_bound, run.resource_mask, c), iters)}
        for c in clusters]
    return {"ms": ms, "cluster": launch_shape(T), "type_bucket": int(T),
            "plain_ms": stats["ms"], "max_abs_err": err, "solo_launches": B, "solo_ms": solo_ms, "shape_steps": stats["shape_steps"],
            "type_steps": stats["type_steps"], **work_bound(args, L, False, stats["type_steps"]),
            "by_cluster": table}


def phase_window(device, per, warm_runs):
    """config_12's window through solve_batch (the main path): 24
    schedules of ``per`` pods over 400 types, every problem equal to solo
    solve() and to solve_ffd_numpy, every one by "device-batch", no mask
    mismatch; p50/p99 over warm runs; the batched kernel timed."""
    import torch

    from karpenter_tpu_torch.ops import device_filter, pack_cuda
    from karpenter_tpu_torch.solver.batch_solve import dispatch_batch
    from karpenter_tpu_torch.solver.solve import solve

    catalog = make_catalog(WINDOW_TYPES)
    problems = window_problems(catalog, per)
    n = len(problems)
    reset_counts()
    handle = dispatch_batch(problems, device=device)  # the main path
    results = handle.fetch()
    torch.cuda.synchronize()
    launches = {"pack_batch": pack_cuda.BATCH_LAUNCHES, "pack_chunk": pack_cuda.LAUNCHES}
    check(launches["pack_batch"] > 0, "window: the batched kernel was never launched")
    check(executor_counts() == {"device-batch": n},
          f"window answered by {executor_counts()}")
    check(device_filter.fallback_counts() == {},
          f"window: mask fallbacks {device_filter.fallback_counts()}")
    check(handle.fused is not None, "window: the mask was not fused")
    run = handle.device_run
    for b, (prob, got) in enumerate(zip(problems, results)):
        want = canonical(got, prob.pods)
        check(want == canonical(solve(prob.constraints, prob.pods, catalog, device=device,
                                      config=card_config()),
                                prob.pods), f"window: problem {b} != solo solve()")
        check(want == canonical(numpy_result(prob), prob.pods),
              f"window: problem {b} != solve_ffd_numpy")
    nodes = [r.node_count for r in results]
    reset_counts()
    times, dispatch_ms = [], []
    for _ in range(warm_runs):
        # solve_batch is dispatch_batch(...).fetch(): its two halves timed
        t0 = time.perf_counter()
        h = dispatch_batch(problems, device=device)
        t1 = time.perf_counter()
        rs = h.fetch()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
        dispatch_ms.append((t1 - t0) * 1000.0)
        check([r.node_count for r in rs] == nodes, "warm window changed its node counts")
    check(executor_counts() == {"device-batch": n * warm_runs},
          f"warm windows answered by {executor_counts()}")
    check(device_filter.fallback_counts() == {}, "warm windows: mask fallbacks")
    times.sort()
    dispatch_ms.sort()
    fresh = dispatch_batch(problems, device=device)
    kern = time_batch_kernel(fresh.device_run, 20)
    fresh.fetch()
    rec = {"phase": "window", "schedules": n, "pods": sum(len(p.pods) for p in problems),
           "types": len(catalog), "shape_bucket": run.S0, "type_bucket": kern["type_bucket"],
           "nodes": sum(nodes), "nodes_per_problem": nodes,
           "unschedulable": sum(len(r.unschedulable) for r in results),
           "executor": "device-batch", "mask_mismatches": 0, "launches_per_window": launches,
           "chunk_buckets": run.buckets, "equal_to_solo_and_numpy": True,
           "warm_runs": len(times), "p50_ms": times[len(times) // 2],
           "p99_ms": times[min(len(times) - 1, int(0.99 * len(times)))],
           "dispatch_p50_ms": dispatch_ms[len(dispatch_ms) // 2], "kernel": kern}
    emit(rec)
    return rec


def phase_mixed_window(device):
    """23 of config_12's schedules and one of the high-cardinality pods
    (seed 11, 8000 shapes, 25,000 pods): the batch pads to S = 8192 and
    compacts across problems; every problem equal to solo solve()."""
    import torch

    from karpenter_tpu_torch.ops import device_filter, pack_cuda
    from karpenter_tpu_torch.solver.batch_solve import Problem, dispatch_batch
    from karpenter_tpu_torch.solver.solve import solve

    catalog = make_catalog(WINDOW_TYPES)
    problems = window_problems(catalog, 416)
    problems[-1] = Problem(constraints=problems[-1].constraints, instance_types=catalog,
                           pods=highcard_pods(25_000, HIGHCARD_SHAPES, SEED))
    reset_counts()
    t0 = time.perf_counter()
    handle = dispatch_batch(problems, device=device)  # the main path
    results = handle.fetch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    launches = pack_cuda.BATCH_LAUNCHES
    run = handle.device_run
    check(launches == run.launches > 0, "mixed window: launches")
    check(executor_counts() == {"device-batch": len(problems)},
          f"mixed window answered by {executor_counts()}")
    check(device_filter.fallback_counts() == {}, "mixed window: mask fallbacks")
    check(run.buckets[0] == 8192 and len(run.buckets) > 1,
          f"mixed window walked the buckets {run.buckets}")
    for b, (prob, got) in enumerate(zip(problems, results)):
        check(canonical(got, prob.pods) ==
              canonical(solve(prob.constraints, prob.pods, catalog, device=device,
                              config=card_config()), prob.pods),
              f"mixed window: problem {b} != solo solve()")
    rec = {"phase": "mixed_window", "schedules": len(problems),
           "pods": sum(len(p.pods) for p in problems),
           "nodes_per_problem": [r.node_count for r in results],
           "unschedulable": sum(len(r.unschedulable) for r in results),
           "executor": "device-batch", "mask_mismatches": 0, "launches": launches,
           "chunk_buckets": run.buckets, "equal_to_solo": True, "solve_batch_ms": wall_ms}
    emit(rec)
    return rec


# -- the provisioning controller: pods in, nodes and binds out ---------------

MARSHAL_PODS, MARSHAL_WINDOWS, MARSHAL_CHURN, MARSHAL_TYPES = 20_000, 12, 0.10, 100
RING_PROBE_BYTES = 16 << 20


def marshal_streams():
    """config_10's window stream (bench.py:950-1060): 20,000 pods over
    MIXED_SHAPES, each of 12 windows (+ one to warm) replacing 10 % of the
    pod objects, seed 42."""
    rng = random.Random(42)
    pop = list(make_pods(MARSHAL_PODS, MIXED_SHAPES))
    streams = []
    for _ in range(MARSHAL_WINDOWS + 1):
        k = int(MARSHAL_PODS * MARSHAL_CHURN)
        fresh = make_pods(k, MIXED_SHAPES)
        for j, idx in enumerate(rng.sample(range(MARSHAL_PODS), k)):
            pop[idx] = fresh[j]
        streams.append(list(pop))
    return streams


def ring_refill_record(arrays, device, runs=20):
    """B13 on the card: ``arrays`` refilled in place into a ring slot's
    tensors (pinned staging, copy_ non_blocking), the median CUDA-event ms
    of one refill of them all, the same on CPU tensors, the bytes and the
    bound (the bytes at the host link's rate). Checks the device tensors
    hold the bytes, were written in place, and the counts."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.solver.pipeline import DeviceRing

    def ring_on(dev):
        ring = DeviceRing()
        slot = ring.acquire(DeviceRing.signature(arrays))
        first = {n: ring.fill(slot, n, a, dev) for n, a in arrays.items()}
        return ring, slot, first

    ring, slot, first = ring_on(device)
    torch.cuda.synchronize()

    def refill():
        for name, a in arrays.items():
            ring.fill(slot, name, a, device)

    ms = median_event_ms(refill, runs)
    torch.cuda.synchronize()
    for name, a in arrays.items():
        check(slot.arrays[name] is first[name], f"B13: {name} was not refilled in place")
        check(np.array_equal(slot.arrays[name].cpu().numpy(), a), f"B13: {name} != its host bytes")
    c = ring.counters()
    check(c["allocations"] == len(arrays) and c["refills"] == (runs + 1) * len(arrays),
          f"B13: ring counts {c}")
    cring, cslot, _ = ring_on(torch.device("cpu"))
    t0 = time.perf_counter()
    for _ in range(runs):
        for name, a in arrays.items():
            cring.fill(cslot, name, a, torch.device("cpu"))
    cpu_ms = (time.perf_counter() - t0) * 1000.0 / runs
    nbytes = int(sum(np.asarray(a).nbytes for a in arrays.values()))
    return {"bytes": nbytes, "copies": len(arrays), "ms": ms, "cpu_ms": cpu_ms,
            "bound_ms": nbytes / PCIE_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "max_abs_err": 0}


def phase_marshal_delta(device):
    """config_10 at full size (bench.py:950-1060): 20,000 pods over
    MIXED_SHAPES and make_catalog(100), 12 windows of 10 % object churn,
    seed 42, through the production entry points (marshal_pods_interned →
    build_packables_versioned → encode) twice a window: DELTA (the warm
    arena and catalog cache) and COLD (arena, catalog cache and the pods'
    entries cleared first). Checks: 12 of 12 encodings bit-identical; the
    last window's solve() on the card equal delta and cold (node count and
    bound sets); a repeat solve() of it makes 0 fresh ring allocations and
    reuses the catalog tensors; every window's solve() ships only what its
    tokens do not cover. Reports the p50/p99 of both, the ring's counts,
    the bytes each window's solve() copied with and without tokens, and
    B13's refill of the solve's working set timed by CUDA events against
    the host link."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import encode as enc_mod
    from karpenter_tpu_torch.ops import feasibility
    from karpenter_tpu_torch.ops.encode import pad_encoding
    from karpenter_tpu_torch.parallel.batched_pack import pad_problems
    from karpenter_tpu_torch.solver import adapter, pipeline
    from karpenter_tpu_torch.solver.solve import solve, universe_constraints

    catalog = make_catalog(MARSHAL_TYPES)
    constraints = universe_constraints(catalog)
    streams = marshal_streams()

    def marshal_encode(win):
        vecs, required, sids = adapter.marshal_pods_interned(win)
        packables, _st, ver = adapter.build_packables_versioned(
            catalog, constraints, win, [], required=required)
        return enc_mod.encode(vecs, list(range(len(win))), packables, pad=False, sids=sids,
                              catalog_version=ver)

    def clear_all(win):
        for p in win:
            p.__dict__.pop(adapter._CACHE_KEY, None)
            p.__dict__.pop(adapter._ROW_KEY, None)
        enc_mod.reset_marshal_arena()
        enc_mod.clear_catalog_encoding_cache()

    def enc_key(e):
        return (e.shapes.tobytes(), e.counts.tobytes(), e.totals.tobytes(),
                e.reserved0.tobytes(), e.valid.tobytes(), e.last_valid, e.num_shapes,
                e.num_types, e.shape_pods, e.scales, e.pods_unit)

    feasibility.reset_heals()
    marshal_encode(streams[0])  # warm the arena and the caches
    delta_ms, cold_ms, identical, fractions = [], [], 0, []
    for win in streams[1:]:
        t0 = time.perf_counter()
        e_delta = marshal_encode(win)
        delta_ms.append((time.perf_counter() - t0) * 1000.0)
        fractions.append(enc_mod.marshal_arena().delta_fraction)
        clear_all(win)
        t0 = time.perf_counter()
        e_cold = marshal_encode(win)  # repopulates for the next delta
        cold_ms.append((time.perf_counter() - t0) * 1000.0)
        identical += enc_key(e_delta) == enc_key(e_cold)
    check(identical == MARSHAL_WINDOWS,
          f"marshal_delta: {identical} of {MARSHAL_WINDOWS} encodings bit-identical")

    def bound_key(win, result):
        pos = {id(p): i for i, p in enumerate(win)}
        return (result.node_count, sorted(
            (tuple(it.name for it in p.instance_type_options), p.node_quantity,
             sorted(tuple(sorted(pos[id(pod)] for pod in node)) for node in p.pods))
            for p in result.packings))

    final = streams[-1]
    reset_counts()
    k_delta = bound_key(final, solve(constraints, final, catalog, device=device))
    clear_all(final)
    k_cold = bound_key(final, solve(constraints, final, catalog, device=device))
    torch.cuda.synchronize()
    check(k_delta == k_cold, "marshal_delta: the last window's solve differs delta and cold")
    check(executor_counts() == {"device": 2}, f"marshal_delta: solved by {executor_counts()}")

    # the ring: a repeat solve() of the same window on the card
    pipeline.reset_ring()
    ring = pipeline.get_ring()
    solve(constraints, final, catalog, device=device)
    c0 = ring.counters()
    solve(constraints, final, catalog, device=device)
    torch.cuda.synchronize()
    c1 = ring.counters()
    steady = {k: c1[k] - c0[k] for k in ("allocations", "refills", "reuses")}
    check(steady["allocations"] == 0 and steady["reuses"] >= 5 and steady["refills"] >= 1,
          f"marshal_delta: the repeat solve's ring counts {steady}")

    # the bytes every window's solve() copies host→device, and would copy
    # without the content tokens
    real_fill, shipped = ring.fill, []

    def counting_fill(slot, name, host, dev, token=None):
        reuses = ring.reuses
        out = real_fill(slot, name, host, dev, token=token)
        shipped[-1][1] += int(np.asarray(host).nbytes)
        if ring.reuses == reuses:
            shipped[-1][0] += int(np.asarray(host).nbytes)
        return out

    ring.fill = counting_fill
    try:
        for win in streams[1:]:
            shipped.append([0, 0])
            solve(constraints, win, catalog, device=device)
    finally:
        del ring.fill
    torch.cuda.synchronize()

    # B13: the solve's working set refilled in place, and a 16 MiB probe
    enc = pad_encoding(marshal_encode(final))
    shapes, counts, dropped, totals, reserved0, valid, last_valid, pods_unit, _ = \
        pad_problems([enc])
    working = {"shapes": shapes, "counts": counts, "dropped": dropped, "totals": totals,
               "reserved0": reserved0, "valid": valid, "last_valid": last_valid,
               "pods_unit": pods_unit}
    refill = ring_refill_record(working, device)
    probe = ring_refill_record(
        {"probe": np.arange(RING_PROBE_BYTES // 4, dtype=np.int32)}, device)
    check(feasibility.heal_counts() == {}, f"marshal_delta: heals {feasibility.heal_counts()}")
    delta_ms.sort()
    cold_ms.sort()
    rec = {"phase": "marshal_delta", "pods": MARSHAL_PODS, "windows": MARSHAL_WINDOWS,
           "churn": MARSHAL_CHURN, "types": len(catalog),
           "delta_p50_ms": p50(delta_ms), "delta_p99_ms": delta_ms[-1],
           "cold_p50_ms": p50(cold_ms), "cold_p99_ms": cold_ms[-1],
           "delta_ms": delta_ms, "cold_ms": cold_ms, "delta_fraction": fractions,
           "encodings_identical": identical, "solve_parity": True, "nodes": k_delta[0],
           "arena": enc_mod.marshal_arena().stats(), "steady_ring": steady,
           "window_bytes_shipped": [a for a, _ in shipped],
           "window_bytes_untokened": [b for _, b in shipped],
           "refill": refill, "refill_16mib": probe}
    emit(rec)
    return rec


def phase_controller_columnar(device):
    """config_12's 9,984-pod window through the controller (backend "ffd",
    one chunk), two windows on the columnar path (the default: the
    selection controller's validate_pod_fast, the scheduler's memoized
    schedule_entry, the ring) and two on the scalar path
    (feasibility.compile_constraints patched to give None: validate_pod and
    tighten per pod). The binds must be identical, window for window, and
    no engine self-heal may fire. Reports reconcile_s and schedule_s both
    ways and the ring's counts of each window (B13's refills a window)."""
    from karpenter_tpu_torch.ops import feasibility
    from karpenter_tpu_torch.solver import pipeline
    from karpenter_tpu_torch.solver.pipeline import PipelineConfig

    catalog = make_catalog(WINDOW_TYPES)
    real_compile = feasibility.compile_constraints
    feasibility.reset_heals()
    runs = {}
    for mode in ("columnar", "scalar"):
        if mode == "scalar":
            feasibility.compile_constraints = lambda c: None
        run = ControllerRun(catalog, device, card_config(window_backend="ffd"),
                            PipelineConfig(chunk_items=0))
        try:
            recs = []
            for w in range(2):
                ring = pipeline.get_ring()
                before = ring.counters()
                rec = run.window(config12_controller_pods(catalog, 416, f"c{w}"))
                after = pipeline.get_ring().counters()
                rec["ring"] = {k: after[k] - before[k]
                               for k in ("allocations", "refills", "reuses")}
                rec["binds"] = strip_prefix(run.binds)
                check(rec["chunks"] == 1 and set(rec["executor_counts"]) == {"device-batch"},
                      f"controller_columnar ({mode}): {rec['chunks']} chunks, "
                      f"{rec['executor_counts']}")
                recs.append(rec)
        finally:
            feasibility.compile_constraints = real_compile
            run.stop()
        runs[mode] = recs
    for w, (c, s) in enumerate(zip(runs["columnar"], runs["scalar"])):
        check(c["binds"] == s["binds"],
              f"controller_columnar: window {w} binds differ columnar and scalar")
    check(feasibility.heal_counts() == {},
          f"controller_columnar: heals {feasibility.heal_counts()}")
    check(runs["columnar"][1]["ring"]["allocations"] == 0,
          f"controller_columnar: the second window allocated {runs['columnar'][1]['ring']}")
    keep = ("wall_s", "reconcile_s", "batch_window_s", "schedule_s", "dispatch_s",
            "inflight_s", "fetch_s", "launch_bind_s", "nodes", "pods_bound", "ring")
    rec = {"phase": "controller_columnar", "pods": runs["columnar"][0]["pods"],
           "binds_identical": True,
           **{mode: [{k: r[k] for k in keep} for r in recs] for mode, recs in runs.items()}}
    emit(rec)
    rec["binds"] = runs["columnar"][0]["binds"]  # returned for phase_observability
    return rec


# the retroactive spans (add_span: timed before or after the fact, never
# entered, so they enter no profiler range) of a provisioning window
RETROACTIVE_SPANS = ("intake", "marshal", "dispatch", "device_solve", "launch_bind")
SOLVE_RANGES = ("karpenter.solve.batch_dispatch", "karpenter.solve.batch_device",
                "karpenter.solve.device")
OBS_ALTERNATIONS = 3  # windows each with tracing and SLO stamps on, and off


def series_delta(before, after, name):
    """Counter and gauge series of ``name`` as {labels: after - before}
    (absent before counts as 0) from two Registry.snapshot()s."""
    a, b = after.get(name, {}).get("series", {}), before.get(name, {}).get("series", {})
    return {k: v - b.get(k, 0.0) for k, v in a.items() if v - b.get(k, 0.0)}


def window_tree(spans, wid):
    """The window's spans: (provision roots, spans whose parent is not a
    span of the window, names present). A window is well formed when it has
    one root and every other span parents inside it."""
    mine = [s for s in spans if s["trace_id"] == wid]
    ids = {s["span_id"] for s in mine}
    roots = [s for s in mine if s["parent_id"] == 0]
    orphans = [s["name"] for s in mine if s["parent_id"] != 0 and s["parent_id"] not in ids]
    return mine, roots, orphans


def new_cluster(catalog):
    """An API server holding one provisioner over ``catalog``'s universe,
    and a fake provider."""
    from karpenter_tpu_torch.api.core import ObjectMeta
    from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
    from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider
    from karpenter_tpu_torch.runtime.kubecore import KubeCore
    from karpenter_tpu_torch.solver.solve import universe_constraints

    kube = KubeCore()
    provisioner = Provisioner(metadata=ObjectMeta(name="default"),
                              spec=ProvisionerSpec(constraints=universe_constraints(catalog)))
    kube.create(provisioner)
    return kube, FakeCloudProvider(catalog=catalog), provisioner


def calling_thread_worker(kube, provider, provisioner, device, journal=None):
    """A ProvisionerWorker driven on the calling thread (add, then
    provision()), never started: a torch.profiler session records the
    ranges of the thread it runs on, and a SimulatedCrash raised inside a
    window reaches the caller, as a death would end the process. One chunk
    a window, a monitor that only the depth signal moves."""
    from karpenter_tpu_torch.controllers.provisioning import ProvisionerWorker
    from karpenter_tpu_torch.pressure import PressureConfig, PressureMonitor
    from karpenter_tpu_torch.scheduling.batcher import Batcher
    from karpenter_tpu_torch.solver.pipeline import PipelineConfig

    monitor = PressureMonitor(PressureConfig(
        rss_watermark_bytes=0, window_l1_seconds=60.0, window_l2_seconds=120.0))
    return ProvisionerWorker(
        provisioner, kube, provider, solver_config=card_config(window_backend="ffd"),
        batcher=Batcher(idle_seconds=0.01, max_seconds=120.0, monitor=monitor),
        pipeline_config=PipelineConfig(chunk_items=0), device=device, journal=journal)


def direct_worker(catalog, device):
    """A calling-thread worker over its own API server, and a function that
    runs one window of new pods through it."""
    kube, provider, provisioner = new_cluster(catalog)
    worker = calling_thread_worker(kube, provider, provisioner, device)

    def window(pods):
        for pod in pods:
            kube.create(pod)
            check(worker.add(pod, key=(pod.metadata.namespace, pod.metadata.name)) is not None,
                  "observability: a pod was shed at intake")
        worker.provision()
        return sum(1 for p in pods if kube.read("Pod", p.metadata.name, p.metadata.namespace,
                                                lambda q: bool(q.spec.node_name)))

    return worker, window


def range_record(prof, names):
    """Per record_function range name: how many ranges the session holds,
    their host ms (the range's own wall on its thread) and the device ms of
    everything launched inside them (kernels, copies and sets, counted at
    the launch: a range holds the kernels it launches, not the ones it
    waits for)."""
    from torch.autograd import DeviceType

    out = {n: {"ranges": 0, "host_ms": 0.0, "device_ms": 0.0} for n in names}
    for e in prof.events():
        rec = out.get(e.name)
        if rec is None or e.device_type != DeviceType.CPU:
            continue
        rec["ranges"] += 1
        rec["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        rec["device_ms"] += e.device_time_total / 1e3
    return out


def profiled_window(catalog, device, attempts=3):
    """One traced window (config_12's 9,984 pods, 24 schedules: the batched
    path) and a one-schedule window (416 pods: the solo path) on a directly
    driven worker under torch.profiler, with the tracer's annotations on.
    A session is taken only when it saw every pack kernel the windows
    launched (late in the script a session can miss kernels); each attempt
    runs fresh pods. Returns (ranges, entered span names, attempts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch.obs import trace
    from karpenter_tpu_torch.ops import pack_cuda

    worker, window = direct_worker(catalog, device)
    seen = None
    for attempt in range(attempts):
        batch = config12_controller_pods(catalog, 416, f"pf{attempt}")
        solo = [p for p in config12_controller_pods(catalog, 416, f"ps{attempt}")
                if "-g00-" in p.metadata.name]
        trace.reset()
        trace.enable(annotations=True)
        launches0 = pack_cuda.LAUNCHES + pack_cuda.BATCH_LAUNCHES
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                window(batch)
                window(solo)
                torch.cuda.synchronize()
        finally:
            trace.disable()
        launched = pack_cuda.LAUNCHES + pack_cuda.BATCH_LAUNCHES - launches0
        seen = sum(1 for *_, name in device_events(prof) if "pack_kernel" in name)
        spans = trace.snapshot()
        entered = sorted({s["name"] for s in spans if s["t1"] > s["t0"]}
                         - set(RETROACTIVE_SPANS))
        if seen == launched and launched > 0:
            return range_record(prof, entered + list(SOLVE_RANGES)), entered, attempt + 1
    check(False, f"observability: no profiler session saw every pack kernel "
                 f"({seen} seen in the last of {attempts})")


def trigger_dumps():
    """The flight recorder's two triggers on the port: an SLO objective of
    1 ms breached by every e2e sample, evaluated twice (exactly one
    slo-burn dump), and a pressure monitor driven into L3 by its intake
    depth (one pressure-l3 dump), each in a fresh temporary directory."""
    from karpenter_tpu_torch.obs import flight, slo
    from karpenter_tpu_torch.pressure import PressureConfig, PressureMonitor

    out = {}
    was = slo.enabled()
    try:
        with tempfile.TemporaryDirectory() as d:
            flight.reset()
            flight.configure(dir=d)
            slo.reset()
            slo.configure(enabled=True, objectives={"default": slo.Objective(0.001)})
            for _ in range(50):
                slo.record("default", "e2e", 0.25)
            first, second = slo.evaluate(), slo.evaluate()
            dumps = sorted(os.listdir(d))
            check(len(dumps) == 1 and dumps[0].endswith("-slo-burn.json"),
                  f"observability: slo-burn dumps {dumps}")
            with open(os.path.join(d, dumps[0])) as f:
                dump = json.load(f)
            check(dump["trigger"] == "slo-burn" and dump["tags"]["band"] == "default"
                  and dump["tags"]["stage"] == "e2e",
                  f"observability: slo-burn dump tags {dump['tags']}")
            check(slo.burning() == ["default"] and slo.trips_total() == 1
                  and first["default"]["burning"] and second["default"]["burning"],
                  f"observability: burn state {slo.burning()} trips {slo.trips_total()}")
            out["slo_burn"] = {"dumps": dumps, "tags": dump["tags"]}
        with tempfile.TemporaryDirectory() as d:
            flight.reset()
            flight.configure(dir=d)
            monitor = PressureMonitor(PressureConfig(max_depth=1000, rss_watermark_bytes=0))
            monitor.note_depth(1, 900)
            check(int(monitor.level()) == 3, f"observability: monitor at L{int(monitor.level())}")
            dumps = sorted(os.listdir(d))
            check(len(dumps) == 1 and dumps[0].endswith("-pressure-l3.json"),
                  f"observability: pressure-l3 dumps {dumps}")
            with open(os.path.join(d, dumps[0])) as f:
                dump = json.load(f)
            check(dump["trigger"] == "pressure-l3" and dump["tags"]["from_level"] == 0
                  and dump["tags"]["intake_depth"] == 900,
                  f"observability: pressure-l3 dump tags {dump['tags']}")
            out["pressure_l3"] = {"dumps": dumps, "tags": dump["tags"]}
    finally:
        flight.configure(dir="")
        flight.reset()
        slo.configure(enabled=was, objectives=slo.default_objectives())
        slo.reset()
    return out


def phase_observability(device, columnar_binds):
    """config_12's 9,984-pod window through the controller in one chunk
    (controller_columnar's window) with tracing and the SLO engine on:
    every pod bound once and the binds equal to controller_columnar's, all
    five SLO stages stamped and no band burning, the window's spans under
    one provision span with the pipeline's stage spans among them, every
    registered series in the exposition with its help text, and the ring's
    series equal to the ring's own counts. The tracing and stamping tax by
    the JAX package's method (the window's spans × ns per enabled span, its
    SLO record calls × ns per record, each over the window's wall), beside
    a direct reading (tracing and stamps on and off, alternated over
    OBS_ALTERNATIONS windows each, p50 walls; context only: host work
    varies about 2x between calls). Then one profiled traced window (the
    record_function range of every entered span and of the three
    karpenter.solve labels, with the device ms launched inside each) and
    the flight recorder's two triggers."""
    from karpenter_tpu_torch.metrics import registry
    from karpenter_tpu_torch.obs import slo, trace
    from karpenter_tpu_torch.solver import pipeline
    from karpenter_tpu_torch.solver.pipeline import PipelineConfig

    catalog = make_catalog(WINDOW_TYPES)
    was_slo = slo.enabled()
    run = ControllerRun(catalog, device, card_config(window_backend="ffd"),
                        PipelineConfig(chunk_items=0))
    try:
        trace.reset()
        slo.reset()
        trace.enable()
        slo.enable()
        ring0, snap0 = pipeline.get_ring().counters(), registry.DEFAULT.snapshot()
        rec = run.window(config12_controller_pods(catalog, 416, "o0"))
        ring1, snap1 = pipeline.get_ring().counters(), registry.DEFAULT.snapshot()
        trace.disable()
        spans, n_spans = trace.snapshot(), trace.state()["spans_buffered"]
        calls, stages, burning = slo.record_calls(), slo.snapshot()["stages"], slo.burning()
        wid = run.worker.last_window["window_id"]
        text = registry.DEFAULT.expose()

        check(rec["chunks"] == 1, f"observability: {rec['chunks']} chunks")
        binds = strip_prefix(run.binds)
        once_each([n for _, names in binds for n in names],
                  [n for _, names in columnar_binds for n in names], "observability")
        check(binds == columnar_binds,
              "observability: the traced window's binds differ from controller_columnar's")
        check(all(stages.get(s, {}).get("n", 0) > 0 for s in slo.STAGES),
              f"observability: SLO stages {stages}")
        check(burning == [], f"observability: bands burning {burning}")
        mine, roots, orphans = window_tree(spans, wid)
        names = {s["name"] for s in mine}
        check(len(roots) == 1 and roots[0]["name"] == "provision" and not orphans,
              f"observability: window {wid} roots {[r['name'] for r in roots]} "
              f"orphans {orphans}")
        check({"intake", "feasibility", "marshal", "dispatch", "fetch", "device_solve",
               "launch_bind", "bind"} <= names,
              f"observability: window spans {sorted(names)}")
        missing = [n for n in registry.DEFAULT.registered()
                   if f"# HELP {registry.NAMESPACE}_{n} " not in text]
        check(not missing, f"observability: series without HELP {missing}")
        ring_series = {k: sum(series_delta(snap0, snap1, f"pipeline_ring_{k}_total").values())
                       for k in ("allocations", "refills", "reuses")}
        ring_counts = {k: ring1[k] - ring0[k] for k in ("allocations", "refills", "reuses")}
        check(ring_series == ring_counts,
              f"observability: ring series {ring_series} against counters {ring_counts}")

        # the tax by the JAX package's method (its bench.py config_7)
        over, slo_over = trace.measure_overhead(), slo.measure_overhead()
        tax = {"spans": n_spans, "span_ns": over["enabled_ns_per_span"],
               "disabled_span_ns": over["disabled_ns_per_span"],
               "slo_record_calls": calls, "record_ns": slo_over["enabled_ns_per_record"],
               "window_wall_s": rec["wall_s"],
               "trace_pct": n_spans * over["enabled_ns_per_span"] / 1e9 / rec["wall_s"] * 100,
               "slo_pct": calls * slo_over["enabled_ns_per_record"] / 1e9 / rec["wall_s"] * 100}

        walls = {"on": [], "off": []}
        for i in range(OBS_ALTERNATIONS):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                trace.reset()
                if mode == "on":
                    trace.enable()
                    slo.enable()
                else:
                    trace.disable()
                    slo.disable()
                r = run.window(config12_controller_pods(catalog, 416, f"a{i}{mode}"))
                check(r["pods_bound"] == rec["pods_bound"],
                      f"observability: {r['pods_bound']} bound ({mode}), "
                      f"{rec['pods_bound']} traced")
                walls[mode].append(r["wall_s"])
        trace.disable()
        slo.disable()
    finally:
        run.stop()
        trace.disable()
        trace.reset()
        slo.configure(enabled=was_slo)
        slo.reset()
    direct = {"alternations": OBS_ALTERNATIONS, "on_s": walls["on"], "off_s": walls["off"],
              "on_p50_s": p50(walls["on"]), "off_p50_s": p50(walls["off"]),
              "on_over_off": p50(walls["on"]) / p50(walls["off"])}

    ranges, entered, attempts = profiled_window(catalog, device)
    check(all(ranges[n]["ranges"] > 0 for n in entered + list(SOLVE_RANGES)),
          f"observability: ranges missing from the profile "
          f"{[n for n, r in ranges.items() if not r['ranges']]}")
    triggers = trigger_dumps()
    rec = {"phase": "observability", "pods": rec["pods"], "pods_bound": rec["pods_bound"],
           "window_id": wid,
           "spans": n_spans, "window_span_names": sorted(names),
           "slo_stages": {s: stages[s]["n"] for s in slo.STAGES},
           "series": len(registry.DEFAULT.registered()), "ring": ring_counts,
           "tax_jax_method": tax, "direct_ab": direct,
           "profile": {"attempts": attempts, "entered_spans": entered, "ranges": ranges,
                       "note": "device_ms counts what was launched inside a range, not "
                               "what it waited for"},
           "triggers": triggers}
    emit(rec)
    return rec


CONTROLLER_GROUPS = 24
CONTROLLER_WINDOWS = 3


def pending_pod(name, cpu_m, mem_mi, exprs, eni=False):
    """A pending pod the scheduler marked Unschedulable, asking for
    ``cpu_m`` millicores and ``mem_mi`` MiB (and one pod ENI with ``eni``),
    whose required node affinity is ``exprs``: (key, values) pairs, all In."""
    from karpenter_tpu_torch.api import core as c

    requests = {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}
    if eni:
        requests["vpc.amazonaws.com/pod-eni"] = "1"
    term = c.NodeSelectorTerm(match_expressions=[
        c.NodeSelectorRequirement(key=k, operator="In", values=v) for k, v in exprs])
    return c.Pod(
        metadata=c.ObjectMeta(name=name, uid=name),
        spec=c.PodSpec(containers=[c.Container(resources=c.ResourceRequirements.make(
            requests=requests))], affinity=c.Affinity(node_affinity=c.NodeAffinity(
                required=[term]))),
        status=c.PodStatus(conditions=[c.PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable")]))


def config12_controller_pods(catalog, per, prefix):
    """config_12's window as pending pods: group g's required node affinity
    is the g-th of config12_variants' first 24 (allowed, required) keys
    (capacity types, zones, type names; the arch and OS sets are the
    universe's), with an ENI request where the key requires one; ``per``
    pods a group cycling MIXED_SHAPES rotated by g."""
    from karpenter_tpu_torch.api import wellknown as wk

    pods = []
    for g, (allowed, required) in enumerate(config12_variants(catalog)[:CONTROLLER_GROUPS]):
        cts, zones, names = (sorted(s) for s in allowed[:3])
        exprs = [(wk.LABEL_CAPACITY_TYPE, cts), (wk.LABEL_TOPOLOGY_ZONE, zones),
                 (wk.LABEL_INSTANCE_TYPE, names)]
        r = g % len(MIXED_SHAPES)
        shapes = MIXED_SHAPES[r:] + MIXED_SHAPES[:r]
        pods += [pending_pod(f"{prefix}-g{g:02d}-{j:04d}", *shapes[j % len(shapes)], exprs,
                             eni=bool(required)) for j in range(per)]
    return pods


def config14_controller_pods(prefix):
    """config_14's window (12 schedules of one shape each, 10 + 7b mod 26
    pods, 270 in all) through node affinity, so the scheduler makes its 12
    schedules: group b requires zone bench-zone-{1 + b mod 3} and either all
    six types (b < 3) or all but the (b // 3)-th of the three dearest
    (gw-mid-24, gw-big-32, gw-big-48). Every group keeps the cheap types.
    On the port's CPU controller (the support controller reset first) the
    relaxation accepts groups 1, 4, 5, 6, 8 and 9: $135.06 → $118.24/h."""
    from karpenter_tpu_torch.api import wellknown as wk

    names = [it.name for it in config14_catalog()]
    type_lists = [names] + [[n for n in names if n != drop] for drop in names[3:]]
    shapes = [(1000, 2048), (2000, 4096), (500, 1024), (4000, 8192)]
    pods = []
    for b in range(12):
        exprs = [(wk.LABEL_TOPOLOGY_ZONE, [f"bench-zone-{1 + b % 3}"]),
                 (wk.LABEL_INSTANCE_TYPE, type_lists[b // 3])]
        pods += [pending_pod(f"{prefix}-gw{b:02d}-{j:02d}", *shapes[b % len(shapes)], exprs)
                 for j in range(10 + (b * 7) % 26)]
    return pods


def strip_prefix(binds):
    """Binds with each pod name's window prefix cut, so two windows of the
    same pods compare."""
    return [(t, tuple(n.split("-", 1)[1] for n in names)) for t, names in binds]


class ControllerRun:
    """The port's entry points over a fresh in-memory API server: a
    Provisioner reconciled by ProvisioningController over
    FakeCloudProvider(catalog), pods created in the API server and enqueued
    by SelectionController.reconcile, one call per pod, and the worker
    thread's passes. Every bind (instance type, sorted pod names) and every
    chunk's problems (through a wrapper of _prepare_chunk) are recorded.

    ``deployed`` keeps the controller exactly as a user gets it: the
    default Batcher (1 s idle, 10 s maximum) and the process-wide pressure
    monitor with its default config, and the collector left on. ``journal``
    is handed to the controller (every worker journals its mutations).
    Otherwise
    the run holds the window's shape fixed for the comparisons of runs
    1-4: the batcher's maximum is 120 s, the monitor keeps only its depth
    signal (which run 3 reads; the window-assembly signal starts at a
    minute and the RSS signal is off), and the collector is frozen over
    the reconcile loop (a full collection over the pods just stored can
    pause it past the 1 s idle window and split the window)."""

    def __init__(self, catalog, device, solver_config=None, pipeline_config=None,
                 deployed=False, nodes_become_ready=True, journal=None):
        from karpenter_tpu_torch.api.core import ObjectMeta
        from karpenter_tpu_torch.api.provisioner import Provisioner
        from karpenter_tpu_torch.api.wellknown import LABEL_INSTANCE_TYPE
        from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider
        from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
        from karpenter_tpu_torch.controllers.selection import SelectionController
        from karpenter_tpu_torch.pressure import (
            PressureConfig, PressureMonitor, get_monitor, set_monitor)
        from karpenter_tpu_torch.runtime.kubecore import KubeCore
        from karpenter_tpu_torch.scheduling.batcher import Batcher

        self.kube, self.deployed = KubeCore(), deployed
        if deployed:
            self.monitor = get_monitor()
        else:
            self.monitor = PressureMonitor(PressureConfig(
                rss_watermark_bytes=0, window_l1_seconds=60.0, window_l2_seconds=120.0))
        self.reset_records()

        def recording_batcher():
            # wrapped before the worker thread's first wait() begins
            batcher = Batcher() if deployed else Batcher(max_seconds=120.0, monitor=self.monitor)
            wait = batcher.wait

            def recording_wait():
                items, seconds = wait()
                if items:
                    self.batch_windows.append((len(items), seconds))
                return items, seconds

            batcher.wait = recording_wait
            return batcher

        self.provisioning = ProvisioningController(
            self.kube, FakeCloudProvider(catalog=catalog, nodes_become_ready=nodes_become_ready),
            solver_config=solver_config,
            pipeline_config=pipeline_config, device=device, batcher_factory=recording_batcher,
            journal=journal)
        self.selection = SelectionController(self.kube, self.provisioning)
        if not deployed:
            # selection's requeue backoff reads the process-wide monitor
            set_monitor(self.monitor)
        self.kube.create(Provisioner(metadata=ObjectMeta(name="default")))
        self.provisioning.reconcile("default")
        self.worker = self.provisioning.workers["default"]
        worker = self.worker
        bind, prepare, observe = worker._bind, worker._prepare_chunk, worker._observe_chunk

        def recording_bind(node, pods):
            err = bind(node, pods)
            self.binds.append((node.metadata.labels[LABEL_INSTANCE_TYPE],
                               tuple(sorted(p.metadata.name for p in pods))))
            self.t_last_bind = time.perf_counter()
            return err

        def recording_prepare(pods):
            prep = prepare(pods)
            self.problems.append(prep.problems)
            self.levels.append(int(self.monitor.level()))
            return prep

        def recording_observe(prep, stats):
            observe(prep, stats)
            self.chunks.append(worker._chunks[-1])

        worker._bind, worker._prepare_chunk = recording_bind, recording_prepare
        worker._observe_chunk = recording_observe

    def reset_records(self):
        self.binds, self.problems, self.levels, self.t_last_bind = [], [], [], None
        self.chunks, self.batch_windows = [], []

    def window(self, pods, timeout=600.0):
        """Create ``pods``, reconcile each, and wait until the worker has
        flushed every pod it took in. Returns the window's record: wall time
        (first reconcile → last bind) and its split, chunks, nodes, pods
        bound, launches and executor counts."""
        import gc

        import torch

        from karpenter_tpu_torch.ops import pack_cuda

        self.reset_records()
        for pod in pods:
            self.kube.create(pod)
        reset_counts()
        batcher = self.worker.batcher
        if not self.deployed:
            gc.freeze()
        try:
            t0 = time.perf_counter()
            for pod in pods:
                self.selection.reconcile(pod.metadata.name)
            t_enqueued = time.perf_counter()
            target, deadline = batcher.added_total, t0 + timeout
            check(target > 0, "controller: selection enqueued nothing")
            while batcher.processed_total < target:
                check(time.perf_counter() < deadline, "controller: the window never finished")
                with batcher._lock:
                    gate = batcher._gate
                    if batcher.processed_total >= target:
                        break
                gate.wait(timeout=0.05)
            torch.cuda.synchronize()
        finally:
            if not self.deployed:
                gc.unfreeze()
        lw, chunks = self.worker.last_window, self.chunks
        split = {k: sum(c[k] for c in chunks) for k in
                 ("schedule_s", "dispatch_s", "inflight_s", "fetch_s", "launch_bind_s")}
        bound = [n for _, names in self.binds for n in names]
        return {
            "pods": len(pods), "pods_bound": len(bound), "nodes": len(self.binds),
            "wall_s": (self.t_last_bind or time.perf_counter()) - t0,
            "reconcile_s": t_enqueued - t0,
            "batch_windows": [n for n, _ in self.batch_windows],
            "batch_window_s": sum(w for _, w in self.batch_windows),
            **split, "chunks": len(chunks), "chunk_pods": [c["pods"] for c in chunks],
            "pipeline": lw["pipeline"],
            "pressure_level": max([lw["pressure_level"], *self.levels]),
            "pack_batch_launches": pack_cuda.BATCH_LAUNCHES,
            "pack_chunk_launches": pack_cuda.LAUNCHES,
            "launches_per_chunk": (pack_cuda.BATCH_LAUNCHES + pack_cuda.LAUNCHES) / max(1, len(chunks)),
            "executor_counts": executor_counts(), "global_errors": self.worker.global_errors,
            "gang_windows": sum(1 for c in chunks if c["gang"])}

    def stop(self):
        from karpenter_tpu_torch.pressure import set_monitor

        thread = self.worker._thread
        self.provisioning.stop_all(timeout=30.0)
        if not self.deployed:
            set_monitor(None)
        check(not thread.is_alive(), "controller: the worker thread did not stop")


def p50(values):
    return sorted(values)[len(values) // 2]


def once_each(bound, pods, what):
    """Every pod bound exactly once, and nothing else bound."""
    from collections import Counter

    counts = Counter(bound)
    twice = [n for n, k in counts.items() if k > 1]
    check(not twice, f"{what}: pods bound twice: {twice[:3]}")
    check(set(counts) == set(pods), f"{what}: {len(set(pods) ^ set(counts))} pods "
          "bound that should not be, or not bound that should")


def node_multiset(results):
    """SolveResults as the nodes the fake provider launches for them: a
    Counter of (first instance type option, sorted pod names)."""
    from collections import Counter

    return Counter((p.instance_type_options[0].name, tuple(sorted(x.metadata.name for x in node)))
                   for r in results for p in r.packings for node in p.pods)


def phase_controller_deployed(device):
    """config_12's 9,984-pod window through the controller as a user
    deploys it, in a process of its own that holds nothing but the port
    (``chip_smoke.py --controller-deployed``): ProvisioningController's
    defaults (backend "global", the default pipeline, the default Batcher
    and pressure monitor, the collector on). Checks: every chunk at
    pressure level 0, one batcher window, every pod bound once (group 15's
    ENI pods stay Pending), the global leg run for every schedule on the
    card with no error, every problem answered by "device-batch", "device"
    or (a problem solved alone under 512 pods) "native". The process's
    resident set size is read at start, after the controller's construction
    and after the window, beside the monitor's watermark."""
    from karpenter_tpu_torch.pressure import get_monitor, read_rss_bytes

    rss = {"start": read_rss_bytes()}
    catalog = make_catalog(WINDOW_TYPES)
    run = ControllerRun(catalog, None, deployed=True)
    rss["constructed"] = read_rss_bytes()
    try:
        pods = config12_controller_pods(catalog, 416, "d")
        rec = run.window(pods)
        rss["after_window"] = read_rss_bytes()
        eni = {p.metadata.name for p in pods if "vpc.amazonaws.com/pod-eni"
               in p.spec.containers[0].resources.requests}
        once_each([n for _, g in run.binds for n in g],
                  [p.metadata.name for p in pods if p.metadata.name not in eni],
                  "deployed controller")
        counts = rec["executor_counts"]
        check(rec["pressure_level"] == 0 and set(run.levels) == {0},
              f"deployed controller: pressure level {rec['pressure_level']}, chunks at "
              f"{run.levels}, RSS {rss}, batcher windows {rec['batch_windows']}")
        check(rec["batch_windows"] == [len(pods)],
              f"deployed controller: batcher windows {rec['batch_windows']}")
        check(all(c["global"] for c in run.chunks) and counts.get("device-global", 0) >= 1
              and rec["global_errors"] == 0,
              f"deployed controller: the global leg ran for chunks "
              f"{[c['global'] for c in run.chunks]}, answered {counts}, "
              f"{rec['global_errors']} errors")
        # every default, the ring's gate too: a problem a chunk solves
        # alone under 512 pods is the native ring's
        check(set(counts) <= {"device-global", "device-batch", "device", "native"},
              f"deployed controller answered by {counts}")
    finally:
        run.stop()
    emit({"phase": "controller_deployed", **rec, "unschedulable": len(eni),
          "levels": run.levels, "rss_bytes": rss,
          "rss_watermark_bytes": get_monitor().config.rss_watermark_bytes})


def phase_controller(device):
    """The port's provisioning controller on the card, through its entry
    points (see ControllerRun), in five runs:

    0. the deployed controller (phase_controller_deployed), in a process
       of its own started first and run beside runs 1-4 (its device work
       is milliseconds, each process's host work holds one core); its
       record is checked and printed after run 4.
    1. config_12's window, 24 groups × 416 pods (9,984), backend "ffd",
       PipelineConfig(chunk_items=0) so one chunk holds the window; three
       windows. The first: every pod bound once (group 15's pods ask for a
       pod ENI no type offers: the solve leaves them unschedulable and they
       stay Pending), the nodes' (type, pods) multiset equal to solve_batch
       on the chunk's problems, each problem equal to solve_ffd_numpy, one
       pack_batch launch per chunk, every answered problem "device-batch";
       the kernel is rebuilt and launched on the worker thread.
    2. the same window with the default PipelineConfig (chunk 4096, depth 2,
       adaptive), one window; its binds equal, in order, those of a depth-1
       run with the same chunking; the realized overlap.
    3. 2,084 pods a group (50,016), the default config, once: every pod
       bound once.
    4. config_14's priced window (config14_controller_pods), backend
       "global", three windows: the accepted count and the composed fleet
       $/h equal the port's CPU controller on the same window, at least one
       schedule accepted, no global error, "device-global" counted; then
       KARPENTER_GLOBAL_SOLVE=0 gives the "ffd" backend's binds.

    One record a run: the window wall time (first reconcile → last bind;
    p50 over the windows) and its split, nodes, pods bound, chunks,
    launches per chunk, executor counts and the pressure level seen."""
    from karpenter_tpu_torch.pressure import read_rss_bytes

    t_phase = time.perf_counter()
    # files, not pipes: nothing reads the child's output until runs 1-4 end
    with tempfile.TemporaryFile("w+") as out_f, tempfile.TemporaryFile("w+") as err_f:
        deployed = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                     "--controller-deployed"], stdout=out_f, stderr=err_f)
        try:
            phase_controller_runs(device, t_phase)
            deployed.wait(timeout=600)
        finally:
            if deployed.poll() is None:
                deployed.kill()
                deployed.wait()
        out_f.seek(0)
        err_f.seek(0)
        out, err = out_f.read(), err_f.read()
    records = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check(deployed.returncode == 0 and records
          and records[-1].get("phase") == "controller_deployed",
          f"deployed controller: exit {deployed.returncode}: {err.strip()[-2000:]}")
    emit(records[-1])
    emit({"phase": "controller_total", "seconds": time.perf_counter() - t_phase,
          "rss_bytes": read_rss_bytes()})


def phase_controller_runs(device, t_phase):
    """Runs 1-4 of phase_controller, in this process."""
    import threading
    from collections import Counter

    import torch

    from karpenter_tpu_torch import build_dir
    from karpenter_tpu_torch.ops import global_solve as gops
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.solver import global_solve as gs
    from karpenter_tpu_torch.solver.batch_solve import solve_batch
    from karpenter_tpu_torch.solver.pipeline import PipelineConfig

    catalog = make_catalog(WINDOW_TYPES)
    ffd = card_config(window_backend="ffd")

    def emit_run(rec):
        emit({"phase": "controller", **rec})

    # run 1, with the kernel rebuilt and every launch traced to its thread
    threads, builds = [], []
    library, build, lib_dir = pack_cuda._library, pack_cuda.build, build_dir.PATH

    def traced_library():
        threads.append(threading.current_thread().name)
        return library()

    def traced_build():
        builds.append(threading.current_thread().name)
        return build()

    pack_cuda._library, pack_cuda.build = traced_library, traced_build
    build_dir.PATH, pack_cuda._LIB = lib_dir / "worker-thread", None
    run = ControllerRun(catalog, device, ffd, PipelineConfig(chunk_items=0))
    try:
        windows = []
        for w in range(CONTROLLER_WINDOWS):
            pods = config12_controller_pods(catalog, 416, f"w{w}")
            rec = run.window(pods)
            check(rec["chunks"] == 1 and len(run.problems) == 1,
                  f"controller run 1: {len(run.problems)} chunks, not one")
            check(rec["pack_batch_launches"] == 1 and rec["pack_chunk_launches"] == 0,
                  f"controller run 1: launches {rec['pack_batch_launches']}, "
                  f"{rec['pack_chunk_launches']} for one chunk")
            check(set(rec["executor_counts"]) == {"device-batch"},
                  f"controller run 1 answered by {rec['executor_counts']}")
            if w == 0:
                check(builds == [run.worker._thread.name] and pack_cuda.BUILD_SECONDS,
                      f"controller: the kernel was built on {builds}")
                launch_threads = sorted(set(threads))
                check(launch_threads == [run.worker._thread.name],
                      f"controller: the kernel was launched on {launch_threads}")
                problems = run.problems[0]
                counts = rec["executor_counts"]
                reset_counts()
                replay = solve_batch(problems, card_config(), device=device)
                check(executor_counts() == counts, "controller: replay answered otherwise")
                check(node_multiset(replay) == Counter(run.binds),
                      "controller: nodes differ from solve_batch on the same problems")
                for b, (prob, got) in enumerate(zip(problems, replay)):
                    # the unschedulable pods as a set: with no viable type the
                    # oracle lists them in input order, the device path in
                    # shape order
                    want = canonical(numpy_result(prob), prob.pods)
                    have = canonical(got, prob.pods)
                    check(have[:2] == want[:2] and sorted(have[2]) == sorted(want[2]),
                          f"controller: problem {b} != solve_ffd_numpy")
                unschedulable = {p.metadata.name for r in replay for p in r.unschedulable}
                once_each([n for _, g in run.binds for n in g],
                          [p.metadata.name for p in pods
                           if p.metadata.name not in unschedulable], "controller run 1")
                first = dict(rec, problems=len(problems), unschedulable=len(unschedulable),
                             launch_threads=launch_threads, build_threads=builds,
                             build_s=pack_cuda.BUILD_SECONDS)
            windows.append(rec)
    finally:
        pack_cuda._library, pack_cuda.build = library, build
        build_dir.PATH = lib_dir
        run.stop()
    emit_run({"run": "config12_one_chunk", "backend": "ffd", "windows": len(windows),
                    "wall_p50_s": p50([r["wall_s"] for r in windows]),
                    "walls_s": [r["wall_s"] for r in windows], "first": first,
                    "split_p50_s": {k: p50([r[k] for r in windows]) for k in
                                    ("reconcile_s", "batch_window_s", "schedule_s", "dispatch_s",
                                     "fetch_s", "launch_bind_s")},
                    "equal_to_solve_batch_and_numpy": True})

    # run 2: the default pipeline, and a depth-1 run of the same first window
    run = ControllerRun(catalog, device, ffd)
    try:
        rec = run.window(config12_controller_pods(catalog, 416, "w0"))
        check(set(rec["executor_counts"]) <= {"device-batch", "device"},
              f"controller run 2 answered by {rec['executor_counts']}")
        first_binds, windows = list(run.binds), [rec]
    finally:
        run.stop()
    serial = ControllerRun(catalog, device, ffd, PipelineConfig(depth=1, adaptive=False))
    try:
        serial_rec = serial.window(config12_controller_pods(catalog, 416, "w0"))
        check(serial.binds == first_binds,
              "controller run 2: depth 2 binds != depth 1 binds: "
              f"{len(first_binds)} against {len(serial.binds)} binds, chunks "
              f"{windows[0]['chunk_pods']} against {serial_rec['chunk_pods']}, first "
              f"difference at {next((i for i, (a, b) in enumerate(zip(first_binds, serial.binds)) if a != b), None)}")
    finally:
        serial.stop()
    emit_run({"run": "config12_default_pipeline", "backend": "ffd",
                    "windows": len(windows), "wall_s": windows[0]["wall_s"],
                    "overlap": windows[0]["pipeline"], "first": windows[0],
                    "depth1": {k: serial_rec[k] for k in ("wall_s", "pipeline", "chunks")},
                    "equal_to_depth1": True})

    # run 3: 50,016 pods once
    run = ControllerRun(catalog, device, ffd)
    try:
        pods = config12_controller_pods(catalog, 2084, "big")
        rec = run.window(pods)
        eni = {p.metadata.name for p in pods if "vpc.amazonaws.com/pod-eni"
               in p.spec.containers[0].resources.requests}
        once_each([n for _, g in run.binds for n in g],
                  [p.metadata.name for p in pods if p.metadata.name not in eni],
                  "controller run 3")
        check(set(rec["executor_counts"]) <= {"device-batch", "device"},
              f"controller run 3 answered by {rec['executor_counts']}")
    finally:
        run.stop()
    emit_run({"run": "config12_50k", "backend": "ffd", **rec, "unschedulable": len(eni)})

    # run 4: the global backend on config_14's window
    plans, dispatch = [], gs.dispatch_global_window

    def recording_dispatch(*args, **kwargs):
        handle = dispatch(*args, **kwargs)
        plans.append(handle)
        return handle

    gs.dispatch_global_window = recording_dispatch
    catalog14 = config14_catalog()
    try:
        def global_window(dev, prefix, config=card_config()):
            gops.SUPPORT.reset()
            plans.clear()
            r = ControllerRun(catalog14, dev, config)
            try:
                rec = r.window(config14_controller_pods(prefix))
                once_each([n for _, g in r.binds for n in g],
                          [p.metadata.name for p in config14_controller_pods(prefix)],
                          f"controller run 4 ({prefix})")
                plan = plans[0].fetch() if plans else None
                return rec, plan, strip_prefix(r.binds)
            finally:
                r.stop()

        def fleet(plan):
            return (plan.accepted, [i.reason for i in plan.infos],
                    sum(i.relax_cost_micro if res is not None else i.ffd_cost_micro
                        for i, res in zip(plan.infos, plan.results)),
                    sum(i.ffd_cost_micro for i in plan.infos))

        _, cpu_plan, _ = global_window(torch.device("cpu"), "cpu")
        check(cpu_plan is not None and cpu_plan.accepted >= 1,
              "controller run 4: the CPU run accepted no schedule")
        windows = []
        for w in range(CONTROLLER_WINDOWS):
            rec, plan, _ = global_window(device, f"g{w}")
            check(plan is not None and plan.executor == "device-global",
                  "controller run 4: the global leg did not run on the card")
            check(fleet(plan) == fleet(cpu_plan),
                  f"controller run 4: card {fleet(plan)[:1]} != CPU {fleet(cpu_plan)[:1]}")
            check(rec["global_errors"] == 0 and rec["executor_counts"].get("device-global") == 12,
                  f"controller run 4: {rec['global_errors']} errors, {rec['executor_counts']}")
            windows.append(rec)
        os.environ["KARPENTER_GLOBAL_SOLVE"] = "0"
        try:
            killed, killed_plan, killed_binds = global_window(device, "k")
        finally:
            del os.environ["KARPENTER_GLOBAL_SOLVE"]
        _, _, ffd_binds = global_window(device, "f", ffd)
        check(killed_plan is None and "device-global" not in killed["executor_counts"],
              "controller run 4: the kill switch did not stop the global leg")
        check(killed_binds == ffd_binds, "controller run 4: kill-switch binds != ffd binds")
    finally:
        gs.dispatch_global_window = dispatch
    accepted, _, composed, ffd_micro = fleet(cpu_plan)
    emit_run({"run": "config14_global", "backend": "global", "windows": len(windows),
                    "wall_p50_s": p50([r["wall_s"] for r in windows]),
                    "walls_s": [r["wall_s"] for r in windows], "first": windows[0],
                    "accepted": accepted, "reasons": [i.reason for i in cpu_plan.infos],
                    "ffd_cost_per_hour": ffd_micro / 1e6, "composed_cost_per_hour": composed / 1e6,
                    "card_equals_cpu": True, "kill_switch_equals_ffd": True})
    emit({"phase": "controller_runs", "seconds": time.perf_counter() - t_phase})


# -- the global window backend (B7) and the repack relaxation (B8) -----------

# card against CPU on the program's node counts: float32 sums in another order
# (the card's reduction trees, FMA contraction) over 300 steps;
# the JAX package's own XLA program and numpy mirror differ by up to 1.5e-4
# at a node count of 5.13 (tests/test_torch_global_solve.py)
PROGRAM_ATOL = PROGRAM_RTOL = 1e-4
# H100 SXM float32 outside the tensor cores, an FMA as two operations
# (the card's published peak)
FLOAT32_FLOPS = 67e12
GLOBAL_WARM_RUNS = 25


def config14_catalog():
    """config_14's six types (bench.py:1554-1616), offered on demand in three
    zones, whose price per cpu spreads 4x."""
    from karpenter_tpu_torch.cloudprovider.spi import Offering, make_instance_type

    def t(name, cpu, ratio, price):
        return make_instance_type(
            name=name, cpu=str(cpu), memory=f"{cpu * ratio}Gi", pods=str(min(110, cpu * 15)),
            offerings=[Offering("on-demand", f"bench-zone-{z + 1}") for z in range(3)],
            price=price)

    return [t("gw-small-8", 8, 4, 0.40), t("gw-small-12", 12, 4, 0.66),
            t("gw-mid-16", 16, 4, 1.92), t("gw-mid-24", 24, 4, 3.36),
            t("gw-big-32", 32, 4, 6.40), t("gw-big-48", 48, 4, 10.56)]


def config14_problems():
    """bench.py:1554-1616 (config_14): 12 schedules of one shape each, 10 to
    35 pods (270), over config14_catalog, so the node-count-minimal and
    cost-minimal fleets differ."""
    from karpenter_tpu_torch.solver.batch_solve import Problem
    from karpenter_tpu_torch.solver.solve import universe_constraints

    catalog = config14_catalog()
    shapes = [(1000, 2048), (2000, 4096), (500, 1024), (4000, 8192)]
    problems = []
    for b in range(12):
        pods = make_pods(10 + (b * 7) % 26, [shapes[b % len(shapes)]])
        for j, p in enumerate(pods):
            p.metadata.name = f"gw{b}-{j}"
        problems.append(Problem(constraints=universe_constraints(catalog), pods=pods,
                                instance_types=catalog))
    return problems


def program_bound(win):
    """Least time of the program on this window: the larger of its bytes
    (every input, x0 included, read once, n written once) over HBM bandwidth
    and its float32 operations over the float32 peak. Operations per step,
    over the live cells C = sum of S*T per row, the live types TT and shapes
    SS, and the R resources some shape uses: the two products 2*C*R each,
    the over term 3*TT*R, short C + SS, the gradient's combine 3*C and its
    n part 2*TT*R + 2*TT, the two projected updates 4*C and 4*TT. Also the
    bound of an eager program that keeps x in HBM (x read and written once
    a step)."""
    from karpenter_tpu_torch.solver.global_solve import ITERS, used_resources

    iters = ITERS
    B, SB, TB = win.b, win.sb, win.tb
    shapes_per_row = (win.d_counts > 0).sum(axis=1)
    C = int((shapes_per_row * win.d_types).sum())
    TT, SS = int(win.d_types.sum()), int(shapes_per_row.sum())
    R = len(used_resources(win))
    flops = iters * (C * (4 * R + 8) + TT * (5 * R + 6) + SS)
    nbytes = 4 * (win.d_shapes.size + win.d_counts.size + win.d_caps.size + win.d_prices.size
                  + win.d_tmask.size + win.d_n0.size + win.d_types.size + B * SB * TB + B * TB)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FLOAT32_FLOPS
    return {"bytes": nbytes, "flops": flops, "live_cells": C, "resources": R,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "eager_state_bound_ms": iters * 8 * B * SB * TB / HBM_BYTES_PER_S * 1e3}


def device_launches(fn):
    """One call of ``fn`` under torch.profiler: the kernels the card ran and
    the copies and sets apart, the device's busy time (the union of their
    intervals), the call's time from CUDA events under the profiler, and
    the device's idle share of that time; None where the profiler saw
    nothing. A first profiled call is made and dropped: the first session
    of a process spends ~0.3 s starting the profiler inside the call's
    events, and the first one after the deprovision phase's threads
    reported half the kernels of the calls after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    spans = device_events(prof)
    if not spans:
        return None
    copies = sum(1 for *_, n in spans if n.startswith(("Memcpy", "Memset")))
    call_ms = start.elapsed_time(end)
    busy_ms = busy_us(spans) / 1e3
    return {"kernels": len(spans) - copies, "copies_and_sets": copies,
            "kernel_ms": sum(e - b for b, e, _ in spans) / 1e3,
            "device_busy_ms": busy_ms, "profiled_call_ms": call_ms,
            "idle_share": 1.0 - busy_ms / call_ms}


def program_record(inputs_d, inputs_c, tb, timed_runs):
    """One program on the card and on the CPU from the same inputs: the
    program runs of the card's compared call (the run counter set to 0
    just before it), the card's time (CUDA events over warm runs), its
    launches and device-busy time, the CPU's time, and both node-count
    arrays."""
    import torch

    from karpenter_tpu_torch.solver import global_solve as gs

    gs.RUNS = 0
    n_card = gs.run_program(inputs_d, tb).cpu().numpy()
    runs = gs.RUNS
    t0 = time.perf_counter()
    n_cpu = gs.run_program(inputs_c, tb).numpy()
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    ms = cuda_ms(lambda: gs.run_program(inputs_d, tb), timed_runs)
    launches = device_launches(lambda: gs.run_program(inputs_d, tb))
    torch.cuda.synchronize()
    return n_card, n_cpu, {"runs": runs, "ms": ms, "cpu_ms": cpu_ms,
                           "launches_per_call": launches}


def support_flips(win, n_card, n_cpu):
    """Rows whose strict or widened support differs between two node-count
    arrays, each with both supports' sizes and the flipped types' n."""
    from karpenter_tpu_torch.ops.global_solve import (
        support_positions, widened_support_positions,
    )

    flips = []
    for s in win.live:
        for rule in (support_positions, widened_support_positions):
            a = rule(n_card[s.row], s.num_types)
            b = rule(n_cpu[s.row], s.num_types)
            if a != b:
                flipped = sorted(set(a) ^ set(b))
                flips.append({"schedule": s.pos, "rule": rule.__name__,
                              "card": len(a), "cpu": len(b),
                              "n_card": [float(n_card[s.row][t]) for t in flipped[:8]],
                              "n_cpu": [float(n_cpu[s.row][t]) for t in flipped[:8]]})
    return flips


def phase_global_program(device):
    """The relaxation program (B7) on the encoding of config_12's 9,984-pod
    window (B = 32, SB = 32, TB = 512) on the card and on the CPU: node
    counts within the stated tolerance, equal supports row for row, the
    card's time, launches, device-busy time and bound, and the TF32 flags.
    The card's runs have TF32 turned on: the program uses no matmul, so
    the flag must change nothing (the CPU ignores it)."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.models.cost import CostConfig
    from karpenter_tpu_torch.ops.global_solve import encode_window, support_positions
    from karpenter_tpu_torch.solver.global_solve import ITERS, program_inputs

    catalog = make_catalog(WINDOW_TYPES)
    problems = window_problems(catalog, 416)
    t0 = time.perf_counter()
    win = encode_window(problems, CostConfig())
    encode_s = time.perf_counter() - t0
    check((win.b, win.sb, win.tb) == (32, 32, 512),
          f"global_program: buckets {(win.b, win.sb, win.tb)}, expected (32, 32, 512)")
    cpu = torch.device("cpu")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        tf32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                "float32_matmul_precision": torch.get_float32_matmul_precision()}
        n_card, n_cpu, timing = program_record(program_inputs(win, device),
                                               program_inputs(win, cpu), win.tb, 5)
        check(torch.backends.cuda.matmul.allow_tf32 is True,
              "global_program: the program changed the TF32 flag")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    check(timing["runs"] == 1, f"global_program: {timing['runs']} program runs, expected 1")
    check(bool(np.all(np.isfinite(n_card))), "global_program: the card's n is not finite")
    check(bool(np.all(np.isfinite(n_cpu))), "global_program: the CPU's n is not finite")
    err = float(np.abs(n_card - n_cpu).max())
    rel = float((np.abs(n_card - n_cpu) / np.maximum(np.abs(n_cpu), 1e-6)).max())
    check(bool(np.allclose(n_card, n_cpu, atol=PROGRAM_ATOL, rtol=PROGRAM_RTOL)),
          f"global_program: card and CPU node counts differ by {err}")
    flips = support_flips(win, n_card, n_cpu)
    rec = {"phase": "global_program", "schedules": len(problems),
           "pods": sum(len(p.pods) for p in problems), "types": len(catalog),
           "b": win.b, "sb": win.sb, "tb": win.tb, "cells": win.cells, "iters": ITERS,
           "encode_s": encode_s, "max_abs_err": err, "max_rel_err": rel,
           "tolerance": {"atol": PROGRAM_ATOL, "rtol": PROGRAM_RTOL},
           "n_max": float(n_cpu.max()), "support_flips": len(flips), "flips": flips,
           "supports": [len(support_positions(n_card[s.row], s.num_types))
                        for s in win.live],
           "tf32_on_card_runs": tf32,
           **timing, **program_bound(win)}
    emit(rec)
    check(not flips, f"global_program: {len(flips)} support flips between card and CPU")
    return rec


def host_plan(result, s):
    """An accepted SolveResult back in the schedule's host ids (pod ids,
    sorted-type indices ascending, so the first option is the type the
    rounding packed), for verify_plan and plan_cost_micro."""
    from karpenter_tpu_torch.solver.host_ffd import HostPacking, HostSolveResult

    pod_index = {id(p): i for i, p in enumerate(s.pods)}
    type_index = {id(it): j for j, it in enumerate(s.sorted_types)}
    return HostSolveResult(
        packings=[HostPacking(pod_ids=[[pod_index[id(p)] for p in node] for node in pk.pods],
                              instance_type_indices=sorted(type_index[id(it)]
                                                           for it in pk.instance_type_options),
                              node_quantity=pk.node_quantity) for pk in result.packings],
        unschedulable=[pod_index[id(p)] for p in result.unschedulable])


def check_plan(plan, win, what):
    """Every accepted plan passes verify_plan, holds each pod of its
    schedule exactly once, costs what its info says and is strictly cheaper
    in int micro-$; every decline has no result; no schedule that reached
    the program declines with an error."""
    from karpenter_tpu_torch.ops.global_solve import plan_cost_micro, verify_plan

    for s, info, result in zip(win.scheds, plan.infos, plan.results):
        check(info.reason != "fallback-error", f"{what}: schedule {s.pos} fallback-error")
        if result is None:
            check(not info.used, f"{what}: schedule {s.pos} used without a plan")
            continue
        hp = host_plan(result, s)
        check(verify_plan(dict(zip(s.pod_ids, s.pod_vecs)),
                          {p.index: p for p in s.packables}, hp),
              f"{what}: schedule {s.pos}'s plan fails verify_plan")
        check(sorted(i for pk in hp.packings for node in pk.pod_ids for i in node)
              == list(range(len(s.pods))) and not hp.unschedulable,
              f"{what}: schedule {s.pos} does not hold each pod once")
        check(plan_cost_micro(hp, s.prices_micro) == info.relax_cost_micro
              < info.ffd_cost_micro, f"{what}: schedule {s.pos} is not strictly cheaper")


def verdicts(plan):
    return [(i.used, i.reason, i.support, i.widened, i.relax_cost_micro, i.ffd_cost_micro)
            for i in plan.infos]


def phase_global_window(device):
    """config_14's window as the controller runs it: dispatch_batch and
    dispatch_global_window, both fetches, every accepted plan in place of
    its FFD result. Checks the plans, the untouched declines, the verdicts
    against the port's CPU run of the same window and the executor; times
    solve_window_global over warm runs; and holds relax_pack (B8) on one
    schedule to its CPU run."""
    import torch

    from karpenter_tpu_torch.ops import global_solve as gops
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.ops.global_solve import encode_window, plan_cost_micro
    from karpenter_tpu_torch.solver import global_solve as gs
    from karpenter_tpu_torch.solver import relax
    from karpenter_tpu_torch.solver.batch_solve import dispatch_batch

    problems = config14_problems()
    config = card_config()
    win = encode_window(problems, config.cost_config)
    gops.SUPPORT.reset()
    reset_counts()
    t0 = time.perf_counter()
    batch = dispatch_batch(problems, config, device=device)         # the main path
    glob = gs.dispatch_global_window(problems, config, device=device)
    ffd = batch.fetch()
    plan = glob.fetch()
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1000.0
    runs, batch_launches = gs.RUNS, pack_cuda.BATCH_LAUNCHES
    check(runs == 1 and batch_launches > 0,
          f"global_window: program runs {runs}, pack_batch launches {batch_launches}")
    check(plan.executor == "device-global", f"global_window: executor {plan.executor}")
    check(executor_counts() == {"device-batch": 12, "device-global": 12},
          f"global_window answered by {executor_counts()}")
    before = [canonical(r, p.pods) for r, p in zip(ffd, problems)]
    composed = [g if g is not None else f for g, f in zip(plan.results, ffd)]
    for i, (g, f, c) in enumerate(zip(plan.results, ffd, composed)):
        if g is None:
            check(c is f and canonical(c, problems[i].pods) == before[i],
                  f"global_window: the decline of schedule {i} touched its FFD result")
    check_plan(plan, win, "global_window")
    # the batch's FFD plan costs what the rounding's baseline costs
    for s, f, info in zip(win.scheds, ffd, plan.infos):
        check(plan_cost_micro(host_plan(f, s), s.prices_micro) == info.ffd_cost_micro,
              f"global_window: schedule {s.pos}'s FFD cost differs from the baseline")
    gops.SUPPORT.reset()
    cpu_plan = gs.solve_window_global(problems, config, device="cpu")
    check(verdicts(cpu_plan) == verdicts(plan), "global_window: card and CPU verdicts differ")
    ffd_micro = sum(i.ffd_cost_micro for i in plan.infos)
    composed_micro = sum(i.relax_cost_micro if r is not None else i.ffd_cost_micro
                         for i, r in zip(plan.infos, plan.results))

    times = []
    gops.SUPPORT.reset()
    for _ in range(GLOBAL_WARM_RUNS):
        t0 = time.perf_counter()
        p = gs.solve_window_global(problems, config, device=device)
        times.append((time.perf_counter() - t0) * 1000.0)
        check(p.executor == "device-global", "warm global windows: executor")
    times.sort()

    # B8: relax_pack on the card and on the CPU, on the largest schedule
    # whose repack the CPU accepts (else the largest)
    on_cpu = {s.pos: relax.relax_pack(s.pod_vecs, s.pod_ids, s.packables, s.prices,
                                      device="cpu") for s in win.live}
    s = max(win.live, key=lambda x: (on_cpu[x.pos][1].used, len(x.pods)))
    rp_cpu, info_cpu = on_cpu[s.pos]
    gs.RUNS = 0
    rp_card, info_card = relax.relax_pack(s.pod_vecs, s.pod_ids, s.packables, s.prices,
                                          device=device)
    check(gs.RUNS == 1, "relax_pack: the program did not run")
    key = lambda i: (i.used, i.reason, i.support, i.relax_cost, i.ffd_cost)  # noqa: E731
    check(key(info_card) == key(info_cpu), f"relax_pack: {key(info_card)} != {key(info_cpu)}")
    check([(p.instance_type_indices, p.pod_ids) for p in rp_card.packings]
          == [(p.instance_type_indices, p.pod_ids) for p in rp_cpu.packings],
          "relax_pack: card and CPU plans differ")
    b8 = relax_program_record(s, device)
    rec = {"phase": "global_window", "schedules": len(problems),
           "pods": sum(len(p.pods) for p in problems), "types": len(problems[0].instance_types),
           "executor": plan.executor, "accepted": plan.accepted,
           "reasons": [i.reason for i in plan.infos], "supports": [i.support for i in plan.infos],
           "ffd_cost_per_hour": ffd_micro / 1e6, "composed_cost_per_hour": composed_micro / 1e6,
           "saving_pct": 100.0 * (ffd_micro - composed_micro) / ffd_micro,
           "ffd_nodes": sum(r.node_count for r in ffd),
           "composed_nodes": sum(r.node_count for r in composed),
           "program_runs": runs, "pack_batch_launches": batch_launches,
           "card_equals_cpu": True,
           "controller_window_ms": window_ms, "program_ms": glob.program_ms,
           "warm_runs": len(times), "p50_ms": times[len(times) // 2],
           "p99_ms": times[min(len(times) - 1, int(0.99 * len(times)))],
           "relax_pack": {"schedule": s.pos, "pods": len(s.pods), "used": info_card.used,
                          "reason": info_card.reason, "support": info_card.support,
                          "relax_cost": info_card.relax_cost, "ffd_cost": info_card.ffd_cost,
                          "card_equals_cpu": True, **b8}}
    emit(rec)
    return rec


def relax_program_record(s, device):
    """B8's program alone on schedule ``s`` (B = 1, unpadded), as relax_pack
    runs it, on the card and on the CPU: time, launches, bound."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops.encode import encode
    from karpenter_tpu_torch.ops.global_solve import objective_prices, one_problem_window
    from karpenter_tpu_torch.solver.global_solve import ITERS, program_inputs

    enc = encode(s.pod_vecs, s.pod_ids, s.packables, pad=False)
    one = one_problem_window(enc, objective_prices([s.prices_micro[p.index]
                                                    for p in s.packables]))
    n_card, n_cpu, rec = program_record(program_inputs(one, device),
                                        program_inputs(one, torch.device("cpu")), one.tb, 20)
    check(bool(np.allclose(n_card, n_cpu, atol=PROGRAM_ATOL, rtol=PROGRAM_RTOL)),
          "relax program: card and CPU node counts differ")
    return {"b": 1, "sb": one.sb, "tb": one.tb, "max_abs_err": float(np.abs(n_card - n_cpu).max()),
            **rec, **program_bound(one)}


def phase_global_window_400(device, runs=1):
    """config_12's 9,984-pod window (24 schedules over 400 types) through
    the global backend: the time split (encode, program on the card, wait
    and copy back, host rounding, total) and the verdicts by reason. The
    supports were held against the CPU's on this encoding by
    global_program; the rounding is not repeated on the CPU."""
    import collections

    from karpenter_tpu_torch.ops import global_solve as gops
    from karpenter_tpu_torch.solver import global_solve as gs

    catalog = make_catalog(WINDOW_TYPES)
    problems = window_problems(catalog, 416)
    out = []
    for _ in range(runs):
        gops.SUPPORT.reset()
        reset_counts()
        handle = gs.dispatch_global_window(problems, device=device)
        plan = handle.fetch()
        check(gs.RUNS == 1 and plan.executor == "device-global",
              f"global_window_400: runs {gs.RUNS}, executor {plan.executor}")
        check(executor_counts() == {"device-global": len(problems)},
              f"global_window_400 answered by {executor_counts()}")
        check_plan(plan, handle.win, "global_window_400")
        out.append({"encode_s": handle.encode_seconds,
                    "dispatch_s": handle.dispatch_seconds,
                    "program_ms": handle.program_ms, "fetch_wait_s": handle.fetch_seconds,
                    "round_s": handle.round_seconds, "total_s": plan.seconds,
                    "accepted": plan.accepted,
                    "reasons": dict(collections.Counter(i.reason for i in plan.infos)),
                    "supports": sorted(collections.Counter(
                        i.support for i in plan.infos).items())})
    rec = {"phase": "global_window_400", "schedules": len(problems),
           "pods": sum(len(p.pods) for p in problems), "types": len(catalog),
           "executor": "device-global", "runs": out}
    emit(rec)
    return rec


# -- consolidation: the what-if kernel (B9) and node removal ----------------

# (NB, KB, BB) of the what-if fuzz: from the smallest bucket to the largest
# window MAX_WINDOW_CELLS admits (BB = 2**22 at NB = KB = 4); BB = 4096 is
# the last whose free rows fit a block's shared memory, 8192 the first that
# takes the global scratch
WHATIF_FUZZ = [(4, 4, 4), (8, 4, 16), (16, 8, 64), (64, 16, 512), (512, 4, 512),
               (128, 64, 1024), (32, 32, 4096), (16, 8, 8192), (4, 4, 1 << 22)]
# (NB, KB, BB, kind) at the edges of the staged kernel's design, drawn
# after WHATIF_FUZZ from the same generator (whatif_case's ``kind``): BB at
# each geometry boundary (one run, one group of 32 runs, two and four
# groups, the first global bucket); "edges" puts own bins on word edges,
# folds resources (all of a candidate's pods 0 on a resource whose free
# value is negative on some bins), gives one candidate all-zero vectors
# and some five to eight active resources; "scattered" valid flags at
# KB = 128 (four chunks of 32 through two buffers); "one_long" a window
# whose longest candidate is its only long one; "misaligned" compat at an
# odd address (the byte-load packing); KB = 1024 at BB = 16 (32 chunks,
# bins below one block); "replicas" runs of the same pod (the stepping
# warp's run path)
WHATIF_EDGE_FUZZ = [(64, 8, 32, "edges"), (64, 16, 1024, "edges"), (32, 16, 2048, "edges"),
                    (16, 16, 4096, "edges"), (16, 8, 8192, "edges"),
                    (64, 128, 1024, "scattered"), (64, 128, 256, "one_long"),
                    (32, 32, 1024, "misaligned"), (8, 1024, 16, "edges"),
                    (64, 128, 1024, "replicas"), (128, 64, 128, "replicas")]
# config_5's steady-state window (bench.py:417-560)
WHATIF_W, WHATIF_FULL, WHATIF_RECV = 384, 1592, 24
# the deprovision phase: config_4's pods, the share labelled web and db, the
# share of pods and of nodes the scale-down deletes, the windows, the TTL
DEPROVISION_PODS, WEB_SHARE, DB_SHARE = 50_000, 0.10, 0.02
SCALE_DOWN_PODS, SCALE_DOWN_NODES = 0.50, 0.03
CONSOLIDATION_WINDOWS, EMPTY_TTL = 3, 30


def whatif_case(rng, NB, KB, BB, device, kind=None):
    """A random window in the kernel's ABI: pods over cpu, memory, the pod
    slot and sometimes a fourth resource; free rows that may be negative;
    valid as a prefix per candidate (encode_window's layout) with some rows
    all invalid and some scattered; compat at a random density with some
    all-zero rows; own bins anywhere or -1. Candidate 0 is the
    fail-then-place case: its first pod fits nowhere and its second fits
    bin 1, so the scan must go on past the failure and place it. ``kind``
    (WHATIF_EDGE_FUZZ) adds the edges of the staged kernel's design, with
    draws after the base ones, so a case without it is the same window as
    before."""
    import numpy as np
    import torch

    R = 8
    tight = BB >= 8192  # long scans: most bins fit no pod
    pods = np.zeros((NB, KB, R), np.int64)
    pods[:, :, 0] = rng.integers(1, 400, (NB, KB))
    pods[:, :, 1] = rng.integers(1, 400, (NB, KB))
    pods[:, :, 2] = 1
    pods[:, :, 3] = rng.integers(0, 3, (NB, KB)) * (rng.random((NB, KB)) < 0.2)
    free0 = np.zeros((BB, R), np.int64)
    free0[:, 0] = rng.integers(-200, 440 if tight else 1200, BB)
    free0[:, 1] = rng.integers(-200, 440 if tight else 1200, BB)
    free0[:, 2] = rng.integers(-1, 6, BB)
    free0[:, 3] = rng.integers(0, 4, BB)
    valid = np.arange(KB)[None, :] < rng.integers(0, KB + 1, NB)[:, None]
    scattered = rng.random(NB) < 0.2
    valid[scattered] = rng.random((int(scattered.sum()), KB)) < 0.5
    valid[rng.random(NB) < 0.1] = False
    compat = rng.random((NB, KB, BB), dtype=np.float32) < rng.choice([0.3, 0.7, 1.0])
    compat[rng.random(NB) < 0.1] = False
    cand_bin = rng.integers(-1, BB, NB)
    cand_bin[rng.random(NB) < 0.2] = -1
    if kind == "edges":
        # own bins on word edges (candidate 0 keeps -1)
        for c, b in zip(range(1, NB), (31, 32, 1023, BB - 1, 0)):
            cand_bin[c] = b if b < BB else -1
        # folds: resource 3 negative on some bins while a third of the
        # candidates ask 0 of it; resource 6 negative on some bins, asked
        # by no pod; resources 4-7 asked by some candidates (5 to 8
        # active), one candidate's vectors all 0
        free0[:, 3] = rng.integers(-1, 4, BB)
        free0[:, 6] = -(rng.random(BB) < 0.05).astype(np.int64)
        free0[:, 4:6] = rng.integers(-1, 40, (BB, 2))
        free0[:, 7] = rng.integers(0, 40, BB)
        pods[rng.random(NB) < 0.33, :, 3] = 0
        wide = rng.random(NB) < 0.2
        for r in (4, 5, 7):
            pods[wide, :, r] = rng.integers(0, 3, (int(wide.sum()), KB))
        pods[NB - 1] = 0
        pods[0, :, 3:] = 0
        free0[1, 3:] = np.maximum(free0[1, 3:], 0)
    elif kind == "scattered":
        valid = rng.random((NB, KB)) < 0.5
    elif kind == "one_long":
        valid = np.arange(KB)[None, :] < rng.integers(0, 5, NB)[:, None]
        valid[NB // 2] = True
    elif kind == "replicas":
        # runs of the same pod (a Deployment's replicas): three shapes a
        # candidate, sorted descending as encode_window sorts, compat the
        # same along a run but on some candidates, free rows that fill,
        # and some candidates whose pods fit nowhere
        shapes = np.stack([rng.integers(1, 120, (NB, 3)), rng.integers(1, 120, (NB, 3))], -1)
        pick = np.sort(rng.integers(0, 3, (NB, KB)), axis=1)
        pods[:, :, :2] = np.take_along_axis(shapes, pick[:, :, None], 1)
        pods[:, :, :2] = -np.sort(-pods[:, :, :2], axis=1)
        pods[:, :, 3] = 0
        compat[:] = True
        mixed = rng.random(NB) < 0.3
        compat[mixed] = rng.random((int(mixed.sum()), KB, BB)) < 0.8
        free0[:, :2] = rng.integers(-50, 600, (BB, 2))
        free0[:, 2] = rng.integers(-1, 12, BB)
        pods[rng.random(NB) < 0.1, :, 0] *= 50  # runs that fit nowhere
    # the fail-then-place candidate
    pods[0, 0, :2] = 10**6
    pods[0, 1, :4] = (1, 1, 1, 0)
    valid[0, :2] = True
    compat[0, 1, :] = True
    compat[0, 1, 0] = False
    free0[1, :3] = (10**5, 10**5, 10)
    cand_bin[0] = -1
    out = [torch.from_numpy(pods.astype(np.int32)), torch.from_numpy(valid),
           torch.from_numpy(compat), torch.from_numpy(free0.astype(np.int32)),
           torch.from_numpy(cand_bin.astype(np.int32))]
    out = [t.to(device) for t in out]
    if kind == "misaligned":
        # compat one byte past an aligned address: no 16-byte loads
        flat = torch.empty(compat.size + 1, dtype=torch.bool, device=device)
        flat[1:] = out[2].reshape(-1)
        out[2] = flat[1:].view(NB, KB, BB)
    return out


def whatif_diff(a, b):
    """Feasible flips plus the largest slot difference between two
    (feasible, slots) answers: 0 when they are the same bit for bit."""
    flips = int((a[0] != b[0]).sum())
    slots = int((a[1].long() - b[1].long()).abs().max()) if a[1].numel() else 0
    return flips + slots


def phase_whatif_fuzz(device):
    """whatif_scan against whatif_scan_plain on the same card tensors, bit
    for bit, over seeded random windows (WHATIF_FUZZ, then the design's
    edges, WHATIF_EDGE_FUZZ): the staged kernel up to BB = 4096, the
    global one from 8192."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import whatif_cuda as wc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cases, launches0, worst = [], wc.LAUNCHES, 0
    for NB, KB, BB, kind in [(*c, None) for c in WHATIF_FUZZ] + WHATIF_EDGE_FUZZ:
        args = whatif_case(rng, NB, KB, BB, device, kind)
        plain = wc.whatif_scan_plain(*args)
        got = wc.whatif_scan(*args)
        torch.cuda.synchronize()
        err = whatif_diff(got, plain)
        worst = max(worst, err)
        what = f"whatif fuzz {NB}x{KB}x{BB}" + (f" {kind}" if kind else "")
        check(err == 0, f"{what}: kernel != plain")
        check(not bool(plain[0][0]) and int(plain[1][0, 1]) == 1,
              f"{what}: the fail-then-place candidate gave "
              f"{bool(plain[0][0])}, {plain[1][0, :2].tolist()}")
        cases.append({"nb": NB, "kb": KB, "bb": BB, "kind": kind,
                      "kernel": wc.launch_geometry(BB)["kernel"],
                      "feasible": int(plain[0].sum()), "placed": int((plain[1] >= 0).sum())})
        del args, plain, got
        torch.cuda.empty_cache()
    rec = {"phase": "whatif_fuzz", "cases": cases, "launches": wc.LAUNCHES - launches0,
           "max_abs_err": worst, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def whatif_window_fleet():
    """config_5's steady-state consolidation window (bench.py:417-560):
    WHATIF_W near-full candidates (a DaemonSet filler leaves 850m free,
    three movable 250m pods ride on top), WHATIF_FULL full bins (100m free)
    and WHATIF_RECV empty receivers, all of the 100-type catalog's largest
    type. Returns (nodes, pods by node name, that type)."""
    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.core import (
        Node, NodeSpec, NodeStatus, ObjectMeta, OwnerReference)
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    big = max(make_catalog(100), key=lambda it: it.cpu.nano)

    def mk_node(name):
        return Node(
            metadata=ObjectMeta(name=name, namespace="", labels={
                wk.LABEL_INSTANCE_TYPE: big.name, wk.LABEL_CAPACITY_TYPE: "on-demand",
                wk.PROVISIONER_NAME_LABEL: "bench"}),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=parse_resource_list({
                "cpu": str(big.cpu), "memory": str(big.memory), "pods": str(big.pods)})))

    ds = OwnerReference(api_version="apps/v1", kind="DaemonSet", name="filler", uid="ds")
    fill_m = (big.cpu.nano - 100 * 10**6) // 10**6
    cand_fill_m = (big.cpu.nano - 850 * 10**6) // 10**6

    def mk_pods(prefix, shapes, owner=None):
        out = []
        for j, (c, m) in enumerate(shapes):
            p = make_pods(1, [(c, m)])[0]
            p.metadata.name = f"{prefix}-{j}"
            if owner is not None:
                p.metadata.owner_references = [owner]
            out.append(p)
        return out

    nodes, pods_by = [], {}
    for i in range(WHATIF_W):
        nodes.append(mk_node(f"cand-{i}"))
        pods_by[f"cand-{i}"] = (mk_pods(f"cfill-{i}", [(cand_fill_m, 128)], owner=ds)
                                + mk_pods(f"mv-{i}", [(250, 256)] * 3))
    for i in range(WHATIF_FULL):
        nodes.append(mk_node(f"full-{i}"))
        pods_by[f"full-{i}"] = mk_pods(f"fill-{i}", [(fill_m, 128)], owner=ds)
    for i in range(WHATIF_RECV):
        nodes.append(mk_node(f"recv-{i}"))
        pods_by[f"recv-{i}"] = []
    return nodes, pods_by, big


def fresh_bins(bins):
    """Copies of a window's bins with their own free vectors."""
    from karpenter_tpu_torch.models.consolidate import _Bin

    return [_Bin(name=b.name, free=list(b.free), labels=b.labels, taints=b.taints)
            for b in bins]


def replay_drains(plan, enc):
    """Every action of a plan replayed as a fresh place_onto commit sequence
    on the bins that survive it (drained bins drop out as the replay goes
    on), and no drained bin among the bins that received pods in the same
    window. Returns (actions that do not replay, drained bins that
    received)."""
    from karpenter_tpu_torch.models.consolidate import place_onto

    vbins = fresh_bins(enc.bins)
    drained, unverified = set(), 0
    for action in plan.actions:
        surviving = [b for j, b in enumerate(vbins) if j != action.bin and j not in drained]
        movable = [p for _, p in enc.cand_pods[action.cand]]
        if place_onto(movable, surviving, commit=True) is None:
            unverified += 1
        else:
            drained.add(action.bin)
    received = {b for a in plan.actions for b in a.placements}
    return unverified, len(received & set(plan.drained_bins))


def whatif_bound(enc, tensors):
    """Least time for one window: the larger of the bytes the scan must
    move over HBM bandwidth and its operations over the op rate, both
    over the live cells, not the padding the kernel skips. Bytes: for each
    valid pod of each candidate, its pod vector (R int32), its valid flag,
    its compat row over the kept bins (a byte a bin) and its slot; for each
    candidate, its own bin and its verdict; free0 over the kept bins.
    Operations: each valid pod against every kept bin, R compares, the
    compat test and the own-bin test. A candidate's KB-step serial chain
    cannot use that rate."""
    R = tensors[0].shape[2]
    pods, kept, cands = sum(len(p) for p in enc.cand_pods), len(enc.kept), len(enc.cand_pods)
    nbytes = pods * (R * 4 + 1 + kept + 4) + cands * (4 + 1) + kept * R * 4
    ops = pods * kept * (R + 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def replica_share(enc):
    """The share of a window's valid pods that are the same pod (reserve
    vector and compat row over the bins) as the valid pod before them in
    their candidate: the runs of replicas the what-if kernel places without
    a search."""
    import numpy as np

    pods, valid, compat = enc.d_pods, enc.d_valid, enc.d_compat
    same = total = 0
    for i in range(enc.n):
        ks = np.flatnonzero(valid[i])
        total += len(ks)
        if len(ks) > 1:
            a, b = ks[1:], ks[:-1]
            same += int(((pods[i, a] == pods[i, b]).all(1)
                         & (compat[i, a] == compat[i, b]).all(1)).sum())
    return same / max(total, 1)


def median_event_ms(fn, runs):
    """Median CUDA-event ms of ``runs`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return p50(times)


def queued_event_ms(fn, runs, sleep_cycles=50_000_000):
    """Device ms a call of ``fn``, by CUDA events around ``runs`` calls
    enqueued behind a spin kernel (``torch.cuda._sleep``): the calls are
    queued before the card reaches them, so the host's work between them
    leaves no gap. No profiler."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def whatif_kernel_record(enc, device, runs):
    """The window's tensors through the kernel and the plain version: the
    difference (0 when bit for bit), the kernel's median CUDA-event ms over
    ``runs`` warm launches (the wrapper's host work between the events
    included), its mean device ms over as many under torch.profiler, the
    plain version's event ms over 5, the launch geometry and the bound.
    These launches are comparisons, not the main path's: the count is
    restored."""
    import torch

    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.solver.whatif import _to_device

    launches = wc.LAUNCHES
    tensors = _to_device(enc, device)
    err = whatif_diff(wc.whatif_scan(*tensors), wc.whatif_scan_plain(*tensors))
    torch.cuda.synchronize()
    ms = median_event_ms(lambda: wc.whatif_scan(*tensors), runs)
    device_ms, _ = profiled_kernel_ms(lambda: wc.whatif_scan(*tensors), runs, "whatif")
    plain_ms = median_event_ms(lambda: wc.whatif_scan_plain(*tensors), 5)
    wc.LAUNCHES = launches
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "shape": list(tensors[2].shape), "kept_bins": int(len(enc.kept)),
            "geometry": wc.launch_geometry(tensors[2].shape[2]),
            "replica_share": replica_share(enc), **whatif_bound(enc, tensors)}


# --whatif-times: a deprovision-shaped window (bench.py:121-164's 400-type
# catalog, config_4's MIXED_SHAPES): nodes, the share of them that FFD's
# tail fills with the eight smallest shapes, the share the scale-down
# leaves whole, candidates
WHATIF_TIMES_NODES, WHATIF_TIMES_SMALL, WHATIF_TIMES_WHOLE = 781, 0.15, 0.12
WHATIF_TIMES_CANDIDATES = 420


def deprovision_shaped_window():
    """A window of deprovision window 0's shape (512 x 128 x 1024) without
    the controller run: WHATIF_TIMES_NODES nodes of the 400-type catalog's
    16- to 96-cpu types, each first-fit filled with seeded MIXED_SHAPES pods
    (WHATIF_TIMES_SMALL of them with the eight smallest, up to their 110 pod
    slots), then a share of each node's pods (30 to 90 %) kept, all of them
    on WHATIF_TIMES_WHOLE of the nodes; the first WHATIF_TIMES_CANDIDATES scaled-down nodes that
    still hold pods are the candidates, every node a bin. Returns the
    encoding."""
    import numpy as np

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.core import Node, NodeSpec, NodeStatus, ObjectMeta
    from karpenter_tpu_torch.models.consolidate import node_bin
    from karpenter_tpu_torch.ops.whatif import encode_window
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    rng = np.random.default_rng(SEED)
    types = [it for it in make_catalog(400) if it.cpu.nano >= 16 * 10**9]
    shapes = [_pod(c, m) for c, m in MIXED_SHAPES]
    nodes, pods_by, cand = [], {}, []
    for n in range(WHATIF_TIMES_NODES):
        it = types[int(rng.integers(len(types)))]
        name = f"node-{n}"
        nodes.append(Node(
            metadata=ObjectMeta(name=name, namespace="", labels={
                wk.LABEL_INSTANCE_TYPE: it.name, wk.LABEL_CAPACITY_TYPE: "on-demand",
                wk.PROVISIONER_NAME_LABEL: "default"}),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=parse_resource_list({
                "cpu": str(it.cpu), "memory": str(it.memory), "pods": str(it.pods)}))))
        cpu, mem, slots = it.cpu.nano, it.memory.nano, it.pods.nano // 10**9
        pick = 8 if rng.random() < WHATIF_TIMES_SMALL else len(shapes)
        placed = []
        for s in rng.integers(pick, size=4 * slots):
            c, m = MIXED_SHAPES[int(s)]
            if len(placed) < slots and c * 10**6 <= cpu and m * 2**20 * 10**9 <= mem:
                cpu -= c * 10**6
                mem -= m * 2**20 * 10**9
                placed.append(shapes[int(s)])
        if rng.random() < WHATIF_TIMES_WHOLE:
            pods_by[name] = placed
            continue
        share = rng.uniform(0.3, 0.9)
        pods_by[name] = [p for p, k in zip(placed, rng.random(len(placed)) < share) if k]
        if pods_by[name] and len(cand) < WHATIF_TIMES_CANDIDATES:
            cand.append(n)
    bins = [node_bin(n, pods_by[n.metadata.name]) for n in nodes]
    return encode_window(bins, cand, [pods_by[nodes[i].metadata.name] for i in cand])


def config5_window():
    """config_5's consolidation window (whatif_window_fleet), encoded."""
    from karpenter_tpu_torch.models.consolidate import node_bin, reschedulable_pods
    from karpenter_tpu_torch.ops.whatif import encode_window

    nodes, pods_by, _ = whatif_window_fleet()
    bins = [node_bin(n, pods_by[n.metadata.name]) for n in nodes]
    return encode_window(bins, list(range(WHATIF_W)), [
        reschedulable_pods(pods_by[f"cand-{i}"])[0] for i in range(WHATIF_W)])


def profiled_kernel_ms(fn, runs, key, attempts=5, per_call=1):
    """``runs`` calls of ``fn`` under torch.profiler: the mean device time of
    the kernels whose name holds ``key`` and their count. A first profiled
    call is made and dropped, as in device_launches. Late in the whole
    script a session can miss kernels of the calls it profiles, so a
    session that saw other than ``runs × per_call`` of them is taken again,
    up to ``attempts`` sessions; (None, the last session's count) where
    none saw them all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    spans = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans = [end - start for start, end, name in device_events(prof) if key in name]
        if len(spans) == runs * per_call:
            return sum(spans) / len(spans) / 1e3, len(spans)
    return None, len(spans)


def phase_whatif_times(device):
    """``--whatif-times``: the what-if kernel alone, through whatif_scan's
    public signature, on a deprovision-shaped window and on config_5's
    window: the warm CUDA-event median, the kernel's device time from
    torch.profiler (host enqueue split out), the host seconds a call takes
    to enqueue, the bound, the share of replica pods, the difference from
    the plain version and a digest of (feasible, slots), so a run of
    another tree's kernel (this script copied into it) compares launch for
    launch."""
    import hashlib

    import torch

    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.solver.whatif import _to_device

    for name, build in (("deprovision_shaped", deprovision_shaped_window),
                        ("config_5", config5_window)):
        enc = build()
        check(enc.device_ready, f"{name}: not device-encodable")
        tensors = _to_device(enc, device)

        def run():
            return wc.whatif_scan(*tensors)

        feas, slots = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256(feas.cpu().numpy().tobytes()
                                + slots.cpu().numpy().tobytes()).hexdigest()[:16]
        err = whatif_diff((feas, slots), wc.whatif_scan_plain(*tensors))
        ms = median_event_ms(run, WARM_RUNS)
        device_ms, launches = profiled_kernel_ms(run, WARM_RUNS, "whatif")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WARM_RUNS):
            run()
        host_us = (time.perf_counter() - t0) / WARM_RUNS * 1e6
        torch.cuda.synchronize()
        geometry = getattr(wc, "launch_geometry", None)
        emit({"phase": "whatif_times", "window": name, "shape": list(tensors[2].shape),
              "candidates": enc.n, "kept_bins": int(len(enc.kept)),
              "longest": max(len(p) for p in enc.cand_pods),
              "replica_share": replica_share(enc),
              "geometry": geometry(tensors[2].shape[2]) if geometry else None,
              "ms": ms, "device_ms": device_ms, "profiled_launches": launches,
              "host_enqueue_us": host_us, "max_abs_err": err, "digest": digest,
              "feasible": int(feas.sum()), **whatif_bound(enc, tensors)})


def check_against_host(enc, feas, slots, what):
    """feasible equal to host_whatif's, the slots on feasible rows too;
    returns host_whatif's seconds."""
    import numpy as np

    from karpenter_tpu_torch.ops.whatif import host_whatif

    t0 = time.perf_counter()
    host_feas, host_slots = host_whatif(enc)
    seconds = time.perf_counter() - t0
    check(np.array_equal(feas, host_feas), f"{what}: feasible != host_whatif")
    check(np.array_equal(slots[feas], host_slots[feas]),
          f"{what}: slots != host_whatif on feasible rows")
    return seconds


def phase_whatif_window(device):
    """config_5's consolidation window at full size (2,000 nodes): encode,
    one launch of the what-if kernel, the plan, and the JAX package's bench
    checks (bench.py:417-560): the kernel equals its plain version,
    feasible equals host_whatif (and the slots on feasible rows), executor
    "device-whatif", every drain of plan_window replays on the surviving
    bins. Then config_5's repack_plan on its 2,000 fragmented nodes
    (bench.py:367-415) once, planned nodes equal to the host oracle's."""
    import torch

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.core import Node, NodeSpec, NodeStatus, ObjectMeta
    from karpenter_tpu_torch.models.consolidate import (
        node_bin, repack_plan, reschedulable_pods)
    from karpenter_tpu_torch.models.ffd import solve_ffd_numpy
    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.ops.whatif import encode_window
    from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
    from karpenter_tpu_torch.solver.solve import universe_constraints
    from karpenter_tpu_torch.solver.whatif import dispatch_window, plan_window
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    t_phase = time.perf_counter()
    nodes, pods_by, big = whatif_window_fleet()
    bins = [node_bin(n, pods_by[n.metadata.name]) for n in nodes]
    cand_idx = list(range(WHATIF_W))
    cand_movable = [reschedulable_pods(pods_by[f"cand-{i}"])[0] for i in cand_idx]

    t0 = time.perf_counter()
    enc = encode_window(bins, cand_idx, cand_movable)
    encode_s = time.perf_counter() - t0
    check(enc.device_ready, "whatif window: not device-encodable")
    reset_counts()
    handle = dispatch_window(enc, device)
    feas, slots, executor = handle.fetch()
    check(executor == "device-whatif" and wc.LAUNCHES == 1,
          f"whatif window: executor {executor}, {wc.LAUNCHES} launches")
    host_s = check_against_host(enc, feas, slots, "whatif window")
    kern = whatif_kernel_record(enc, device, WARM_RUNS)
    check(kern["max_abs_err"] == 0, "whatif window: kernel != plain")
    t0 = time.perf_counter()
    plan = plan_window(enc, feas, [big.price] * WHATIF_W, max_drains=WHATIF_W)
    plan_s = time.perf_counter() - t0
    unverified, received = replay_drains(plan, enc)
    check(plan.actions and unverified == 0 and received == 0,
          f"whatif window: {len(plan.actions)} drains, {unverified} do not replay, "
          f"{received} received pods")

    # config_5's whole-fleet re-pack (bench.py:367-415)
    catalog = make_catalog(100)
    constraints = universe_constraints(catalog)
    frag, frag_pods = [], {}
    pods = make_pods(2_000 * 3, [(250, 256), (500, 512), (1000, 1024)])
    for i in range(2_000):
        name = f"frag-{i}"
        frag.append(Node(
            metadata=ObjectMeta(name=name, namespace="", labels={
                wk.LABEL_INSTANCE_TYPE: big.name, wk.LABEL_CAPACITY_TYPE: "on-demand",
                wk.PROVISIONER_NAME_LABEL: "bench"}),
            spec=NodeSpec(),
            status=NodeStatus(allocatable=parse_resource_list({
                "cpu": str(big.cpu), "memory": str(big.memory), "pods": str(big.pods)}))))
        for j, p in enumerate(pods[i * 3:(i + 1) * 3]):
            p.metadata.name = f"pod-{i}-{j}"
        frag_pods[name] = pods[i * 3:(i + 1) * 3]
    t0 = time.perf_counter()
    rplan = repack_plan(frag, frag_pods, constraints, catalog, device=device)
    torch.cuda.synchronize()
    repack_s = time.perf_counter() - t0
    packables, _ = build_packables(catalog, constraints, pods, ())
    oracle = solve_ffd_numpy(pod_vectors(pods), list(range(len(pods))), packables).node_count
    check(rplan.saves and rplan.planned_nodes == oracle,
          f"config_5 repack: {rplan.planned_nodes} nodes, oracle {oracle}")

    rec = {"phase": "whatif_window", "fleet_nodes": len(nodes), "candidates": WHATIF_W,
           "executor": executor, "feasible": int(feas.sum()), "drains": len(plan.actions),
           "unverified_drains": unverified, "reclaimed_per_hour": plan.reclaimed_per_hour,
           "kernel": dict(kern, ms_in_window=handle.kernel_ms),
           "encode_s": encode_s, "dispatch_s": handle.dispatch_seconds,
           "host_whatif_s": host_s, "plan_s": plan_s,
           "repack": {"nodes": 2_000, "pods": len(pods), "planned_nodes": rplan.planned_nodes,
                      "oracle_nodes": oracle, "seconds": repack_s,
                      "cost_before_per_hour": rplan.current_cost_per_hour,
                      "cost_after_per_hour": rplan.planned_cost_per_hour},
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def config4_pending_pods(rng):
    """config_4's 50,000 pods (bench.py:332-364: the 32 MIXED_SHAPES
    cycled) as pending pods the scheduler marked Unschedulable, a seeded
    WEB_SHARE labelled app=web and DB_SHARE app=db."""
    from karpenter_tpu_torch.api import core as c

    draws = rng.random(DEPROVISION_PODS)
    pods = []
    for j in range(DEPROVISION_PODS):
        cpu, mem = MIXED_SHAPES[j % len(MIXED_SHAPES)]
        app = "web" if draws[j] < WEB_SHARE else "db" if draws[j] < WEB_SHARE + DB_SHARE else None
        pods.append(c.Pod(
            metadata=c.ObjectMeta(name=f"dp-{j:05d}", uid=f"dp-{j:05d}",
                                  labels={"app": app} if app else {}),
            spec=c.PodSpec(containers=[c.Container(resources=c.ResourceRequirements.make(
                requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}))]),
            status=c.PodStatus(conditions=[c.PodCondition(
                type="PodScheduled", status="False", reason="Unschedulable")])))
    return pods


def fleet_cost(kube, catalog):
    """(nodes, $/h) of the fleet that is not being deleted."""
    from karpenter_tpu_torch.models.consolidate import fleet_prices

    nodes = [n for n in kube.list("Node") if n.metadata.deletion_timestamp is None]
    prices, _ = fleet_prices(nodes, catalog)
    return len(nodes), sum(prices.values())


def pdb_breaches(kube):
    """The PDBs whose healthy selected pods are fewer than they require."""
    from karpenter_tpu_torch.runtime.kubecore import _scaled_int_or_percent

    out = []
    for pdb in kube.list("PodDisruptionBudget"):
        sel = kube.list("Pod", namespace=pdb.metadata.namespace, label_selector=pdb.selector)
        healthy = sum(1 for p in sel if p.spec.node_name and p.metadata.deletion_timestamp is None)
        if pdb.min_available is not None:
            desired = _scaled_int_or_percent(pdb.min_available, len(sel), pdb.metadata.name)
        else:
            desired = len(sel) - _scaled_int_or_percent(pdb.max_unavailable, len(sel),
                                                        pdb.metadata.name)
        if healthy < desired:
            out.append((pdb.metadata.name, healthy, desired))
    return out


def terminate_all(kube, termination, names, timeout=120.0):
    """TerminationController.reconcile on each node of ``names`` until every
    one is gone, checking the PDBs after each pass; returns (seconds,
    passes)."""
    from karpenter_tpu_torch.runtime.kubecore import NotFound

    t0, passes, left = time.perf_counter(), 0, list(names)
    while left:
        check(time.perf_counter() - t0 < timeout,
              f"termination: {len(left)} nodes still there after {timeout} s")
        still = []
        for name in left:
            try:
                kube.get("Node", name, "")
            except NotFound:
                continue
            termination.reconcile(name)
            still.append(name)
        passes += 1
        breaches = pdb_breaches(kube)
        check(not breaches, f"termination: PDBs breached {breaches}")
        left = still
        if left:
            time.sleep(0.02)
    return time.perf_counter() - t0, passes


def check_removed(kube, provider, names, pods_before, events, what):
    """Each node of ``names`` was cordoned (a watch event with
    spec.unschedulable before it went), FakeCloudProvider.delete was
    called once for it, its Node object and every one of its pods are
    gone, and every pod that was on any other node is still there."""
    from collections import Counter

    from karpenter_tpu_torch.runtime.kubecore import NotFound

    deleted = Counter(provider.deleted)
    cordoned = {e.obj.metadata.name for e in events
                if e.type == "MODIFIED" and e.obj.spec.unschedulable}
    gone = {e.obj.metadata.name for e in events if e.type == "DELETED"}
    names = set(names)
    for name in names:
        check(deleted[name] == 1, f"{what}: provider.delete called {deleted[name]}x for {name}")
        check(name in cordoned and name in gone, f"{what}: {name} not cordoned, then deleted")
        try:
            kube.get("Node", name, "")
            check(False, f"{what}: node {name} is still there")
        except NotFound:
            pass
    now = {p.metadata.name: p.spec.node_name for p in kube.list("Pod")}
    evicted = [p for p, n in pods_before.items() if n in names and p in now]
    lost = [p for p, n in pods_before.items() if n not in names and p not in now]
    check(not evicted, f"{what}: pods of removed nodes still there: {evicted[:3]}")
    check(not lost, f"{what}: pods of surviving nodes evicted: {lost[:3]}")


def drain_events(q):
    import queue

    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def log_evictions(kube):
    """Wrap ``kube.evict_pod`` so that every call's outcome is logged, in
    order: (pod name, "evicted" or the error's class name). Returns the
    log."""
    outcomes = []
    evict = kube.evict_pod

    def logged(name, namespace="default"):
        try:
            evict(name, namespace)
        except Exception as e:
            outcomes.append((name, type(e).__name__))
            raise
        outcomes.append((name, "evicted"))
    kube.evict_pod = logged
    return outcomes


def web_pods(kube):
    """The app=web pods, and the healthy ones among them (scheduled, not
    terminating)."""
    pods = [p for p in kube.list("Pod") if p.metadata.labels.get("app") == "web"]
    return pods, sum(1 for p in pods if p.spec.node_name and p.metadata.deletion_timestamp is None)


def budget_drains(kube, termination, provider, watch, outcomes, timeout=60.0):
    """The web budget made to bind: two nodes drained by hand. The web PDB
    becomes minAvailable = its healthy pods less those of node A (the
    surviving node with the most web pods and no db pod), so draining A
    takes the budget to its edge, and the Deployment recreates A's web
    pods, Pending. Deleting B (the next such node) then meets the budget:
    each of B's web pods is refused with a 429 and requeued with backoff,
    while the rest of B drains. The replacements are then bound to
    surviving nodes, as the scheduler would; healthy web pods rise above
    the budget and the eviction queue's retries drain B. Checks the PDBs
    after every pass, A and B removed as every drained node is, and every
    refused pod evicted by a later retry. The web PDB is put back to
    maxUnavailable "20%". Returns the record."""
    import copy
    from collections import Counter

    from karpenter_tpu_torch.models.consolidate import node_bin, place_onto

    t0 = time.perf_counter()
    live = {n.metadata.name for n in kube.list("Node") if n.metadata.deletion_timestamp is None}
    db_nodes = {p.spec.node_name for p in kube.list("Pod") if p.metadata.labels.get("app") == "db"}
    web, healthy = web_pods(kube)
    per_node = Counter(p.spec.node_name for p in web if p.spec.node_name in live - db_nodes)
    ranked = sorted(per_node.items(), key=lambda t: (-t[1], t[0]))
    check(len(ranked) >= 2, f"budget: {len(ranked)} nodes with web pods and no db pod")
    (node_a, a), (node_b, b) = ranked[:2]
    min_available = healthy - a

    def set_budget(min_a, max_u):
        def apply(pdb):
            pdb.min_available, pdb.max_unavailable = min_a, max_u
        kube.patch("PodDisruptionBudget", "web", "default", apply)
    set_budget(min_available, None)
    evicted_web = [p for p in web if p.spec.node_name == node_a]
    b_web = {p.metadata.name for p in web if p.spec.node_name == node_b}

    drain_events(watch)
    pods_before = {p.metadata.name: p.spec.node_name for p in kube.list("Pod")}
    kube.delete("Node", node_a, "")
    term_a, _ = terminate_all(kube, termination, [node_a])
    check_removed(kube, provider, [node_a], pods_before, drain_events(watch), "budget node A")
    check(web_pods(kube)[1] == min_available, "budget: draining A did not take web to its edge")
    replacements = []
    for p in evicted_web:
        r = copy.deepcopy(p)
        r.metadata.name, r.metadata.uid = p.metadata.name + "-r", ""
        r.metadata.resource_version, r.spec.node_name = None, ""
        replacements.append(kube.create(r))

    mark = len(outcomes)
    pods_before = {p.metadata.name: p.spec.node_name for p in kube.list("Pod")}
    kube.delete("Node", node_b, "")
    t_refused, passes = time.perf_counter(), 0
    while True:
        termination.reconcile(node_b)
        passes += 1
        breaches = pdb_breaches(kube)
        check(not breaches, f"budget: PDBs breached {breaches}")
        refused = {n for n, what in outcomes[mark:] if what == "TooManyRequests"}
        if b_web <= refused:
            break
        check(time.perf_counter() - t_refused < timeout,
              f"budget: {len(b_web - refused)} of B's web pods never refused")
        time.sleep(0.02)
    on_b = {p.metadata.name for p in kube.pods_on_node(node_b)}
    check(b_web <= on_b, "budget: a web pod left B while the budget was at its edge")
    refusals = sum(1 for _, what in outcomes[mark:] if what == "TooManyRequests")

    # the scheduler binds the replacements onto the surviving nodes
    survivors = [n for n in kube.list("Node")
                 if n.metadata.deletion_timestamp is None and n.metadata.name != node_b]
    bins = [node_bin(n, kube.pods_on_node(n.metadata.name)) for n in survivors]
    for r in replacements:
        target = place_onto([r], bins, commit=True)
        check(target is not None, f"budget: no surviving node fits {r.metadata.name}")
        check(not kube.bind_pods([r], target[0]), f"budget: binding {r.metadata.name} failed")
    term_b, passes_b = terminate_all(kube, termination, [node_b], timeout)
    check_removed(kube, provider, [node_b], pods_before, drain_events(watch), "budget node B")
    retried = {n for n, what in outcomes[mark:] if what == "evicted"}
    check(refused <= retried, f"budget: {len(refused - retried)} refused pods never evicted")
    set_budget(None, "20%")
    return {"phase": "deprovision_budget", "node_a": node_a, "web_on_a": a,
            "node_b": node_b, "web_on_b": b, "web_healthy": healthy,
            "min_available": min_available, "refusals_429": refusals,
            "refused_pods": len(refused), "retried_evicted": len(refused & retried),
            "passes_refused": passes, "termination_a_s": term_a, "termination_b_s": term_b,
            "passes_b": passes_b, "seconds": time.perf_counter() - t0}


def phase_deprovision(device):
    """Node removal end to end at the north star's size, through the
    port's entry points:

    1. config_4's 50,000 pods provisioned through ProvisioningController and
       SelectionController (ControllerRun, the "ffd" backend), a seeded
       WEB_SHARE app=web and DB_SHARE app=db, on nodes that boot NotReady;
    2. each node's Ready condition set, as a kubelet would;
    3. NodeController.reconcile over every node: the not-ready taint goes,
       the termination finalizer stays;
    4. two PDBs: web maxUnavailable "20%", db minAvailable "100%";
    5. the scale-down: a seeded SCALE_DOWN_PODS of the pods deleted, and
       every pod of a seeded SCALE_DOWN_NODES of the nodes;
    6. CONSOLIDATION_WINDOWS windows of ConsolidationController at its
       defaults, each window's drained nodes driven through
       TerminationController.reconcile until gone, the eviction queue's
       thread live;
    7. the budget made to bind (budget_drains): two nodes drained by hand
       under a web budget at its edge, the second one's web pods refused
       with 429s until the first one's replacements are bound, then
       evicted by the queue's retries;
    8. emptiness: ttlSecondsAfterEmpty EMPTY_TTL, the empty nodes stamped,
       kept at 29 s on the port's clock, deleted at 31 s and terminated.

    Checks: every window on "device-whatif" with one whatif_scan launch;
    window 1's tensors through the kernel equal to the plain version and
    its feasible to host_whatif; every drain replays on fresh surviving
    bins; no drained bin received pods in its window; no node with a db
    pod drained; every PDB holds after every termination pass; at least
    one 429 and its later retry; each removed node cordoned, its pods
    evicted, deleted at the provider once and gone; no pod of a surviving
    node evicted."""
    import numpy as np

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.core import (
        LabelSelector, NodeCondition, ObjectMeta, PodDisruptionBudget)
    from karpenter_tpu_torch.controllers.consolidation import ConsolidationController
    from karpenter_tpu_torch.controllers.node import NodeController
    from karpenter_tpu_torch.controllers.termination import TerminationController
    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.utils import clock

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    catalog = make_catalog(400)
    run = ControllerRun(catalog, device, card_config(window_backend="ffd"),
                        nodes_become_ready=False)
    try:
        pods = config4_pending_pods(rng)
        prov = run.window(pods)
    finally:
        run.stop()
    kube, provider = run.kube, run.provisioning.cloud_provider
    check(prov["pods_bound"] == DEPROVISION_PODS,
          f"deprovision: {prov['pods_bound']} of {DEPROVISION_PODS} pods bound")
    nodes = sorted(n.metadata.name for n in kube.list("Node"))
    check(not any(n.status.conditions for n in kube.list("Node")),
          "deprovision: nodes booted with conditions")

    def ready(live):
        live.status.conditions = [NodeCondition(type="Ready", status="True",
                                                reason="KubeletReady")]
    node_ctl = NodeController(kube)
    for name in nodes:
        kube.patch("Node", name, "", ready)
        node_ctl.reconcile(name)
    live = kube.list("Node")
    check(all(not any(t.key == wk.NOT_READY_TAINT_KEY for t in n.spec.taints)
              and wk.TERMINATION_FINALIZER in n.metadata.finalizers for n in live),
          "deprovision: NodeController left a not-ready taint or took the finalizer")
    kube.create(PodDisruptionBudget(metadata=ObjectMeta(name="web"),
                                    selector=LabelSelector(match_labels={"app": "web"}),
                                    max_unavailable="20%"))
    kube.create(PodDisruptionBudget(metadata=ObjectMeta(name="db"),
                                    selector=LabelSelector(match_labels={"app": "db"}),
                                    min_available="100%"))

    # the scale-down
    emptied = {str(n) for n in rng.choice(nodes, size=round(SCALE_DOWN_NODES * len(nodes)),
                                          replace=False)}
    bound = sorted((p.metadata.name, p.spec.node_name) for p in kube.list("Pod"))
    drop = rng.random(len(bound)) < SCALE_DOWN_PODS
    for (name, node), d in zip(bound, drop):
        if d or node in emptied:
            kube.delete("Pod", name, "default")
    remaining = len(kube.list("Pod"))

    def set_spec(fn):
        kube.patch("Provisioner", "default", "default", lambda p: fn(p.spec))
    set_spec(lambda s: setattr(s, "consolidation_enabled", True))
    consolidation = ConsolidationController(kube, provider, device=device)
    termination = TerminationController(kube, provider)
    outcomes = log_evictions(kube)
    watch = kube.watch("Node")
    windows, launches, worst = [], 0, 0
    try:
        for w in range(CONSOLIDATION_WINDOWS):
            drain_events(watch)
            nodes_before, cost_before = fleet_cost(kube, catalog)
            pods_before = {p.metadata.name: p.spec.node_name for p in kube.list("Pod")}
            db_nodes = {p.spec.node_name for p in kube.list("Pod")
                        if p.metadata.labels.get("app") == "db"}
            reset_counts()
            consolidation.reconcile("default")
            lw = dict(consolidation.last_window)
            enc, feas, slots, plan = consolidation.last_solve
            check(lw["executor"] == "device-whatif" and wc.LAUNCHES == 1,
                  f"deprovision window {w}: executor {lw['executor']}, {wc.LAUNCHES} launches")
            launches += wc.LAUNCHES
            drained = lw["drained"]
            check(drained, f"deprovision window {w}: nothing drained")
            check(not set(drained) & db_nodes, f"deprovision window {w}: drained a db node")
            unverified, received = replay_drains(plan, enc)
            check(unverified == 0 and received == 0,
                  f"deprovision window {w}: {unverified} drains do not replay, "
                  f"{received} drained bins received pods")
            extra = {}
            if w == 0:
                extra["host_whatif_s"] = check_against_host(enc, feas, slots,
                                                            "deprovision window 0")
                extra["kernel"] = whatif_kernel_record(enc, device, WARM_RUNS)
                worst = max(worst, extra["kernel"]["max_abs_err"])
                check(extra["kernel"]["max_abs_err"] == 0, "deprovision window 0: kernel != plain")
            term_s, passes = terminate_all(kube, termination, drained)
            check_removed(kube, provider, drained, pods_before, drain_events(watch),
                          f"deprovision window {w}")
            nodes_after, cost_after = fleet_cost(kube, catalog)
            rec = {"phase": "deprovision_window", "window": w, **lw, **extra,
                   "nodes_before": nodes_before, "nodes_after": nodes_after,
                   "cost_before_per_hour": cost_before, "cost_after_per_hour": cost_after,
                   "termination_s": term_s, "termination_passes": passes}
            emit(rec)
            windows.append(rec)

        budget = budget_drains(kube, termination, provider, watch, outcomes)
        emit(budget)

        # emptiness
        set_spec(lambda s: setattr(s, "ttl_seconds_after_empty", EMPTY_TTL))
        names = sorted(n.metadata.name for n in kube.list("Node"))
        empty = [n for n in names if not kube.pods_on_node(n)]
        check(empty, "deprovision: no empty node to reap")
        t0 = clock.now()
        clock.DEFAULT.set(t0)
        requeues = {n: node_ctl.reconcile(n) for n in names}
        stamped = {n.metadata.name for n in kube.list("Node")
                   if wk.EMPTINESS_TIMESTAMP_ANNOTATION in n.metadata.annotations}
        check(stamped == set(empty), f"emptiness: stamped {len(stamped)}, empty {len(empty)}")
        check(all(requeues[n] == EMPTY_TTL for n in empty),
              "emptiness: an empty node's requeue is not the TTL")
        clock.DEFAULT.set(t0 + EMPTY_TTL - 1)
        for n in empty:
            node_ctl.reconcile(n)
        check(not any(n.metadata.deletion_timestamp for n in kube.list("Node")),
              "emptiness: a node was deleted before its TTL")
        drain_events(watch)
        pods_before = {p.metadata.name: p.spec.node_name for p in kube.list("Pod")}
        nodes_before, cost_before = fleet_cost(kube, catalog)
        clock.DEFAULT.set(t0 + EMPTY_TTL + 1)
        for n in empty:
            node_ctl.reconcile(n)
        deleting = {n.metadata.name for n in kube.list("Node") if n.metadata.deletion_timestamp}
        check(deleting == set(empty), f"emptiness: {len(deleting)} deleted, {len(empty)} empty")
        term_s, passes = terminate_all(kube, termination, empty)
        check_removed(kube, provider, empty, pods_before, drain_events(watch), "emptiness")
        nodes_after, cost_after = fleet_cost(kube, catalog)
    finally:
        clock.DEFAULT.reset()
        kube.unwatch(watch)
        termination.stop_all()
    rec = {"phase": "deprovision", "provision": {k: prov[k] for k in (
        "pods", "pods_bound", "nodes", "wall_s", "chunks", "executor_counts")},
        "scale_down": {"pods_left": remaining, "nodes_emptied": len(emptied)},
        "windows": len(windows), "whatif_launches": launches, "max_abs_err": worst,
        "kernel": windows[0]["kernel"],
        "drained": sum(len(w["drained"]) for w in windows),
        "budget": {k: budget[k] for k in ("refusals_429", "refused_pods", "retried_evicted")},
        "emptiness": {"empty": len(empty), "termination_s": term_s, "passes": passes,
                      "nodes_before": nodes_before, "nodes_after": nodes_after,
                      "cost_before_per_hour": cost_before, "cost_after_per_hour": cost_after},
        "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


# -- pod-(anti-)affinity (B5) and the packing policies (B6) ------------------

# (selectors, distinct peers) of the match-matrix fuzz, up to what a 50k-pod
# window of mixed Deployments dedupes to
AFFINITY_FUZZ = [(4, 8), (16, 64), (64, 256), (256, 1024), (1024, 4096)]
AFFINITY_KEYS = [f"k{i}" for i in range(10)]
AFFINITY_VALUES = [f"v{j}" for j in range(48)]


def affinity_fuzz_case(rng, S, P):
    """``S`` selectors against ``P`` distinct peer label sets. A peer holds
    1-6 of 10 keys, each with one of 48 values; a selector 0-2
    match_labels (a value no peer holds among the draws) and 0-3
    expressions over all four operators, some on a key no peer has or with
    values no peer holds; every 16th selector is empty."""
    from karpenter_tpu_torch.api.core import LabelSelector, NodeSelectorRequirement
    from karpenter_tpu_torch.ops.feasibility import labels_signature

    vals = AFFINITY_VALUES + ["unseen"]
    peers = {}
    while len(peers) < P:
        labels = {k: rng.choice(AFFINITY_VALUES)
                  for k in rng.sample(AFFINITY_KEYS, rng.randint(1, 6))}
        peers.setdefault(labels_signature(labels), None)
    selectors = []
    for s in range(S):
        if s % 16 == 15:
            selectors.append(LabelSelector())
            continue
        ml = {k: rng.choice(vals) for k in rng.sample(AFFINITY_KEYS, rng.randint(0, 2))}
        exprs = []
        for _ in range(rng.randint(0 if ml else 1, 3)):
            op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist"])
            values = ([rng.choice(vals) for _ in range(rng.randint(1, 8))]
                      if op in ("In", "NotIn") else [])
            exprs.append(NodeSelectorRequirement(key=rng.choice(AFFINITY_KEYS + ["absent"]),
                                                 operator=op, values=values))
        selectors.append(LabelSelector(match_labels=ml, match_expressions=exprs))
    return selectors, tuple(peers)


def affinity_program_record(sigs, peers, oracle, device):
    """B5 on one window's encoding: the program's CUDA-event median over
    20 warm calls, its kernels and idle share (torch.profiler), its bound
    by bytes (peer plane, clause masks, kinds, selector ids and the (S,
    Ppad) bool output at the HBM rate) and the same program on the CPU."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.backend import to_device_int32
    from karpenter_tpu_torch.ops import device_filter

    S, P = len(sigs), len(peers)
    enc = device_filter.affinity_planes(sigs, peers)
    planes_d = to_device_int32(list(enc), device)
    planes_c = to_device_int32(list(enc), torch.device("cpu"))
    out = device_filter.affinity_program(*planes_d, S)
    check(np.array_equal(out[:, :P].cpu().numpy(), oracle),
          "affinity_fuzz: the timed program differs from the oracle")
    ms = median_event_ms(lambda: device_filter.affinity_program(*planes_d, S), 20)
    launches = device_launches(lambda: device_filter.affinity_program(*planes_d, S))
    t0 = time.perf_counter()
    device_filter.affinity_program(*planes_c, S)
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    nbytes = sum(a.nbytes for a in enc) + S * enc[0].shape[0]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"shape": [S, P], "padded": [int(enc[1].shape[0]), int(enc[0].shape[0]),
                                        int(enc[0].shape[1])],
            "ms": ms, "cpu_ms": cpu_ms, "launches_per_call": launches, "bytes": nbytes,
            "bound_ms": t_bytes * 1e3, "bound_by": "bytes"}


def phase_affinity_fuzz(device):
    """B5: the selectors × peers match program on the card against the
    scalar LabelSelector.matches oracle on every cell, and against its
    numpy twin (affinity_matrix_plain) and the host columnar leg, over
    AFFINITY_FUZZ's seeded cases; the full entry (affinity_match_matrix,
    probe included) equal too, with 0 heals. Then the program timed at the
    largest case."""
    import numpy as np

    from karpenter_tpu_torch.ops import device_filter, feasibility

    t_phase = time.perf_counter()
    rng = random.Random(SEED)
    feasibility.reset_heals()
    cases = []
    for S, P in AFFINITY_FUZZ:
        selectors, peers = affinity_fuzz_case(rng, S, P)
        sigs = tuple(feasibility.selector_signature(s) for s in selectors)
        device_filter.clear_affinity_cache()
        t0 = time.perf_counter()
        card = device_filter.affinity_matrix(sigs, peers, device)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle = feasibility._affinity_scalar(selectors, peers)
        scalar_s = time.perf_counter() - t0
        device_filter.clear_affinity_cache()
        legs = {"card": card, "plain": device_filter.affinity_matrix_plain(sigs, peers),
                "columnar": feasibility._affinity_columnar(selectors, peers),
                "entry": feasibility.affinity_match_matrix(selectors, peers, device)}
        for name, mat in legs.items():
            diverged = int((mat != oracle).sum())
            check(mat.shape == oracle.shape and diverged == 0,
                  f"affinity_fuzz S={S} P={P}: {name} differs from matches() on {diverged} cells")
        cases.append({"s": S, "p": P, "true_cells": int(oracle.sum()),
                      "card_call_s": card_s, "scalar_s": scalar_s})
    check(feasibility.heal_counts() == {},
          f"affinity_fuzz: heals {feasibility.heal_counts()}")
    rec = {"phase": "affinity_fuzz", "cases": cases, "divergent_cells": 0, "heals": 0,
           "max_abs_err": 0, **affinity_program_record(sigs, peers, oracle, device),
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def config13_catalog():
    """bench.py:1332-1420 (config_13): the 400-type catalog with a spot
    interruption rate per (type, zone), 0.01-0.106 reclaims/h."""
    return make_catalog(WINDOW_TYPES,
                        spot_rate=lambda i, z: round(0.01 + 0.004 * ((i * 7 + z) % 25), 6))


def policy_program_record(fused, policy, cost, ctx, device):
    """B6 on one fused window: every member's full card row against the
    numpy mirror (_host_best) on every column (the program's own output,
    before any heal), the program's CUDA-event median over 20 warm calls,
    its kernels and idle share, its bound by bytes (operands read once, the
    (B, TB) rows written once) and the same program on the CPU."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import device_filter
    from karpenter_tpu_torch.ops import policy as ops_policy

    planes = device_filter.planes_for(fused.uni_types)
    tables = ops_policy.tables_for(planes, fused.uni_types, policy, cost, ctx)
    zw, cta, za = ops_policy._rows_host(planes, fused.verify)
    soft = ops_policy._soft_rows(planes, fused.soft, ctx)
    inputs = ops_policy.device_inputs(planes, tables, zw, cta, za, soft, device)
    best, cells = ops_policy._cells_expr(**inputs)
    mirror = ops_policy._host_best(tables, planes, zw, cta, za, soft_bz=soft)
    diverged = int((best.cpu().numpy() != mirror).sum())
    check(diverged == 0, f"policy_window: {diverged} card cells differ from the mirror")
    inputs_c = ops_policy.device_inputs(planes, tables, zw, cta, za, soft, torch.device("cpu"))
    ms = median_event_ms(lambda: ops_policy._cells_expr(**inputs), 20)
    launches = device_launches(lambda: ops_policy._cells_expr(**inputs))
    t0 = time.perf_counter()
    ops_policy._cells_expr(**inputs_c)
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    nbytes = sum(t.numel() * t.element_size() for t in inputs.values()
                 if isinstance(t, torch.Tensor)) + best.numel() * 4
    return {"shape": list(best.shape) + [int(tables.price_ct.shape[1])],
            "viable_cells": int(cells), "soft": soft is not None, "penalty": tables.use_pen,
            "ms": ms, "cpu_ms": cpu_ms, "launches_per_call": launches, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "mirror_divergence": 0}


def time_priced_batch(run, iters):
    """The window's first-chunk launch with its price rows (cost tie-break
    on) against pack_batch_plain on the same inputs, its CUDA-event time
    beside the same launch without prices, and its bound."""
    from karpenter_tpu_torch.ops.pack_cuda import launch_shape, pack_batch

    args = (run.shapes_d, run.counts_d, run.dropped_d, run.totals_d, run.reserved0_d,
            run.valid_d, run.last_valid_d, run.pods_unit_d)
    L, T = run.L, run.totals_d.shape[1]
    check(run.prices_d is not None, "policy_window: the window launched without prices")
    ok, err, _, stats = compare_batch(args, L, run.prices_d, True, run.maxfit_d,
                                      [launch_shape(T)])
    check(ok, "policy_window: the priced batched launch != plain")
    hints = dict(maxfit=run.maxfit_d, log_bound=run.log_bound, resource_mask=run.resource_mask)
    ms = cuda_ms(lambda: pack_batch(*args, L, prices=run.prices_d, cost_tiebreak=True,
                                    **hints), iters)
    unpriced_ms = cuda_ms(lambda: pack_batch(*args, L, **hints), iters)
    return {"ms": ms, "unpriced_ms": unpriced_ms, "plain_ms": stats["ms"], "max_abs_err": err,
            "type_steps": stats["type_steps"], **work_bound(args, L, True, stats["type_steps"])}


def phase_policy_window(device):
    """B6 and the pack kernel's price seam on two full-size windows.

    config_13's window (bench.py:1332-1420): 24 one-zone schedules × 416
    pods over config13_catalog under interruption-priced with a repack
    price of $2/h: every member's card row equal to the mirror on every
    column; under cheapest every row equal to encode_prices of the host
    scores; solve_batch on the card (one scoring program, the price rows
    in the batched launch) equal to solo solve() under the same policy,
    plan for plan; the frontier sweep (tests/test_policy.py's
    test_frontier_break_even algebra, through solve_batch and the card's
    rows) chooses spot exactly when rate × repack < price × (1 − factor).

    config_18's window (bench.py:2407-2530): 24 follower cohorts × 200
    pods over the two-zone catalog, each voting +100 for its anchor's zone
    at $0.001 a weight: the soft rows equal the mirror; steer_zone puts
    every cohort in its anchor's zone; the steered window's node count is
    at most 1 % above the unsteered one."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.api import wellknown as wk
    from karpenter_tpu_torch.api.constraints import Constraints
    from karpenter_tpu_torch.api.core import NodeSelectorRequirement
    from karpenter_tpu_torch.cloudprovider.spi import Offering, make_instance_type
    from karpenter_tpu_torch.models.cost import CostConfig
    from karpenter_tpu_torch.models.ffd import encode_prices
    from karpenter_tpu_torch.ops import device_filter, pack_cuda
    from karpenter_tpu_torch.ops import policy as ops_policy
    from karpenter_tpu_torch.solver import policy as registry
    from karpenter_tpu_torch.solver.adapter import marshal_pods_interned
    from karpenter_tpu_torch.solver.batch_solve import Problem, dispatch_batch, solve_batch
    from karpenter_tpu_torch.solver.policy import PolicyContext
    from karpenter_tpu_torch.solver.solve import solve, universe_constraints

    t_phase = time.perf_counter()
    cost = CostConfig()
    priced, cheapest = registry.get("interruption-priced"), registry.get("cheapest")
    mism0 = ops_policy.MISMATCHES

    def fused_of(problems):
        fused = device_filter.prepare_fused(problems, [marshal_pods_interned(p.pods) for p in problems],
                                            device)
        check(fused is not None and len(fused.batch_idx) == len(problems),
              "policy_window: the window was not fused")
        return fused

    # config_13
    catalog = config13_catalog()
    problems = window_problems(catalog, 416)
    ctx = PolicyContext(repack_cost_per_hour=2.0)
    fused = fused_of(problems)
    b6 = policy_program_record(fused, priced, cost, ctx, device)
    rows, cells = ops_policy.score_fused_window(fused, priced, cost, ctx)
    rows_c, _ = ops_policy.score_fused_window(fused, cheapest, cost, PolicyContext())
    TB = device_filter.planes_for(fused.uni_types).TB
    for b, i in enumerate(fused.batch_idx):
        reqs = problems[i].constraints.requirements
        want = encode_prices([cheapest.score(fused.uni_types[p.index], reqs, cost,
                                             PolicyContext())[0] for p in fused.packables], TB)
        check(np.array_equal(rows_c[b], want),
              f"policy_window: cheapest row {b} != encode_prices of the host scores")
    taxed = sum(int((a != c).sum()) for a, c in zip(rows, rows_c))
    check(taxed > 0, "policy_window: the reclaim tax moved no cell")
    cfg = card_config(packing_policy="interruption-priced", policy_context=ctx)
    reset_counts()
    handle = dispatch_batch(problems, cfg, device)   # the policy's window path
    results = handle.fetch()
    torch.cuda.synchronize()
    launches = {"policy_programs": ops_policy.RUNS, "pack_batch": pack_cuda.BATCH_LAUNCHES}
    check(launches["policy_programs"] == 1 and launches["pack_batch"] >= 1
          and handle.device_run.use_cost,
          f"policy_window: launches {launches}")
    check(executor_counts() == {"device-batch": len(problems)},
          f"policy_window answered by {executor_counts()}")
    spot_nodes = 0
    for b, (prob, got) in enumerate(zip(problems, results)):
        solo = solve(prob.constraints, prob.pods, catalog, config=cfg, device=device)
        check(canonical(got, prob.pods) == canonical(solo, prob.pods),
              f"policy_window: problem {b} != solo solve() under interruption-priced")
        reqs = prob.constraints.requirements
        spot_nodes += sum(p.node_quantity for p in got.packings
                          if priced.score(p.instance_type_options[0], reqs, cost, ctx)[1]
                          == wk.CAPACITY_TYPE_SPOT)
    fresh = dispatch_batch(problems, cfg, device)
    priced_kernel = time_priced_batch(fresh.device_run, 20)
    fresh.fetch()

    # the frontier: one type, one spot offering at rate r
    f, P, r = cost.spot_price_factor, 1.0, 0.5
    threshold = P * (1.0 - f) / r
    mini = [make_instance_type(
        name="frontier-4x", cpu="4", memory="8Gi", pods="16", price=P,
        offerings=[Offering("on-demand", "bench-zone-1"),
                   Offering("spot", "bench-zone-1", interruption_rate=r)])]
    frontier = []
    for mult in (0.0, 0.25, 0.5, 0.9, 1.1, 2.0, 4.0):
        v = round(threshold * mult, 6)
        pctx = PolicyContext(repack_cost_per_hour=v)
        probs = [Problem(constraints=universe_constraints(mini), pods=make_pods(40, [(500, 512)]),
                         instance_types=mini) for _ in range(2)]
        rs = solve_batch(probs, card_config(packing_policy="interruption-priced",
                                            policy_context=pctx), device=device)
        reqs = probs[0].constraints.requirements
        scalar_spot = {priced.score(p.instance_type_options[0], reqs, cost, pctx)[1]
                       == wk.CAPACITY_TYPE_SPOT for res in rs for p in res.packings}
        card_row = ops_policy.score_fused_window(fused_of(probs), priced, cost, pctx)[0][0][0]
        card_spot = int(card_row) < int(encode_prices([P], 1)[0])
        want = r * v < P * (1.0 - f)
        placed = sum(res.node_count for res in rs)
        check(scalar_spot == {want} and card_spot == want and placed > 0,
              f"policy_window: frontier x{mult}: spot {scalar_spot} / card {card_spot}, "
              f"want {want}, {placed} nodes")
        frontier.append({"mult": mult, "repack": v, "spot": want, "card_row": int(card_row),
                         "nodes": placed})

    # config_18
    catalog18 = make_catalog(WINDOW_TYPES, zones=2)
    universe = universe_constraints(catalog18)
    zones = ["bench-zone-1", "bench-zone-2"]
    sctx = PolicyContext(soft_affinity_cost_per_weight=0.001)
    problems18, anchors = [], []
    for b in range(WINDOW_SCHEDULES):
        anchors.append(zones[b % 2])
        k = b % len(MIXED_SHAPES)
        problems18.append(Problem(
            constraints=Constraints(requirements=universe.requirements),
            pods=make_pods(4800 // WINDOW_SCHEDULES, MIXED_SHAPES[k:] + MIXED_SHAPES[:k]),
            instance_types=catalog18,
            soft_affinity={(wk.LABEL_TOPOLOGY_ZONE, anchors[-1]): 100}))
    fused18 = fused_of(problems18)
    b6_soft = policy_program_record(fused18, cheapest, cost, sctx, device)
    check(b6_soft["soft"], "policy_window: config_18's window carried no soft rows")
    ops_policy.score_fused_window(fused18, cheapest, cost, sctx)
    steers = [ops_policy.steer_zone(catalog18, p.constraints.requirements, cost, sctx,
                                    p.soft_affinity) for p in problems18]
    check(steers == anchors, f"policy_window: steered {steers}, anchors {anchors}")
    steered = [Problem(constraints=Constraints(requirements=p.constraints.requirements.add(
        NodeSelectorRequirement(key=wk.LABEL_TOPOLOGY_ZONE, operator="In", values=[z]))),
        pods=p.pods, instance_types=catalog18) for p, z in zip(problems18, steers)]
    plain = [Problem(constraints=p.constraints, pods=p.pods, instance_types=catalog18)
             for p in problems18]
    nodes_steered = sum(res.node_count for res in solve_batch(steered, card_config(),
                                                              device=device))
    nodes_plain = sum(res.node_count for res in solve_batch(plain, card_config(), device=device))
    check(nodes_steered <= nodes_plain * 1.01,
          f"policy_window: steering took {nodes_steered} nodes against {nodes_plain}")
    check(ops_policy.MISMATCHES == mism0,
          f"policy_window: {ops_policy.MISMATCHES - mism0} members healed to the mirror")
    rec = {"phase": "policy_window",
           "config13": {"schedules": len(problems), "pods": sum(len(p.pods) for p in problems),
                        "types": len(catalog), "viable_cells": cells, "taxed_cells": taxed,
                        "launches": launches, "nodes": sum(r.node_count for r in results),
                        "spot_nodes": spot_nodes, "equal_to_solo": True, "program": b6,
                        "priced_pack_batch": priced_kernel},
           "frontier": frontier,
           "config18": {"schedules": len(problems18),
                        "pods": sum(len(p.pods) for p in problems18), "steered_to_anchor": 24,
                        "nodes_steered": nodes_steered, "nodes_unsteered": nodes_plain,
                        "program": b6_soft},
           "mismatches": 0, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


AFFINITY_REPLICAS, AFFINITY_COHORTS, AFFINITY_COHORT, AFFINITY_ANCHORS = 128, 24, 16, 4


def pending_affinity_pod(name, labels, cpu_m=500, mem_mi=512, aff=(), anti=(), preferred=(),
                         zone=None):
    """A pending, Unschedulable pod with ``labels``, required pod-affinity
    terms ``aff`` and anti-affinity terms ``anti`` ((topology key,
    match_labels) pairs), ``preferred`` (weight, term) pairs, and with
    ``zone`` a zone node selector."""
    from karpenter_tpu_torch.api import core as c
    from karpenter_tpu_torch.api import wellknown as wk

    def term(key, ml):
        return c.PodAffinityTerm(topology_key=key,
                                 label_selector=c.LabelSelector(match_labels=dict(ml)))

    pod = c.Pod(
        metadata=c.ObjectMeta(name=name, uid=name, labels=dict(labels)),
        spec=c.PodSpec(containers=[c.Container(resources=c.ResourceRequirements.make(
            requests={"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}))]),
        status=c.PodStatus(conditions=[c.PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable")]))
    if zone:
        pod.spec.node_selector = {wk.LABEL_TOPOLOGY_ZONE: zone}
    if aff or anti or preferred:
        pod.spec.affinity = c.Affinity(
            pod_affinity=c.PodAffinity(
                required=[term(*t) for t in aff],
                preferred=[c.WeightedPodAffinityTerm(weight=w, term=term(*t))
                           for w, t in preferred]) if aff or preferred else None,
            pod_anti_affinity=c.PodAffinity(
                required=[term(*t) for t in anti]) if anti else None)
    return pod


def affinity_controller_pods():
    """(a) 128 app=cache replicas with required hostname anti-affinity
    against app=cache; (b) 24 cohorts of 16 app=web-k pods with required
    zone affinity to app=db-k, 4 anchors pinned to bench-zone-{1 + k mod
    3}; (c) 24 cohorts of 16 app=soft-k pods with a preferred zone affinity
    (weight 50) to the same anchors; (d) a pod whose affinity and
    anti-affinity both select its partner (a conflict inside one
    component: both stay Pending); (e) a pod with a required zone affinity
    no pod matches. 995 pods."""
    from karpenter_tpu_torch.api import wellknown as wk

    host, zone = wk.LABEL_HOSTNAME, wk.LABEL_TOPOLOGY_ZONE
    pods = [pending_affinity_pod(f"cache-{i:03d}", {"app": "cache"}, 1500, 2048,
                                 anti=[(host, {"app": "cache"})])
            for i in range(AFFINITY_REPLICAS)]
    for k in range(AFFINITY_COHORTS):
        db = {"app": f"db-{k}"}
        pods += [pending_affinity_pod(f"db-{k:02d}-{j}", db, 1000, 2048,
                                      zone=f"bench-zone-{1 + k % 3}")
                 for j in range(AFFINITY_ANCHORS)]
        pods += [pending_affinity_pod(f"web-{k:02d}-{j:02d}", {"app": f"web-{k}"},
                                      aff=[(zone, db)]) for j in range(AFFINITY_COHORT)]
        pods += [pending_affinity_pod(f"soft-{k:02d}-{j:02d}", {"app": f"soft-{k}"},
                                      preferred=[(50, (zone, db))])
                 for j in range(AFFINITY_COHORT)]
    pods.append(pending_affinity_pod("conflict", {"app": "d"}, aff=[(host, {"role": "p"})],
                                     anti=[(host, {"role": "p"})]))
    pods.append(pending_affinity_pod("partner", {"role": "p"}))
    pods.append(pending_affinity_pod("lonely", {"app": "e"}, aff=[(zone, {"app": "nobody"})]))
    return pods


AFFINITY_UNSAT = ("conflict", "partner", "lonely")


def placement(kube):
    """The API server's placement: a Counter of nodes as (instance type,
    zone, capacity type, sorted pod names), and each bound pod's zone."""
    from collections import Counter

    from karpenter_tpu_torch.api import wellknown as wk

    labels = {n.metadata.name: n.metadata.labels for n in kube.list("Node")}
    by_node = {}
    for p in kube.list("Pod"):
        if p.spec.node_name:
            by_node.setdefault(p.spec.node_name, []).append(p.metadata.name)
    nodes = Counter((labels[n][wk.LABEL_INSTANCE_TYPE], labels[n][wk.LABEL_TOPOLOGY_ZONE],
                     labels[n][wk.LABEL_CAPACITY_TYPE], tuple(sorted(names)))
                    for n, names in by_node.items())
    zones = {name: labels[n][wk.LABEL_TOPOLOGY_ZONE]
             for n, names in by_node.items() for name in names}
    return nodes, zones, by_node


class SchedulerLog:
    """The scheduler's window log lines while open: the pods counted as
    reason=affinity."""

    def __enter__(self):
        import logging

        self.lines, self.logger = [], logging.getLogger("karpenter.scheduler")
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.lines.append(record.getMessage())

        self.handler, self.level = Handler(), self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def affinity(self):
        import re

        return sum(int(m.group(1)) for ln in self.lines
                   for m in [re.search(r"reason=affinity: (\d+)", ln)] if m)


def phase_controller_affinity(device):
    """config_12's window (24 node-affinity groups × 416 pods, as the
    controller phase's run 1: backend "ffd", one chunk) plus the 995 pods
    of affinity_controller_pods, through ProvisioningController and
    SelectionController on the card, once under cheapest and once under
    interruption-priced. Checks: every pod of (a)-(c), the anchors and
    config_12's (group 15's ENI pods aside) bound exactly once; the 128
    cache replicas on 128 distinct nodes; every (b) and (c) cohort in its
    anchor's zone; (d), its partner and (e) Pending, counted as
    reason=affinity; no gang window; pressure level 0; the
    match program and the batched kernel launched in the window (and the
    scoring program under interruption-priced). Then (a)-(e) alone through
    the port on the card and on the CPU: the same nodes (type, zone,
    capacity type, pods)."""
    import torch

    from karpenter_tpu_torch.ops import device_filter, pack_cuda
    from karpenter_tpu_torch.ops import policy as ops_policy
    from karpenter_tpu_torch.solver.pipeline import PipelineConfig

    t_phase = time.perf_counter()
    catalog = make_catalog(WINDOW_TYPES)
    runs = {}
    for policy in ("cheapest", "interruption-priced"):
        cfg = card_config(window_backend="ffd", packing_policy=policy)
        run = ControllerRun(catalog, device, cfg, PipelineConfig(chunk_items=0))
        try:
            base = config12_controller_pods(catalog, 416, "w")
            extra = affinity_controller_pods()
            # the match matrix is cached per (selectors, peers): a run after
            # the first would answer from the cache, not the program
            device_filter.clear_affinity_cache()
            with SchedulerLog() as log_lines:
                rec = run.window(base + extra)
            programs = {"affinity": device_filter.AFFINITY_RUNS, "policy": ops_policy.RUNS,
                        "pack_batch": pack_cuda.BATCH_LAUNCHES}
            nodes, zones, by_node = placement(run.kube)
        finally:
            run.stop()
        what = f"controller_affinity ({policy})"
        eni = {p.metadata.name for p in base if "vpc.amazonaws.com/pod-eni"
               in p.spec.containers[0].resources.requests}
        expected = [p.metadata.name for p in base + extra
                    if p.metadata.name not in eni and p.metadata.name not in AFFINITY_UNSAT]
        once_each([n for _, g in run.binds for n in g], expected, what)
        cache_nodes = {n for n, names in by_node.items() for x in names if x.startswith("cache-")}
        check(len(cache_nodes) == AFFINITY_REPLICAS,
              f"{what}: {AFFINITY_REPLICAS} cache replicas on {len(cache_nodes)} nodes")
        for k in range(AFFINITY_COHORTS):
            z = f"bench-zone-{1 + k % 3}"
            for kind in ("db", "web", "soft"):
                got = {zones[p.metadata.name] for p in extra
                       if p.metadata.name.startswith(f"{kind}-{k:02d}-")}
                check(got == {z}, f"{what}: cohort {kind}-{k} in zones {got}, anchor {z}")
        check(log_lines.affinity() == len(AFFINITY_UNSAT),
              f"{what}: {log_lines.affinity()} pods counted reason=affinity")
        check(rec["gang_windows"] == 0, f"{what}: {rec['gang_windows']} gang windows")
        check(rec["pressure_level"] == 0, f"{what}: pressure level {rec['pressure_level']}")
        check(programs["affinity"] >= 1 and programs["pack_batch"] >= 1
              and (programs["policy"] >= 1) == (policy != "cheapest"),
              f"{what}: programs {programs}")
        check(set(rec["executor_counts"]) <= {"device-batch", "device"},
              f"{what}: answered by {rec['executor_counts']}")
        # (a)-(e) alone, on the card and on the CPU
        alone = []
        for dev in (device, torch.device("cpu")):
            solo = ControllerRun(catalog, dev, cfg, PipelineConfig(chunk_items=0))
            try:
                solo.window(affinity_controller_pods())
                alone.append(placement(solo.kube)[0])
            finally:
                solo.stop()
        check(alone[0] == alone[1], f"{what}: the card's partition != the CPU's")
        runs[policy] = {**rec, "programs": programs, "nodes_total": sum(nodes.values()),
                        "unschedulable_eni": len(eni), "affinity_unsat": len(AFFINITY_UNSAT),
                        "alone_nodes": sum(alone[0].values()), "card_equals_cpu": True}
    rec = {"phase": "controller_affinity", "runs": runs,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


# -- gangs, torus carving and preemption (B10, B11, B4's rest) ----------------

# gang fuzz windows encoded by encode_gang_window: (kind, gangs, members);
# each is checked on the card against whatif_scan_plain bit for bit and
# against host_gang
GANG_FUZZ = [("one", 1, 1), ("max", 1, 4096), ("mixed", 40, 6), ("incompat", 24, 5),
             ("replicas", 32, 12), ("padded", 5, 7), ("carve", 48, 8), ("seeded", 16, 4),
             ("fail_then_place", 8, 3), ("wide", 65, 64), ("mixed", 300, 3),
             ("carve", 200, 16)]
# padded tensors in the gang ABI (GB, KB, BB): gang 0 fails then places
GANG_TENSOR_FUZZ = [(8, 4, 16), (64, 16, 512), (16, 32, 4096), (32, 8, 8192)]
# the fuzz's three member-sized types (cpu, memory Gi, pods, price)
GANG_TYPES = [("gf-4", 4, 8, 16, 1.0), ("gf-16", 16, 32, 64, 3.0), ("gf-64", 64, 256, 110, 10.0)]
# the full-width window: 1,024 gangs of 16 members, four to a node
GANG_FULL_G, GANG_FULL_K = 1024, 16
# carve_fuzz: (gangs, bins) checked on every cell against host_carve, then
# the window checked against a numpy evaluation per (slice class, bin) and
# CARVE_PROBE_CELLS cells of scalar_carve_cell
CARVE_FUZZ = [(4, 8), (16, 64), (64, 256), (256, 1024)]
CARVE_FULL = (1024, 4096)
CARVE_PROBE_CELLS = 4096
CARVE_GRIDS = [(4, 4), (4, 8), (2, 2, 4), (8, 8), None]
CARVE_SLICES = [(2, 2), (2, 4), (4, 4), (2, 2, 2), (1, 4), (4, 8), None]
# controller_gang: slice gangs per shape with their members, plain gangs,
# plain pods (over three zones), the second wave, the preemption windows
CG_SLICES = [("v5e-2x4", 8), ("v5e-4x4", 16), ("v4-2x2x2", 8)]
CG_PER_SHAPE, CG_PLAIN_GANGS, CG_PLAIN_PODS = 32, 48, 4096
CG_WAVE2, CG_PREEMPT_WINDOWS = 32, 4


def gang_catalog(types=GANG_TYPES):
    """Types of (name, cpu, memory Gi, pods, price[, TPU topology])."""
    from karpenter_tpu_torch.cloudprovider.spi import make_instance_type

    return [make_instance_type(t[0], cpu=str(t[1]), memory=f"{t[2]}Gi", pods=str(t[3]),
                               price=t[4], tpu_topology=t[5] if len(t) > 5 else "")
            for t in types]


def gang_window_encoding(catalog, gangs, **kwargs):
    """encode_gang_window over ``catalog``'s packables (type total minus
    overhead, as the controller takes them) for ``gangs`` = (key, pods,
    type mask or None for every type); with ``slices`` the types' torus
    grids go with them, in the packables' order."""
    import numpy as np

    from karpenter_tpu_torch.ops.gang import encode_gang_window
    from karpenter_tpu_torch.solver.adapter import build_packables
    from karpenter_tpu_torch.solver.solve import universe_constraints

    pods = [p for _, ps, _ in gangs for p in ps]
    packables, types = build_packables(catalog, universe_constraints(catalog), pods, ())
    frees = [[t - r for t, r in zip(pk.total, pk.reserved)] for pk in packables]
    window = [(key, ps, np.ones(len(types), bool) if mask is None else mask, None)
              for key, ps, mask in gangs]
    if "slices" in kwargs:
        kwargs["type_grids"] = [it.grid_dims() for it in types]
    return encode_gang_window(window, frees, [it.price for it in types],
                              [it.name for it in types], **kwargs)


def gang_fuzz_encoding(rng, kind, G, K):
    """One GANG_FUZZ window. Members are drawn in millicores and MiB;
    ``incompat`` zeroes some gangs' compat rows (host and device alike),
    ``replicas`` gives each gang one member shape, ``carve`` declares
    slices on TPU grids, ``seeded`` adds fragmented seed bins,
    ``fail_then_place`` seeds bins where a gang's first member fits nowhere
    and its second does (no fresh growth), ``wide`` needs 64 bins a gang
    (BB = 8192, the global kernel)."""
    from karpenter_tpu_torch.ops.gang import GangBin
    from karpenter_tpu_torch.ops.whatif import _reserve_vec

    catalog = gang_catalog()
    kwargs = {}

    def member(i):
        if kind == "max":
            return _pod(100, 128)
        if kind == "wide":
            return _pod(3500, 4096)
        return _pod(int(rng.integers(100, 3000)), int(rng.integers(128, 6000)))

    gangs = []
    for g in range(G):
        size = K if kind in ("max", "wide", "replicas", "one") else int(rng.integers(1, K + 1))
        pods = [member(i) for i in range(size)]
        if kind == "replicas":
            shape = (int(rng.integers(100, 3000)), int(rng.integers(128, 6000)))
            pods = [_pod(*shape) for _ in range(size)]
        for i, p in enumerate(pods):
            p.metadata.name = f"gf-{kind}-{g}-m{i}"
        mask = None
        if kind in ("mixed", "incompat"):
            mask = rng.random(len(catalog)) < 0.7
            mask[-1] = True
        gangs.append((("gf", f"{kind}-{g}"), pods, mask))
    if kind in ("carve", "seeded"):
        # the 4x4 type sorts first (fewest cpus): seed bins are its
        catalog = gang_catalog([("gf-v5e-4x4", 32, 64, 32, 4.0, "v5e-4x4"),
                                ("gf-v5e-4x8", 64, 128, 64, 8.0, "v5e-4x8"),
                                ("gf-v4", 64, 96, 64, 6.0, "v4-2x2x4")])
        slices = [[(2, 2), (2, 4), (4, 4), (1, 2), None][int(rng.integers(0, 5))]
                  for _ in range(G)]
        kwargs.update(slices=slices, bands=["default"] * G)
    if kind == "seeded":
        unit = _reserve_vec(_pod(1000, 1024))
        kwargs["seed_bins"] = [GangBin(
            name=f"seed-{j}", type_index=0, free=[v * 20 for v in unit], grid=(4, 4),
            occ=rng.random(16) < [0.0, 0.3, 0.6][j % 3], node_name=f"seed-{j}")
            for j in range(12)]
    if kind == "fail_then_place":
        unit = _reserve_vec(_pod(1000, 1024))
        kwargs.update(grow=False, seed_bins=[GangBin(
            name=f"seed-{j}", type_index=0, free=[v * (2 + j) for v in unit],
            node_name=f"seed-{j}") for j in range(4)])
        for g, (_, pods, _) in enumerate(gangs):
            pods[:] = [_pod(9000, 1024), _pod(1000, 1024)] + pods[2:]
            for i, p in enumerate(pods):
                p.metadata.name = f"gf-ftp-{g}-m{i}"
    enc = gang_window_encoding(catalog, gangs, **kwargs)
    if kind == "incompat":
        dead = rng.random(enc.g) < 0.3
        enc.compat[dead] = False
        enc.d_compat[:enc.g][dead] = False
    return enc


def check_gang_host(enc, feas, slots, what):
    """feasible equal to host_gang's (on the carve verdict of host_carve),
    the slots on feasible rows too; returns host_gang's seconds."""
    import numpy as np

    from karpenter_tpu_torch.ops.gang import host_gang
    from karpenter_tpu_torch.ops.topology import host_carve

    t0 = time.perf_counter()
    host_feas, host_slots = host_gang(enc, host_carve(enc.carve) if enc.carve else None)
    seconds = time.perf_counter() - t0
    check(np.array_equal(feas, host_feas), f"{what}: feasible != host_gang")
    check(np.array_equal(slots[feas], host_slots[feas]), f"{what}: slots != host_gang on "
          "feasible rows")
    return seconds


def gang_bound(enc, compat, slots):
    """Least time for one gang window, as this run's data needs it: first
    fit stops at the bin a member took, or tests every bin when the member
    fit nowhere. A gang reaches the furthest bin one of its members tests.
    Bytes: each valid member's vector (R int32), valid flag and slot; each
    gang's compat row up to its reach (a byte a bin) and its verdict; the
    free0 rows of the bins some gang reaches that are compatible with it,
    read once. Operations: each valid member tests R compares and the
    compat bit on the compatible bins up to the one it took. ``compat`` is
    the (GB, BB) rows the kernel read (the carve verdict ANDed in),
    ``slots`` its answer."""
    import numpy as np

    R = enc.d_pods.shape[2]
    live = compat[:enc.g, :enc.b]
    upto = np.cumsum(live, axis=1)                        # compatible bins <= b
    reach = np.full(enc.g, -1)
    members = tested = 0
    for e in enc.gangs:
        row, k = upto[e.index], len(e.vecs)
        s = slots[e.index, :k]
        members += k
        tested += int(np.where(s >= 0, row[np.clip(s, 0, enc.b - 1)], row[-1]).sum())
        if k:
            reach[e.index] = enc.b - 1 if (s < 0).any() else int(s.max())
    rows = int((live & (np.arange(enc.b)[None, :] <= reach[:, None])).any(0).sum())
    nbytes = members * (R * 4 + 1 + 4) + int((reach + 1).sum()) + enc.g + rows * R * 4
    ops = tested * (R + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "free0_rows": rows, "max_reach": int(reach.max()),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gang_tensor_case(rng, GB, KB, BB, device):
    """Padded gang-ABI tensors: scattered valid members, padded gangs (no
    valid member), an all-incompatible row, runs of identical members, free
    rows that may be zero; gang 0 fails then places (its first member fits
    nowhere, its second fits bin 1)."""
    import numpy as np
    import torch

    R = 8
    pods = np.zeros((GB, KB, R), np.int32)
    pods[:, :, 0] = rng.integers(1, 400, (GB, KB))
    pods[:, :, 1] = rng.integers(1, 400, (GB, KB))
    pods[:, :, 2] = 1
    pods[1] = pods[1, :1]
    valid = np.arange(KB)[None, :] < rng.integers(0, KB + 1, GB)[:, None]
    valid[rng.random(GB) < 0.2] = rng.random(KB) < 0.5
    valid[-1] = False
    compat = rng.random((GB, BB)) < rng.choice([0.3, 0.7, 1.0])
    compat[2] = False
    free0 = np.zeros((BB, R), np.int32)
    free0[:, 0] = rng.integers(0, 440 if BB >= 8192 else 1200, BB)
    free0[:, 1] = rng.integers(0, 440 if BB >= 8192 else 1200, BB)
    free0[:, 2] = rng.integers(0, 6, BB)
    pods[0, 0, :2] = 10**6
    pods[0, 1, :3] = (1, 1, 1)
    valid[0, :2] = True
    compat[0, :2] = (False, True)
    free0[1, :3] = (10**5, 10**5, 10)
    return [torch.from_numpy(a).to(device) for a in (pods, valid, compat, free0)]


def phase_gang_fuzz(device):
    """B10 on the card: each GANG_FUZZ window through dispatch_gang_window
    (executor "device-gang") against whatif_scan_plain on the tensors the
    window launched (GangHandle.inputs) bit for bit, and against host_gang
    (feasible, and the slots of feasible rows); then GANG_TENSOR_FUZZ's
    padded tensors through gang_scan against the plain version, gang 0
    failing then placing."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.solver import topology as topo_solver
    from karpenter_tpu_torch.solver.gang import dispatch_gang_window, gang_inputs

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    heals0 = topo_solver.HEALS
    cases, worst = [], 0
    for kind, G, K in GANG_FUZZ:
        enc = gang_fuzz_encoding(rng, kind, G, K)
        what = f"gang fuzz {kind} {G}x{K}"
        check(enc.device_ready and enc.g > 0, f"{what}: not device-encodable ({enc.skipped[:2]})")
        handle = dispatch_gang_window(enc, device)
        feas, slots, executor = handle.fetch()
        check(executor == "device-gang", f"{what}: executor {executor}")
        args = gang_inputs(*handle.inputs)
        card = wc.whatif_scan(*args)
        plain = wc.whatif_scan_plain(*args)
        torch.cuda.synchronize()
        err = whatif_diff(card, plain)
        worst = max(worst, err)
        check(err == 0, f"{what}: kernel != plain")
        check(np.array_equal(feas, plain[0].cpu().numpy()[:enc.g])
              and np.array_equal(slots, plain[1].cpu().numpy()[:enc.g, :max(enc.k, 1)]),
              f"{what}: the window's answer != plain")
        host_s = check_gang_host(enc, feas, slots, what)
        if kind == "fail_then_place":
            check(not feas[0] and slots[0, 0] == -1 and slots[0, 1] >= 0,
                  f"{what}: gang 0 gave {bool(feas[0])}, {slots[0, :2].tolist()}")
        shape = list(enc.d_pods.shape[:2]) + [enc.d_free0.shape[0]]
        cases.append({"kind": kind, "gangs": enc.g, "k": enc.k, "bins": enc.b, "shape": shape,
                      "kernel": wc.launch_geometry(shape[2])["kernel"],
                      "feasible": int(feas.sum()), "carve": enc.carve is not None,
                      "host_gang_s": host_s})
        del handle, args, card, plain
    for GB, KB, BB in GANG_TENSOR_FUZZ:
        pods, valid, compat, free0 = gang_tensor_case(rng, GB, KB, BB, device)
        args = gang_inputs(pods, valid, compat, free0)
        card, plain = wc.whatif_scan(*args), wc.whatif_scan_plain(*args)
        torch.cuda.synchronize()
        err = whatif_diff(card, plain)
        worst = max(worst, err)
        what = f"gang fuzz tensors {GB}x{KB}x{BB}"
        check(err == 0, f"{what}: kernel != plain")
        check(not bool(plain[0][0]) and int(plain[1][0, 1]) == 1 and bool(plain[0][-1]),
              f"{what}: gang 0 or the padded gang wrong")
        cases.append({"kind": "tensors", "shape": [GB, KB, BB],
                      "kernel": wc.launch_geometry(BB)["kernel"],
                      "feasible": int(plain[0].sum())})
        del args, card, plain
        torch.cuda.empty_cache()
    check(topo_solver.HEALS == heals0, "gang fuzz: a carve probe healed")
    rec = {"phase": "gang_fuzz", "cases": cases, "max_abs_err": worst, "heals": 0,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def config11_gang_encoding(device, G=256):
    """config_11's window (bench.py:1068-1172): G gangs of 2-4 heavyweight
    members (2, 4 and 6 cpu) over the 100-type catalog, the gang column
    from the member key on the card."""
    from karpenter_tpu_torch.ops.feasibility import gang_feasibility_mask
    from karpenter_tpu_torch.ops.gang import encode_gang_window
    from karpenter_tpu_torch.solver import adapter
    from karpenter_tpu_torch.solver.solve import universe_constraints

    catalog = make_catalog(100)
    constraints = universe_constraints(catalog)
    shapes = [(2000, 2048), (4000, 4096), (6000, 6144)]
    gangs, all_pods = [], []
    for gi in range(G):
        k = (2, 3, 4)[gi % 3]
        members = make_pods(k, [shapes[(gi + j) % 3] for j in range(k)])
        for j, p in enumerate(members):
            p.metadata.name = f"gang-{gi}-m{j}"
        all_pods += members
        gangs.append((f"gang-{gi}", members))
    packables, types = adapter.build_packables(catalog, constraints, all_pods, ())
    frees = [[t - r for t, r in zip(pk.total, pk.reserved)] for pk in packables]
    mask = gang_feasibility_mask(types, [(adapter._allowed_sets(constraints),
                                          adapter._required_resources(all_pods))],
                                 device=device)
    return encode_gang_window([(key, pods, mask, None) for key, pods in gangs], frees,
                              [it.price for it in types], [it.name for it in types])


def full_gang_encoding():
    """The full-width window: GANG_FULL_G gangs of GANG_FULL_K members
    (3.5 cpu, 8 Gi), four to a node of their cheapest type (16 cpu), so
    4,096 bins and GB × KB × BB = 2**26 = MAX_WINDOW_CELLS."""
    catalog = gang_catalog([("gw-16", 16, 64, 110, 0.8), ("gw-32", 32, 128, 110, 1.7),
                            ("gw-64", 64, 256, 110, 3.5)])
    gangs = []
    for g in range(GANG_FULL_G):
        pods = make_pods(GANG_FULL_K, [(3500, 8192)])
        for i, p in enumerate(pods):
            p.metadata.name = f"full-{g}-m{i}"
        gangs.append((("full", f"g{g}"), pods, None))
    return gang_window_encoding(catalog, gangs)


def plan_nodes(plan):
    """A plan node for node: each placement's gang and (bin, member names)."""
    return [(pl.gang.key, [(bi, [p.metadata.name for p in ps]) for bi, ps in pl.node_sets])
            for pl in plan.placements]


def gang_kernel_record(enc, handle, runs):
    """One window's kernel on the tensors its dispatch launched
    (``handle.inputs``): the card against the plain version (0 when bit for
    bit), the CUDA-event median of ``runs`` warm launches (the wrapper's
    host work between the events included), the mean device ms under
    torch.profiler (with the kernels its accepted or last session saw),
    the device ms of ``runs`` launches queued behind a spin kernel, the
    plain version's event ms over 3 and the bound. Comparison launches:
    the count is restored."""
    import torch

    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.solver.gang import gang_inputs

    launches = wc.LAUNCHES
    args = gang_inputs(*handle.inputs)
    plain = wc.whatif_scan_plain(*args)
    err = whatif_diff(wc.whatif_scan(*args), plain)
    torch.cuda.synchronize()
    bound = gang_bound(enc, handle.inputs[2].cpu().numpy(), plain[1].cpu().numpy())
    ms = median_event_ms(lambda: wc.whatif_scan(*args), runs)
    device_ms, seen = profiled_kernel_ms(lambda: wc.whatif_scan(*args), runs, "whatif")
    queued_ms = queued_event_ms(lambda: wc.whatif_scan(*args), runs)
    plain_ms = median_event_ms(lambda: wc.whatif_scan_plain(*args), 3)
    wc.LAUNCHES = launches
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms, "profiled_launches": seen,
            "queued_ms": queued_ms, "plain_ms": plain_ms,
            "shape": list(args[2].shape), "gangs": enc.g, "bins": enc.b,
            "geometry": wc.launch_geometry(args[2].shape[2]), **bound}


def gang_window_record(enc, device, what, runs):
    """A window through dispatch_gang_window on the card: executor, the
    kernel equal to its plain version, feasible equal to host_gang's, the
    card-filtered plan equal to plan_gang_window(enc, None) node for node;
    the host seconds of host_gang and of both plans, and the kernel's
    record."""
    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.solver.gang import dispatch_gang_window, plan_gang_window

    launches = wc.LAUNCHES
    t0 = time.perf_counter()
    handle = dispatch_gang_window(enc, device)
    feas, slots, executor = handle.fetch()
    window_s = time.perf_counter() - t0
    check(executor == "device-gang" and wc.LAUNCHES == launches + (device.type == "cuda"),
          f"{what}: executor {executor}, {wc.LAUNCHES - launches} launches")
    host_s = check_gang_host(enc, feas, slots, what)
    t0 = time.perf_counter()
    plan = plan_gang_window(enc, feas)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = plan_gang_window(enc, None)
    plain_plan_s = time.perf_counter() - t0
    check(plan_nodes(plan) == plan_nodes(plain), f"{what}: filtered plan != host plan")
    check(plan.verified >= len(plan.placements), f"{what}: unverified placements")
    kern = gang_kernel_record(enc, handle, runs)
    check(kern["max_abs_err"] == 0, f"{what}: kernel != plain")
    return {"gangs": enc.g, "members": sum(len(e.vecs) for e in enc.gangs), "bins": enc.b,
            "cells": enc.cells, "executor": executor, "feasible": int(feas.sum()),
            "placed": len(plan.placements), "unplaced": len(plan.unplaced),
            "window_s": window_s, "kernel_ms_in_window": handle.kernel_ms,
            "host_gang_s": host_s, "plan_s": plan_s, "plan_unfiltered_s": plain_plan_s,
            "kernel": kern}


def phase_gang_window(device):
    """B10 on config_11's window (256 gangs) and on the full-width window
    (1,024 × 16 × 4,096 cells): gang_window_record on each."""
    t_phase = time.perf_counter()
    out = {}
    for what, build in (("config11", lambda: config11_gang_encoding(device)),
                        ("full", full_gang_encoding)):
        t0 = time.perf_counter()
        enc = build()
        encode_s = time.perf_counter() - t0
        check(enc.device_ready and not enc.skipped, f"gang_window {what}: encoding")
        out[what] = {"encode_s": encode_s, **gang_window_record(enc, device, f"gang_window "
                                                                f"{what}", WARM_RUNS)}
    full_bins = 4 * GANG_FULL_G
    check(out["full"]["cells"] == GANG_FULL_G * GANG_FULL_K * full_bins
          and out["full"]["bins"] == full_bins,
          f"gang_window full: {out['full']['cells']} cells, {out['full']['bins']} bins")
    rec = {"phase": "gang_window", **out, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


class _CarveGang:
    def __init__(self, index, slice_dims):
        self.index, self.slice_dims = index, slice_dims


class _CarveBin:
    def __init__(self, grid, occ):
        self.grid, self.occ = grid, occ


class _CarveEnc:
    def __init__(self, gangs, bins):
        self.gangs, self.bins, self.g, self.b = gangs, bins, len(gangs), len(bins)


def carve_fuzz_enc(rng, G, B):
    """G gangs over CARVE_SLICES and B bins over CARVE_GRIDS, occupancy at
    0-90 % (some bins empty, some nearly full), as ops/topology.encode_carve
    takes them."""
    from karpenter_tpu_torch.ops.topology import grid_cells

    bins = []
    for _ in range(B):
        grid = CARVE_GRIDS[int(rng.integers(0, len(CARVE_GRIDS)))]
        occ = None if grid is None else \
            rng.random(grid_cells(grid)) < [0.0, 0.2, 0.5, 0.9][int(rng.integers(0, 4))]
        bins.append(_CarveBin(grid, occ))
    gangs = [_CarveGang(i, CARVE_SLICES[int(rng.integers(0, len(CARVE_SLICES)))])
             for i in range(G)]
    return _CarveEnc(gangs, bins)


def carve_numpy(cv):
    """The verdict as numpy per (slice class, bin): each slice class's bank
    on each bin's grid class against its plane, then rows by class."""
    import numpy as np

    S = max(len(cv.slice_classes), 1)
    per = np.zeros((S, cv.b), bool)
    for s in range(S):
        for c in range(len(cv.classes)):
            on = np.flatnonzero(cv.cls_of == c)
            if not len(on):
                continue
            overlap = (cv.pmask[s, c][None, :, :] & cv.occ0[on][:, None, :]).any(-1)
            per[s, on] = (cv.pvalid[s, c][None, :] & ~overlap).any(-1)
    rows = per[np.maximum(cv.scls_of, 0)]
    return np.where(cv.scls_of[:, None] >= 0, rows, True)


def carve_program_record(cv, device, runs):
    """B11 on one window's padded arrays: CUDA-event median over ``runs``,
    kernels and idle share (torch.profiler), the bound by bytes (each bin's
    plane and each bank bit-packed, the class ids, the (G, B) bool
    verdict) and the same program on the CPU."""
    import torch

    from karpenter_tpu_torch.backend import to_device_int32
    from karpenter_tpu_torch.solver import topology as topo_solver

    card = to_device_int32(topo_solver.carve_arrays(cv), device)
    cpu = to_device_int32(topo_solver.carve_arrays(cv), torch.device("cpu"))
    ms = median_event_ms(lambda: topo_solver.carve_program(*card), runs)
    launches = device_launches(lambda: topo_solver.carve_program(*card))
    t0 = time.perf_counter()
    topo_solver.carve_program(*cpu)
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    S, NC, P = cv.pvalid.shape
    nbytes = (cv.b * cv.c + S * NC * P * (cv.c + 1)) / 8 + 4 * (cv.b + cv.g) + cv.g * cv.b
    return {"shape": [cv.g, cv.b], "padded": [int(cv.d_scls.shape[0]), int(cv.d_occ.shape[0]),
                                              *map(int, cv.d_pmask.shape)],
            "ms": ms, "cpu_ms": cpu_ms, "launches_per_call": launches, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def member_column_record(device, runs):
    """The gang member column (B4's rest) on config_11's 100-type catalog
    with four member keys: CUDA-event median, kernels and idle share, the
    bound by bytes (the planes, the keys' rows, the (T,) column) and the
    CPU time; equal to the scalar oracle."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import device_filter
    from karpenter_tpu_torch.ops.feasibility import gang_scalar_mask
    from karpenter_tpu_torch.solver.solve import universe_constraints
    from karpenter_tpu_torch.solver import adapter

    catalog = make_catalog(100)
    cts, zones, names, archs, oss = adapter._allowed_sets(universe_constraints(catalog))
    keys = [((cts, zones, names, archs, oss), frozenset()),
            ((cts, zones, frozenset(sorted(names)[10:]), archs, oss), frozenset()),
            ((frozenset(["on-demand"]), zones, names, archs, oss), frozenset()),
            ((cts, frozenset(sorted(zones)[1:]), names, archs, oss), frozenset())]
    col = device_filter.gang_member_column(catalog, keys, device)
    check(np.array_equal(col, gang_scalar_mask(catalog, keys, None)) and 0 < col.sum() < len(col),
          f"member column != the scalar oracle ({int(col.sum())} types)")
    ms = median_event_ms(lambda: device_filter.gang_member_column(catalog, keys, device), runs)
    launches = device_launches(lambda: device_filter.gang_member_column(catalog, keys, device))
    t0 = time.perf_counter()
    device_filter.gang_member_column(catalog, keys, torch.device("cpu"))
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    planes = device_filter.planes_for(catalog)
    nbytes = sum(a.nbytes for a in planes.host_arrays().values()) + len(keys) * 4 * (
        planes.name_plane.shape[1] + planes.arch_plane.shape[1] + planes.os_plane.shape[1]
        + planes.offer_plane.shape[2] + 2) + planes.n
    return {"shape": [len(keys), planes.n], "ms": ms, "cpu_ms": cpu_ms,
            "launches_per_call": launches, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "feasible_types": int(col.sum())}


def phase_carve_fuzz(device):
    """B11 on the card: CARVE_FUZZ windows against host_carve on every cell
    (and the padded rows and bins: True for gangs without a slice class,
    False on bins without a grid); CARVE_FULL (1,024 gangs × 4,096 bins)
    against carve_numpy on every cell and CARVE_PROBE_CELLS cells of
    scalar_carve_cell; solve_carve_window on it with 0 heals; then the
    program timed at CARVE_FULL and the member column timed."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.backend import to_device_int32
    from karpenter_tpu_torch.ops.topology import encode_carve, host_carve, scalar_carve_cell
    from karpenter_tpu_torch.ops.whatif import _pow2
    from karpenter_tpu_torch.solver import topology as topo_solver

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    heals0, cases = topo_solver.HEALS, []
    for G, B in CARVE_FUZZ + [CARVE_FULL]:
        enc = carve_fuzz_enc(rng, G, B)
        cv = encode_carve(enc, gb=_pow2(G), bb=_pow2(B))
        out = topo_solver.carve_program(*to_device_int32(topo_solver.carve_arrays(cv), device))
        got = out.cpu().numpy()
        live = got[:G, :B]
        t0 = time.perf_counter()
        want = host_carve(cv) if (G, B) != CARVE_FULL else carve_numpy(cv)
        ref_s = time.perf_counter() - t0
        diverged = int((live != want).sum())
        check(diverged == 0, f"carve fuzz {G}x{B}: {diverged} cells differ")
        check(got[G:].all() and not got[:G, B:][cv.scls_of >= 0].any(),
              f"carve fuzz {G}x{B}: padded rows or bins wrong")
        probes = 0
        if (G, B) == CARVE_FULL:
            for _ in range(CARVE_PROBE_CELLS):
                gi, bi = int(rng.integers(0, G)), int(rng.integers(0, B))
                check(scalar_carve_cell(enc, gi, bi) == bool(live[gi, bi]),
                      f"carve fuzz: cell ({gi}, {bi}) != scalar_carve_cell")
                probes += 1
            enc.carve = cv
            verdict, executor = topo_solver.solve_carve_window(enc, device)
            check(executor == "device-carve" and np.array_equal(verdict, live),
                  f"carve fuzz: solve_carve_window gave {executor}")
        cases.append({"gangs": G, "bins": B, "true_cells": int(live.sum()),
                      "reference": "host_carve" if (G, B) != CARVE_FULL else "numpy",
                      "reference_s": ref_s, "probe_cells": probes})
        del out
        torch.cuda.empty_cache()
    check(topo_solver.HEALS == heals0, "carve fuzz: a probe healed")
    rec = {"phase": "carve_fuzz", "cases": cases, "divergent_cells": 0, "heals": 0,
           "max_abs_err": 0, "program": carve_program_record(cv, device, WARM_RUNS),
           "member_column": member_column_record(device, WARM_RUNS),
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def phase_carve_window(device):
    """config_16's legs (bench.py:1905-2168) on the port, gang windows
    through dispatch_gang_window on the card. Fragmentation A/B on a
    saturated 4x4 fleet without fresh growth (4 empty, 8 with a clean 2x4
    slab, 8 checkerboarded): the carve walk places at least 20 % more
    gangs than the shape-only baseline (empty nodes only), and every
    phantom (a checkerboarded node the naive shape-only walk uses) is
    rejected; the commit audit: every carve one placement-mask row,
    disjoint from the replayed plane (0 unverified); the program against
    scalar_carve at 64 × 64 (0 divergence) with both times; priced
    preemption on three saturated nodes: at least one preemption, none of
    the system-critical resident, the $10 victim declined (fresh-cheaper);
    the kill switch: carving off, and an annotation-free encode equal to
    the shape-only one bit for bit. 0 heals."""
    import numpy as np

    from karpenter_tpu_torch.ops import gang as ops_gang
    from karpenter_tpu_torch.ops import topology as topo
    from karpenter_tpu_torch.ops.gang import GangBin
    from karpenter_tpu_torch.ops.whatif import _reserve_vec
    from karpenter_tpu_torch.solver import gang as solver_gang
    from karpenter_tpu_torch.solver import topology as topo_solver
    from karpenter_tpu_torch.solver.gang import (
        PreemptCandidate, PreemptContext, dispatch_gang_window, plan_gang_window)

    t_phase = time.perf_counter()
    heals0 = topo_solver.HEALS
    GRID, CELLS = (4, 4), 16
    mvec = [max(v, 1) for v in _reserve_vec(_pod(4000, 8192))]

    def chips(n):
        return [v * n for v in mvec]

    names, prices, frees = ["tpu-carve-4x4"], [4.0], [chips(CELLS)]

    def gangs_of(n, members, prefix, slice_dims, band="default"):
        out = []
        for i in range(n):
            pods = make_pods(members, [(4000, 8192)])
            for j, p in enumerate(pods):
                p.metadata.name = f"{prefix}{i}-m{j}"
            out.append(((f"cw-{prefix}", f"g{i}"), pods, np.ones(1, bool), None))
        return out, [slice_dims] * n, [band] * n

    def seed(name, occ):
        occ = np.asarray(occ, bool)
        return GangBin(name=name, type_index=0, free=chips(int(CELLS - occ.sum())), grid=GRID,
                       occ=occ, node_name=name)

    def card_plan(enc, preempt=None):
        feas, _, executor = dispatch_gang_window(enc, device).fetch()
        check(executor == "device-gang", f"carve_window: executor {executor}")
        plan = plan_gang_window(enc, feas, preempt)
        return plan

    rows01 = np.zeros(CELLS, bool)
    rows01[:8] = True
    checker = np.array([(r + c) % 2 == 0 for r in range(4) for c in range(4)])

    def fleet(kinds):
        return ([seed(f"n-empty-{i}", np.zeros(CELLS, bool)) for i in range(4) if "empty" in kinds]
                + [seed(f"n-contig-{i}", rows01) for i in range(8) if "contig" in kinds]
                + [seed(f"n-scatter-{i}", checker) for i in range(8) if "scatter" in kinds])

    # leg 1: fragmentation A/B and the phantom
    G = 24
    gangs, slices, bands = gangs_of(G, 8, "frag", (2, 4))
    rej0 = ops_gang.CARVE_REJECTS
    enc_carve = ops_gang.encode_gang_window(
        gangs, frees, prices, names, slices=slices, bands=bands, type_grids=[GRID],
        seed_bins=fleet({"empty", "contig", "scatter"}), grow=False)
    plan_carve = card_plan(enc_carve)
    carve_rejects = ops_gang.CARVE_REJECTS - rej0
    carve_placed = len(plan_carve.placements)
    on_scatter = sum(1 for pl in plan_carve.placements for bi, _ in pl.node_sets
                     if enc_carve.bins[bi].name.startswith("n-scatter"))
    # commit audit: every carve one placement-mask row, disjoint from the plane
    unverified, replay = 0, {}
    for pl in plan_carve.placements:
        for bi, cells in pl.carves.items():
            bn = enc_carve.bins[bi]
            base = replay.setdefault(bi, bn.occ.copy())
            want = np.zeros(CELLS, bool)
            want[list(cells)] = True
            masks = topo.placement_masks(bn.grid, pl.gang.slice_dims)
            if masks is None or not any(np.array_equal(r, want) for r in masks) \
                    or base[list(cells)].any():
                unverified += 1
            base[list(cells)] = True
    gangs_a, _, _ = gangs_of(G, 8, "frag", None)
    shape_bins = [GangBin(name=s.name, type_index=0, free=list(s.free), node_name=s.name)
                  for s in fleet({"empty"})]
    shape_placed = len(card_plan(ops_gang.encode_gang_window(
        gangs_a, frees, prices, names, seed_bins=shape_bins, grow=False)).placements)
    gangs_n, _, _ = gangs_of(G, 8, "frag", None)
    naive_bins = [GangBin(name=s.name, type_index=0, free=list(s.free), node_name=s.name)
                  for s in fleet({"empty", "contig", "scatter"})]
    enc_naive = ops_gang.encode_gang_window(gangs_n, frees, prices, names,
                                            seed_bins=naive_bins, grow=False)
    phantom = sum(1 for pl in card_plan(enc_naive).placements
                  if any(enc_naive.bins[bi].name.startswith("n-scatter") for bi, _ in pl.node_sets))
    gain_pct = 100.0 * (carve_placed - shape_placed) / max(shape_placed, 1)
    check(gain_pct >= 20.0, f"carve_window: {carve_placed} placed vs {shape_placed} shape-only")
    check(phantom > 0 and on_scatter == 0 and carve_rejects >= 8,
          f"carve_window: phantom {phantom}, carve on scatter {on_scatter}, "
          f"rejects {carve_rejects}")
    check(unverified == 0, f"carve_window: {unverified} unverified carves")

    # leg 2: the program against the scalar scan at 64 x 64
    kgangs, kslices, kbands = gangs_of(64, 4, "kern", (2, 2))
    kseeds = []
    for j in range(64):
        occ = np.zeros(CELLS, bool)
        occ[[(j * 7 + 3 * k) % CELLS for k in range(j % 10)]] = True
        kseeds.append(seed(f"n-kern-{j}", occ))
    enc_k = ops_gang.encode_gang_window(kgangs, frees, prices, names, slices=kslices,
                                        bands=kbands, type_grids=[GRID], seed_bins=kseeds,
                                        grow=False)
    verdict, kexec = topo_solver.solve_carve_window(enc_k, device)
    t0 = time.perf_counter()
    scalar = topo.scalar_carve(enc_k)
    scalar_ms = (time.perf_counter() - t0) * 1000.0
    divergence = int((verdict != scalar).sum())
    check(kexec == "device-carve" and divergence == 0,
          f"carve_window: program {kexec}, {divergence} cells != scalar_carve")
    program_ms = median_event_ms(lambda: topo_solver.dispatch_carve_window(
        enc_k, device)._out, WARM_RUNS)

    # leg 3: priced preemption on three saturated nodes
    sat = [seed(f"p-sat-{i}", np.ones(CELLS, bool)) for i in range(3)]

    def victim(bi, band, cost):
        return PreemptCandidate(gang_key=("cw-victim", f"v{bi}"), bin_index=bi,
                                node=f"p-sat-{bi}", band=band,
                                pods=[("default", f"v{bi}-m{k}") for k in range(8)],
                                cells=np.arange(8), refund=chips(8), displacement_cost=cost)

    ctx = PreemptContext([victim(0, "low", 0.25), victim(1, "system-critical", 0.0),
                          victim(2, "low", 10.0)])
    pgangs, pslices, pbands = gangs_of(2, 8, "pre", (2, 4), band="high")
    enc_p = ops_gang.encode_gang_window(pgangs, frees, prices, names, slices=pslices,
                                        bands=pbands, type_grids=[GRID], seed_bins=sat, grow=True)
    solver_gang.DECLINES.clear()
    plan_p = card_plan(enc_p, ctx)
    declines = dict(solver_gang.DECLINES)
    sc = sum(1 for _, c in plan_p.preemptions if c.band == "system-critical")
    dear_taken = any(c.displacement_cost == 10.0 for _, c in plan_p.preemptions)
    check(len(plan_p.preemptions) >= 1 and sc == 0 and not dear_taken
          and declines.get("fresh-cheaper", 0) >= 1,
          f"carve_window: preemptions {len(plan_p.preemptions)}, system-critical {sc}, "
          f"declines {declines}")

    # leg 4: the kill switch
    prev = os.environ.get("KARPENTER_TOPOLOGY_CARVE")
    try:
        os.environ["KARPENTER_TOPOLOGY_CARVE"] = "0"
        killswitch = not topo_solver.carve_enabled()
    finally:
        if prev is None:
            os.environ.pop("KARPENTER_TOPOLOGY_CARVE", None)
        else:
            os.environ["KARPENTER_TOPOLOGY_CARVE"] = prev
    ks_a, _, _ = gangs_of(6, 4, "ks", None)
    ks_b, sl_b, bd_b = gangs_of(6, 4, "ks", None)
    enc_a = ops_gang.encode_gang_window(ks_a, frees, prices, names)
    enc_b = ops_gang.encode_gang_window(ks_b, frees, prices, names, slices=sl_b, bands=bd_b,
                                        type_grids=[GRID])
    parity = enc_b.carve is None and all(
        np.array_equal(getattr(enc_a, f), getattr(enc_b, f))
        for f in ("d_pods", "d_valid", "d_compat", "d_free0")) and \
        plan_nodes(card_plan(enc_a)) == plan_nodes(card_plan(enc_b))
    check(killswitch and parity, f"carve_window: kill switch {killswitch}, parity {parity}")
    check(topo_solver.HEALS == heals0, "carve_window: a carve probe healed")
    rec = {"phase": "carve_window", "gangs": G, "shape_only_placed": shape_placed,
           "carve_placed": carve_placed, "gain_pct": gain_pct, "phantom_gangs_naive": phantom,
           "carve_rejects": carve_rejects, "unverified": unverified,
           "kernel_divergence": divergence, "program_ms": program_ms, "scalar_ms": scalar_ms,
           "preemptions": len(plan_p.preemptions), "system_critical_preemptions": sc,
           "preempt_declines": declines, "preempt_placed": len(plan_p.placements),
           "killswitch": killswitch, "killswitch_parity": parity, "heals": 0,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def cg_pod(name, cpu_m, mem_mi, labels=None, priority=0, zone=None):
    """A pending, unschedulable pod of the controller_gang window: its
    labels, priority and zone selector."""
    from karpenter_tpu_torch.api import core as c
    from karpenter_tpu_torch.api import wellknown as wk

    return c.Pod(
        metadata=c.ObjectMeta(name=name, uid=name, labels=dict(labels or {})),
        spec=c.PodSpec(containers=[c.Container(resources=c.ResourceRequirements.make(
            requests={"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"}))], priority=priority,
            node_selector={wk.LABEL_TOPOLOGY_ZONE: zone} if zone else {}),
        status=c.PodStatus(conditions=[c.PodCondition(
            type="PodScheduled", status="False", reason="Unschedulable")]))


def cg_gang(name, size, slice_=None, priority=0, cpu_m=1500, mem_mi=3072):
    from karpenter_tpu_torch.api import wellknown as wk

    labels = {wk.POD_GROUP_LABEL: name, wk.POD_GROUP_SIZE_LABEL: str(size)}
    if slice_ is not None:
        labels[wk.POD_GROUP_SLICE_LABEL] = slice_
    return [cg_pod(f"{name}-m{i}", cpu_m, mem_mi, labels, priority) for i in range(size)]


def ledger_audit(kube, commits, what):
    """Every ledger carve one placement-mask row of its slice on its node's
    grid, carves of one node disjoint, the ledger equal to the commits the
    worker made (after releases) and every carve's members bound there."""
    import numpy as np

    from karpenter_tpu_torch.api import gang as api_gang
    from karpenter_tpu_torch.ops import topology as topo

    snap = {ng.node: ng for ng in topo.LEDGER.snapshot()}
    check({(n, str(k)) for n, k in commits} == {(n, str(k)) for n, ng in snap.items()
                                                 for k in ng.carves},
          f"{what}: ledger != commits")
    carves = 0
    for name, ng in snap.items():
        seen = np.zeros(len(ng.occ), bool)
        on_node = {p.metadata.name for p in kube.pods_on_node(name)}
        for rec in ng.carves.values():
            pod = kube.get("Pod", rec.pods[0][1], rec.pods[0][0])
            slice_dims = api_gang.gang_of(pod).slice_.dims
            row = np.zeros(len(ng.occ), bool)
            row[rec.cells] = True
            masks = topo.placement_masks(ng.dims, slice_dims)
            check(masks is not None and any(np.array_equal(m, row) for m in masks),
                  f"{what}: carve of {rec.gang_key} on {name} not a sub-grid")
            check(not (seen & row).any(), f"{what}: carves overlap on {name}")
            check({n for _, n in rec.pods} <= on_node, f"{what}: members of {rec.gang_key} "
                  f"not on {name}")
            seen |= row
            carves += 1
        check(np.array_equal(seen, ng.occ), f"{what}: occupancy of {name} != its carves")
    return carves


def gangs_whole(kube, gangs, what):
    """Every member of every gang bound."""
    for name, pods in gangs:
        nodes = [kube.get("Pod", p.metadata.name, p.metadata.namespace).spec.node_name
                 for p in pods]
        check(all(nodes), f"{what}: gang {name} bound {sum(map(bool, nodes))}/{len(pods)}")


def check_gang_handles(handles, what):
    """Each gang window the controller dispatched (its GangHandle): the
    answer the controller fetched held against whatif_scan_plain on the
    exact tensors the window launched, bit for bit. Returns the worst
    difference and each device window's (GB, KB, BB); the handles are
    released."""
    import torch

    from karpenter_tpu_torch.ops.whatif_cuda import whatif_scan_plain
    from karpenter_tpu_torch.solver.gang import gang_inputs

    worst, shapes = 0, []
    for h in handles:
        feas, slots, executor = h.fetch()
        check(executor == "device-gang" and h.inputs is not None,
              f"{what}: a gang window answered by {executor}")
        pf, ps = whatif_scan_plain(*gang_inputs(*h.inputs))
        g, k = h.enc.g, max(h.enc.k, 1)
        err = whatif_diff((torch.from_numpy(feas), torch.from_numpy(slots)),
                          (pf.cpu()[:g], ps.cpu()[:g, :k]))
        check(err == 0, f"{what}: the controller's gang answer != plain")
        worst = max(worst, err)
        valid, compat = h.inputs[1], h.inputs[2]
        shapes.append([valid.shape[0], valid.shape[1], compat.shape[1]])
    handles.clear()
    return worst, shapes


def settle(run, timeout=120.0):
    """Wait until the worker's batcher holds nothing and has processed all
    it took in (a displaced gang comes back through it)."""
    batcher, t0 = run.worker.batcher, time.perf_counter()
    while batcher.depth() or batcher.processed_total < batcher.added_total:
        check(time.perf_counter() - t0 < timeout, "controller_gang: the batcher never settled")
        time.sleep(0.05)


def phase_controller_gang(device, journal=None, after=None, phase="controller_gang"):
    """The port's controller on tpu_catalog(): window 1 holds 96 slice gangs
    (32 each of v5e-2x4, v5e-4x4 and v4-2x2x2, 8-16 members of 1.5 cpu and
    3 Gi, so a torus runs out of chips before cpu or memory), 48 plain
    gangs and 4,096 plain pods over three zones (so the chunk launches
    pack_batch too). Checks: every gang bound whole, every pod once; every
    carve a contiguous sub-grid, disjoint on its node, the ledger equal to
    the commits; the what-if kernel, the carve program, the member column
    and pack_batch launched in the window. Wave 2: 32 more v5e-2x4 gangs
    over the partly carved nodes: fewer tpu nodes created than gangs (a
    fresh node each). Then CG_PREEMPT_WINDOWS windows of one high-band
    v5e-4x4 gang each over full tori held by low-band gangs: displaced
    within the budget (no more than a band's tokens a window), every victim
    requeued and bound again, never system-critical. Then a carved node is
    terminated and its carves leave the ledger. Every gang window the
    controller dispatched is held against whatif_scan_plain on the tensors
    it launched (check_gang_handles), its (GB, KB, BB) recorded. One record
    with each window's time split. With ``journal`` the controller and the
    termination controller journal every mutation, and ``after(run)`` runs
    once the scenario is done, before the controller stops (phase_gang_journal)."""
    import torch

    from karpenter_tpu_torch.cloudprovider.fake.provider import tpu_catalog
    from karpenter_tpu_torch.controllers import provisioning
    from karpenter_tpu_torch.controllers.termination import TerminationController
    from karpenter_tpu_torch.ops import device_filter, pack_cuda
    from karpenter_tpu_torch.ops import feasibility
    from karpenter_tpu_torch.ops import topology as topo
    from karpenter_tpu_torch.ops import whatif_cuda as wc
    from karpenter_tpu_torch.solver import topology as topo_solver
    from karpenter_tpu_torch.solver.pipeline import PipelineConfig

    t_phase = time.perf_counter()
    topo.LEDGER.reset()
    feasibility.clear_gang_cache()
    catalog = tpu_catalog()
    run = ControllerRun(catalog, device, card_config(window_backend="ffd"),
                        PipelineConfig(chunk_items=0), journal=journal)
    commits, preempted = [], []
    worker = run.worker
    commit, execute = worker._commit_carves, worker._execute_preemption

    def recording_commit(prep, placement, carves=None):
        commit(prep, placement, carves)
        commits.extend((prep.gang_nodes[bi], placement.gang.key) for bi in placement.carves)

    def recording_preempt(cand, beneficiary=None):
        preempted.append(cand)
        commits[:] = [c for c in commits if c[1] != cand.gang_key]
        return execute(cand, beneficiary)

    worker._commit_carves, worker._execute_preemption = recording_commit, recording_preempt
    dispatch, handles = provisioning.dispatch_gang_window, []

    def recording_dispatch(enc, dev):
        handle = dispatch(enc, dev)
        handles.append(handle)
        return handle

    provisioning.dispatch_gang_window = recording_dispatch
    windows, worst = {}, 0
    try:
        gangs = []
        for shape, members in CG_SLICES:
            family = shape.split("-")[0]
            for g in range(CG_PER_SHAPE):
                gangs.append((f"{family}-{shape}-{g}", cg_gang(f"s-{shape}-{g}", members, shape)))
        gangs += [(f"plain-{g}", cg_gang(f"plain-{g}", 4, cpu_m=2000, mem_mi=4096))
                  for g in range(CG_PLAIN_GANGS)]
        plain = [cg_pod(f"cg-{i}", 250 + 250 * (i % 4), 512 * (1 + i % 3),
                        zone=f"test-zone-{1 + i % 3}") for i in range(CG_PLAIN_PODS)]
        pods = [p for _, ps in gangs for p in ps] + plain
        rec = run.window(pods)
        launches = {"whatif": wc.LAUNCHES, "pack_batch": pack_cuda.BATCH_LAUNCHES,
                    "carve": topo_solver.RUNS, "member_column": device_filter.GANG_COLUMN_RUNS}
        check(device.type != "cuda" or all(launches.values()),
              f"controller_gang: launches {launches}")
        settle(run)
        once_each([p.metadata.name for p in run.kube.list("Pod") if p.spec.node_name],
                  [p.metadata.name for p in pods], "controller_gang window 1")
        gangs_whole(run.kube, gangs, "controller_gang window 1")
        carves = ledger_audit(run.kube, commits, "controller_gang window 1")
        check(carves == 3 * CG_PER_SHAPE, f"controller_gang: {carves} carves")
        err, shapes = check_gang_handles(handles, "controller_gang window 1")
        worst = max(worst, err)
        windows["window1"] = {**rec, "launches": launches, "carves": carves,
                              "gang_shapes": shapes,
                              "gang": [c["gang"] for c in run.chunks if c["gang"]]}

        # wave 2: the partly carved v5e-4x4 nodes come back as seeds
        nodes_before = len(run.kube.list("Node"))
        wave2 = [(f"w2-{g}", cg_gang(f"w2-{g}", 8, "v5e-2x4")) for g in range(CG_WAVE2)]
        rec = run.window([p for _, ps in wave2 for p in ps])
        settle(run)
        gangs_whole(run.kube, wave2, "controller_gang wave 2")
        created = len(run.kube.list("Node")) - nodes_before
        check(created < CG_WAVE2, f"controller_gang wave 2: {created} nodes for {CG_WAVE2} gangs")
        ledger_audit(run.kube, commits, "controller_gang wave 2")
        err, shapes = check_gang_handles(handles, "controller_gang wave 2")
        worst = max(worst, err)
        windows["wave2"] = {**rec, "nodes_created": created, "fresh_nodes": CG_WAVE2,
                            "gang_shapes": shapes,
                            "gang": [c["gang"] for c in run.chunks if c["gang"]]}

        # preemption: low-band gangs hold whole tori; a high-band gang a window
        low = [(f"low-{g}", cg_gang(f"low-{g}", 16, "v5e-4x4", priority=-5))
               for g in range(CG_PREEMPT_WINDOWS)]
        run.window([p for _, ps in low for p in ps])
        settle(run)
        worst = max(worst, check_gang_handles(handles, "controller_gang low band")[0])
        preempt_windows = []
        for w in range(CG_PREEMPT_WINDOWS):
            high = cg_gang(f"high-{w}", 16, "v5e-4x4", priority=10)
            before = len(preempted)
            tokens = worker.preempt_budget.tokens("low")
            rec = run.window(high)
            settle(run)
            n = len(preempted) - before
            check(n <= tokens + worker.preempt_budget.refill_per_window,
                  f"controller_gang: {n} preemptions past {tokens} tokens")
            gangs_whole(run.kube, [(f"high-{w}", high)], "controller_gang preemption")
            err, shapes = check_gang_handles(handles, "controller_gang preemption")
            worst = max(worst, err)
            preempt_windows.append({"wall_s": rec["wall_s"], "preemptions": n,
                                    "gang_shapes": shapes,
                                    "gang": [c["gang"] for c in run.chunks if c["gang"]]})
        check(preempted and all(c.band == "low" for c in preempted),
              f"controller_gang: preempted {[c.band for c in preempted]}")
        gangs_whole(run.kube, low, "controller_gang displaced gangs")
        ledger_audit(run.kube, commits, "controller_gang after preemption")
        windows["preemption"] = {"windows": preempt_windows, "preemptions": len(preempted),
                                 "victims": sorted({str(c.gang_key) for c in preempted}),
                                 "budget_declines": dict(worker.preempt_budget.declines)}

        # terminate one carved node: its carves leave the ledger
        node = sorted(ng.node for ng in topo.LEDGER.snapshot())[0]
        on_node = {str(k) for k in {ng.node: ng for ng in topo.LEDGER.snapshot()}[node].carves}
        termination = TerminationController(run.kube, run.provisioning.cloud_provider,
                                            journal=journal)
        try:
            run.kube.delete("Node", node, "")
            term_s, _ = terminate_all(run.kube, termination, [node])
        finally:
            termination.stop_all()
        check(node not in {ng.node for ng in topo.LEDGER.snapshot()},
              "controller_gang: the terminated node is still in the ledger")
        windows["termination"] = {"node": node, "carves_released": len(on_node),
                                  "seconds": term_s}
        torch.cuda.synchronize()
        if after is not None:
            windows["after"] = after(run)
    finally:
        provisioning.dispatch_gang_window = dispatch
        run.stop()
        topo.LEDGER.reset()
    rec = {"phase": phase, **windows, "max_abs_err": worst,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


# -- crash safety: the intent journal, recovery and the kill points ------------------

# the full-width deaths: the pre/post pairs of fleet-launch:open,
# bind:node-created and bind:bound. On an NVIDIA H100 80GB HBM3 at 700 W all
# 14 points of the two machines took 157-168 s with gang_journal's 21-23 s,
# past the two phases' 180 s budget, and on a slower host took the whole
# script to 1,125 s of its 1,200 s limit (PERF.md, section 6); the 14
# still run on the CPU against the JAX package
# (tests/test_torch_recovery.py) and all 50 on the card in soak_catalog
JOURNAL_CRASH_POINTS = ["pre:fleet-launch:open", "fleet-launch:open", "pre:bind:node-created",
                        "bind:node-created", "pre:bind:bound", "bind:bound"]
GANG_CRASH_POINTS = ["gang-bind:nodes-created", "pre:gang-bind:bound", "gang-bind:unwinding",
                     "carve:open", "preempt:victims-unbound", "preempt:beneficiary-bound"]
# config_15's recovery leg (bench.py): 16 cold replays of 48 open fleet-launch
# intents over leaked capacity and 24 with nothing launched
RECOVERY_ITERS, RECOVERY_LEAKS, RECOVERY_NOOPS = 16, 48, 24
LEDGER_REPLAYS = 10


def journal_dir(name):
    """A fresh journal directory on the machine's disk, inside the
    checkout's build directory (git ignores it)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "karpenter_tpu_torch",
                        "build", "journal")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"{name}-", dir=root)


def fs_type(path):
    proc = subprocess.run(["stat", "-f", "-c", "%T", path], capture_output=True, text=True,
                          timeout=30)
    return proc.stdout.strip() if proc.returncode == 0 else None


def journal_counters():
    """The journal's series: records by kind, bytes, and the append
    histogram's seconds and count."""
    from karpenter_tpu_torch.metrics import recovery as rm

    kinds = {dict(lv).get("kind", ""): v for lv, v in rm.JOURNAL_RECORDS_TOTAL.collect().items()}
    hist = rm.JOURNAL_APPEND_SECONDS.collect().values()
    return {"kinds": kinds, "bytes": sum(rm.JOURNAL_BYTES_TOTAL.collect().values()),
            "append_s": sum(h[1] for h in hist), "appends": sum(h[2] for h in hist)}


def journal_delta(before, after):
    kinds = {k: after["kinds"][k] - before["kinds"].get(k, 0.0) for k in after["kinds"]}
    return {"kinds": {k: int(v) for k, v in kinds.items() if v},
            **{k: after[k] - before[k] for k in ("bytes", "append_s", "appends")}}


class PackLaunches:
    """Every launch of the pack kernel (batched and lone) made inside the
    block, with clones of its inputs and its output, for holding against
    the plain version afterwards (``held``)."""

    def __enter__(self):
        from karpenter_tpu_torch.ops import pack_cuda

        self.records, self._mod = [], pack_cuda
        self._batch, self._chunk = pack_cuda.launch_pack_batch, pack_cuda.launch_pack

        def clone(args):
            return [a.clone() if hasattr(a, "clone") else a for a in args]

        def batch(*args):
            out = self._batch(*args)
            self.records.append(("batch", clone(args), out.clone()))
            return out

        def chunk(*args):
            out = self._chunk(*args)
            self.records.append(("chunk", clone(args), out.clone()))
            return out

        pack_cuda.launch_pack_batch, pack_cuda.launch_pack = batch, chunk
        return self

    def __exit__(self, *exc):
        self._mod.launch_pack_batch, self._mod.launch_pack = self._batch, self._chunk

    def held(self):
        """The largest difference of any recorded launch from the plain
        version on the same tensors (0: bit for bit)."""
        import torch

        from karpenter_tpu_torch.ops.pack_cuda import pack_batch_plain, pack_chunk_plain

        worst = 0
        for kind, a, out in self.records:
            (shapes, counts, dropped, totals, reserved0, valid, last_valid, pods_unit, iters,
             prices, cost, maxfit) = a[:12]
            if kind == "batch":
                want = pack_batch_plain(shapes, counts, dropped, totals, reserved0, valid,
                                        last_valid, pods_unit, iters, prices=prices,
                                        cost_tiebreak=cost, maxfit=maxfit)
            else:
                want = pack_chunk_plain(shapes, counts, dropped, totals, reserved0, valid,
                                        int(last_valid), int(pods_unit), iters, prices=prices,
                                        cost_tiebreak=cost, maxfit=maxfit)
            diff = (out.to(torch.int64) - want.to(torch.int64)).abs()
            worst = max(worst, int(diff.max()) if diff.numel() else 0)
        self.records.clear()
        return worst


def drive(worker, kube, pods):
    """Enqueue ``pods`` that are not bound yet and run one window."""
    todo = [p for p in pods if not kube.read("Pod", p.metadata.name, p.metadata.namespace,
                                             lambda q: bool(q.spec.node_name))]
    for p in todo:
        check(worker.add(p, key=(p.metadata.namespace, p.metadata.name)) is not None,
              "journal: a pod was shed at intake")
    if todo:
        worker.provision()
    return len(todo)


def bound_once(kube, names, what):
    """Every pod of ``names`` bound, to a live node whose pod index holds it
    exactly once (read without copies, but for the index)."""
    from collections import Counter

    nodes = set(kube.scan("Node", lambda n: n.metadata.name))
    on = Counter()
    for n in nodes:
        on.update(p.metadata.name for p in kube.pods_on_node(n))
    pods = dict(kube.scan("Pod", lambda p: (p.metadata.name, p.spec.node_name)))
    unbound = [n for n in names if pods.get(n) not in nodes]
    check(not unbound, f"{what}: {len(unbound)} pods not bound to a live node ({unbound[:3]})")
    twice = [n for n in names if on[n] != 1]
    check(not twice, f"{what}: pods not on exactly one node's index {twice[:3]}")


def journal_crash_cell(point, window, catalog, pods_of, names, device):
    """One full-width crash: the window journaled (fsync on) on a direct
    worker, a plan that kills it at ``point`` on the stream's ``window``-th
    call or before, then the restart (a fresh journal, RecoveryController.run)
    and the re-drive of the still-pending pods through a fresh worker, its
    pack launches held against the plain version."""
    import gc
    import shutil
    from types import SimpleNamespace

    from karpenter_tpu_torch.chaos import inject, soak
    from karpenter_tpu_torch.controllers.recovery import RecoveryController
    from karpenter_tpu_torch.runtime.journal import IntentJournal

    d = journal_dir("crash")
    t_cell = time.perf_counter()
    # the collector frozen over the cell, as ControllerRun's windows freeze
    # it: a full collection over the heap the earlier phases left, or over
    # 10k pods' objects, takes seconds
    gc.freeze()
    try:
        kube, provider, provisioner = new_cluster(catalog)
        pods = pods_of()
        for p in pods:
            kube.create(p)
        build_s = time.perf_counter() - t_cell
        t0 = time.perf_counter()
        journal = IntentJournal(d, fsync=True)
        worker = calling_thread_worker(kube, provider, provisioner, device, journal)
        inject.install(inject.FaultPlan(1, [inject.FaultSpec("journal", point, "crash-point", 1)],
                                        window=window))
        crashed = None
        try:
            drive(worker, kube, pods)
        except inject.SimulatedCrash as e:
            crashed = e.point
        finally:
            calls = inject.installed().calls("journal", point)
            inject.uninstall()
            journal.close_journal()
        check(crashed == point, f"journal: {point} never fired ({calls} calls of {window})")
        crash_s = time.perf_counter() - t0
        bound_at_death = sum(1 for p in kube.list("Pod") if p.spec.node_name)
        t0 = time.perf_counter()
        journal = IntentJournal(d, fsync=True)
        stats = RecoveryController(kube, provider, journal).run()
        recovery_s = time.perf_counter() - t0
        check(stats["errors"] == 0, f"journal {point}: recovery errors {stats}")
        t0 = time.perf_counter()
        with PackLaunches() as launches:
            redriven = drive(calling_thread_worker(kube, provider, provisioner, device, journal),
                             kube, pods)
            if device.type == "cuda":
                import torch

                torch.cuda.synchronize()
        redrive_s = time.perf_counter() - t0
        n_launches = len(launches.records)
        check(device.type != "cuda" or n_launches > 0, f"journal {point}: no pack launch")
        t0 = time.perf_counter()
        err = launches.held()
        check(err == 0, f"journal {point}: the re-drive's pack launches != plain ({err})")
        hold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        found = soak.leaks(SimpleNamespace(kube=kube, provider=provider))
        check(not found["leaked"] and not found["ghosts"], f"journal {point}: {found}")
        bound_once(kube, names, f"journal {point}")
        check(journal.open_intents() == {}, f"journal {point}: intents left open")
        journal.close_journal()
        return {"point": point, "stream_calls": calls, "window": window,
                "bound_at_death": bound_at_death, "stats": stats, "recovery_s": recovery_s,
                "redriven_pods": redriven, "redrive_s": redrive_s,
                "redrive_pack_launches": n_launches, "max_abs_err": err,
                "nodes": len(kube.scan("Node", lambda n: n.metadata.name)),
                "split_s": {"build": build_s, "crashed_window": crash_s,
                            "recovery": recovery_s, "redrive": redrive_s, "hold": hold_s,
                            "checks": time.perf_counter() - t0},
                "cell_s": time.perf_counter() - t_cell}
    finally:
        gc.unfreeze()
        shutil.rmtree(d, ignore_errors=True)


def recovery_wall():
    """config_15's recovery leg on the port: each iteration journals 48
    fleet-launch intents whose capacity launched and leaked (the bind never
    ran) and 24 that launched nothing, then times one cold replay."""
    import shutil

    from karpenter_tpu_torch.chaos import soak
    from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider, instance_types
    from karpenter_tpu_torch.controllers.recovery import RecoveryController
    from karpenter_tpu_torch.runtime import journal as jr
    from karpenter_tpu_torch.runtime.kubecore import KubeCore

    walls, leaks, opens, errors, rolled_back = [], 0, 0, 0, 0
    for _ in range(RECOVERY_ITERS):
        kube, provider = KubeCore(), FakeCloudProvider(catalog=instance_types(4))
        cons = soak.make_constraints("crash-bench")
        itype = provider.catalog[-1]
        d = journal_dir("recovery")
        try:
            journal = jr.IntentJournal(d, fsync=False)
            for _k in range(RECOVERY_LEAKS):
                nonce = jr.new_nonce()
                journal.open_intent("fleet-launch", nonce=nonce, provisioner="crash-bench")
                with jr.preassigned_nonce(nonce):
                    provider.create(cons, [itype], 1, lambda node: "simulated crash")
            for _k in range(RECOVERY_NOOPS):
                journal.open_intent("fleet-launch", nonce=jr.new_nonce(),
                                    provisioner="crash-bench")
            journal.close_journal()
            with jr.IntentJournal(d, fsync=False) as journal:
                recovery = RecoveryController(kube, provider, journal)
                t0 = time.perf_counter()
                stats = recovery.run()
                walls.append(time.perf_counter() - t0)
                errors += stats["errors"]
                rolled_back += stats["rollback"]
                leaks += len(provider.list_instances())
                opens += len(journal.open_intents())
        finally:
            shutil.rmtree(d, ignore_errors=True)
    check(leaks == 0 and opens == 0 and errors == 0,
          f"journal recovery wall: leaks {leaks}, open {opens}, errors {errors}")
    check(rolled_back == RECOVERY_ITERS * RECOVERY_LEAKS,
          f"journal recovery wall: {rolled_back} rollbacks")
    ms = sorted(w * 1e3 for w in walls)
    return {"iters": RECOVERY_ITERS, "open_intents_per_iter": RECOVERY_LEAKS + RECOVERY_NOOPS,
            "leaked_instances_per_iter": RECOVERY_LEAKS, "wall_ms": ms,
            "p50_ms": ms[len(ms) // 2], "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
            "rolled_back": rolled_back, "errors": errors, "leaks_after": leaks,
            "open_after": opens}


def soak_catalog(device):
    """Every one of the 50 kill points at seed 1, window 1, on the soak's own
    scenario (karpenter_tpu_torch.chaos.soak: the fleet-launch, bind,
    gang-bind, drain and node-delete machines in the plain scenario, the
    carve and preempt machines in the carve scenario), fsync on."""
    import shutil

    from karpenter_tpu_torch.chaos import soak
    from karpenter_tpu_torch.pressure import PressureConfig, PressureMonitor, set_monitor
    from karpenter_tpu_torch.runtime.journal import KILL_POINTS

    reference, cells = {}, []
    # the scenario's batchers read the process-wide monitor: hold it quiet
    set_monitor(PressureMonitor(PressureConfig(rss_watermark_bytes=0)))
    try:
        for point in KILL_POINTS:
            carve = point in soak.CARVE_KILL_POINTS
            d = journal_dir("soak")
            try:
                out = soak.soak_once(d, point, seed=1, window=1, device=device,
                                     solver_config=card_config(),
                                     reference=reference.get(carve), fsync=True)
            finally:
                shutil.rmtree(d, ignore_errors=True)
            reference[carve] = out["reference"]
            check(out["crashed"], f"soak: {point} never fired")
            check(not out["leaks"]["leaked"] and not out["leaks"]["ghosts"],
                  f"soak {point}: {out['leaks']}")
            cells.append({k: out[k] for k in ("kill_point", "stats", "recovery_s", "redrive_s")})
    finally:
        set_monitor(None)
    actions = {k: sum(c["stats"][k] for c in cells) for k in ("forward", "rollback", "noop")}
    return {"points": len(cells), "crashed": len(cells), "actions": actions,
            "recovery_s": sum(c["recovery_s"] for c in cells),
            "redrive_s": sum(c["redrive_s"] for c in cells), "cells": cells}


def phase_journal(device, columnar_binds):
    """Crash safety at full width (config_12's 9,984 pods in one chunk,
    controller_columnar's window):

    a. the window through the controller with a journal, fsync on, in a
       directory on the machine's disk: the binds equal controller_columnar's
       and no intent stays open; the appends by kind, the bytes, the µs an
       append and the journal's tax (the append histogram's seconds over
       the window's wall, bench.py config_15's method), the filesystem type;
    b. a crash inside that window at each of JOURNAL_CRASH_POINTS (six of
       the fleet-launch and bind machines' 14; seed 1; the plan's window
       is the stream's call count in (a): the launches for fleet-launch,
       the nodes for bind), a restart and a re-drive (journal_crash_cell): no
       leaked instance, no ghost Node, every pod bound once, no open
       intent, no recovery error, the re-drive's pack launches equal to
       the plain version's;
    c. config_15's recovery wall (recovery_wall);
    d. the 50 kill points on the soak's own scenario (soak_catalog)."""
    import shutil

    from karpenter_tpu_torch.runtime.journal import IntentJournal
    from karpenter_tpu_torch.solver.pipeline import PipelineConfig

    catalog = make_catalog(WINDOW_TYPES)
    d = journal_dir("window")
    fs = fs_type(d)
    journal = IntentJournal(d, fsync=True)
    run = ControllerRun(catalog, device, card_config(window_backend="ffd"),
                        PipelineConfig(chunk_items=0), journal=journal)
    try:
        before = journal_counters()
        rec = run.window(config12_controller_pods(catalog, 416, "j0"))
        moved = journal_delta(before, journal_counters())
        binds = strip_prefix(run.binds)
    finally:
        run.stop()
        journal.close_journal()
    check(rec["chunks"] == 1, f"journal: {rec['chunks']} chunks")
    check(binds == columnar_binds, "journal: the journaled window's binds differ from "
                                   "controller_columnar's")
    check(IntentJournal(d, fsync=False).open_intents() == {}, "journal: intents left open")
    shutil.rmtree(d, ignore_errors=True)
    launches, nodes = moved["kinds"]["fleet-launch"] // 3, moved["kinds"]["bind"] // 4
    check(nodes == rec["nodes"], f"journal: {nodes} bind intents for {rec['nodes']} nodes")
    window = {"pods": rec["pods"], "nodes": rec["nodes"], "launches": launches,
              "wall_s": rec["wall_s"], "appends": moved["appends"], "by_kind": moved["kinds"],
              "bytes": moved["bytes"], "append_s": moved["append_s"],
              "us_per_append": moved["append_s"] / moved["appends"] * 1e6,
              "tax_pct": moved["append_s"] / rec["wall_s"] * 100,
              "pack_batch_launches": rec["pack_batch_launches"]}

    names = [n for _, ns in columnar_binds for n in ns]
    cells = []
    for i, point in enumerate(JOURNAL_CRASH_POINTS):
        calls = launches if point.split(":")[-2] == "fleet-launch" else nodes
        cells.append(journal_crash_cell(
            point, calls, catalog,
            lambda i=i: config12_controller_pods(catalog, 416, f"k{i}"),
            [f"k{i}-{n}" for n in names], device))
    crash = {"points": len(cells),
             "actions": {k: sum(c["stats"][k] for c in cells)
                         for k in ("forward", "rollback", "noop")},
             "recovery_s": sum(c["recovery_s"] for c in cells),
             "redrive_s": sum(c["redrive_s"] for c in cells),
             "max_abs_err": max(c["max_abs_err"] for c in cells),
             "nodes_uncrashed": rec["nodes"], "cells": cells}
    out = {"phase": "journal", "fs_type": fs, "fsync": True, "window": window,
           "crash": crash, "recovery_wall": recovery_wall(), "soak": soak_catalog(device)}
    emit(out)
    return out


def ledger_bits():
    """The occupancy ledger, every field of every node and carve (the
    occupancy plane as its bytes), in a canonical order."""
    from karpenter_tpu_torch.ops import topology as topo

    return sorted((ng.node, ng.type_name, tuple(ng.dims), repr(ng.labels_sig),
                   ng.occ.tobytes(),
                   tuple(sorted((str(k), tuple(int(c) for c in r.cells), r.band,
                                 tuple(tuple(p) for p in r.pods), r.intent_id)
                                for k, r in ng.carves.items())))
                  for ng in topo.LEDGER.snapshot())


def gang_crash_cell(point, device):
    """controller_gang's shapes at a smaller scale on a journaled direct
    worker: window 1 with 4 low-band v5e-4x4 gangs, 4 v5e-2x4 gangs and 2
    plain gangs, then 2 windows of one high-band v5e-4x4 gang each, which
    preempt. The plan kills the worker at ``point`` (for
    gang-bind:unwinding, ChaosKube fails the gang's member bind, seed
    chosen so the first unwind dies); then the restart, a termination
    pass and re-drives of every unbound member. Every gang bound whole or
    not at all, the ledger exactly the carves of the bound slice gangs
    with their open carve intents, no leak, no ghost, no recovery error;
    every gang window held against the plain version."""
    import itertools
    import shutil
    from types import SimpleNamespace

    from karpenter_tpu_torch.chaos import inject, soak
    from karpenter_tpu_torch.cloudprovider.fake.provider import tpu_catalog
    from karpenter_tpu_torch.controllers import provisioning
    from karpenter_tpu_torch.controllers.recovery import RecoveryController
    from karpenter_tpu_torch.ops import feasibility
    from karpenter_tpu_torch.ops import topology as topo
    from karpenter_tpu_torch.runtime.journal import IntentJournal

    topo.LEDGER.reset()
    feasibility.clear_gang_cache()
    kube, provider, provisioner = new_cluster(tpu_catalog())
    low = [(f"jlo-{g}", cg_gang(f"jlo-{g}", 16, "v5e-4x4", priority=-5)) for g in range(4)]
    mid = [(f"jmid-{g}", cg_gang(f"jmid-{g}", 8, "v5e-2x4")) for g in range(4)]
    plain = [(f"jpl-{g}", cg_gang(f"jpl-{g}", 4, cpu_m=2000, mem_mi=4096)) for g in range(2)]
    high = [(f"jhi-{g}", cg_gang(f"jhi-{g}", 16, "v5e-4x4", priority=10)) for g in range(2)]
    gangs = low + mid + plain + high
    waves = [low + mid + plain, high[:1], high[1:]]
    for _, ps in gangs:
        for p in ps:
            kube.create(p)
    specs = [inject.FaultSpec("journal", point, "crash-point", 1)]
    seed, window, worker_kube = 1, 1, kube
    if point == "gang-bind:unwinding":
        # every bind_pods call of the first four conflicts: a node's creation
        # binds no pods and shrugs it off, a member bind fails and unwinds
        window = 4
        specs.append(inject.FaultSpec("kube", "bind_pods", "conflict", window))
        seed = next(s for s in itertools.count(1) if inject.FaultPlan(s, specs, window).decide(
            "journal", point) == "crash-point")
        worker_kube = inject.ChaosKube(kube)
    dispatch, handles = provisioning.dispatch_gang_window, []

    def recording_dispatch(enc, dev):
        handle = dispatch(enc, dev)
        handles.append(handle)
        return handle

    provisioning.dispatch_gang_window = recording_dispatch
    d = journal_dir("gang-crash")
    try:
        journal = IntentJournal(d, fsync=True)
        worker = calling_thread_worker(worker_kube, provider, provisioner, device, journal)
        inject.install(inject.FaultPlan(seed, specs, window=window))
        crashed, preempted = None, 0
        try:
            for wave in waves:
                drive(worker, worker_kube, [p for _, ps in wave for p in ps])
        except inject.SimulatedCrash as e:
            crashed = e.point
        finally:
            inject.uninstall()
            journal.close_journal()
        check(crashed == point, f"gang_journal: {point} never fired")
        topo.LEDGER.reset()  # the in-memory ledger dies with the process
        t0 = time.perf_counter()
        journal = IntentJournal(d, fsync=True)
        stats = RecoveryController(kube, provider, journal).run()
        recovery_s = time.perf_counter() - t0
        check(stats["errors"] == 0, f"gang_journal {point}: recovery errors {stats}")
        cluster = SimpleNamespace(kube=kube, provider=provider)
        soak.settle_terminations(cluster, journal)
        worker = calling_thread_worker(kube, provider, provisioner, device, journal)
        for _ in range(4):
            if not drive(worker, kube, [p for _, ps in gangs for p in ps]):
                break
        soak.settle_terminations(cluster, journal)
        err, _shapes = check_gang_handles(handles, f"gang_journal {point}")
        bound = set()
        for name, ps in gangs:
            nodes = [kube.get("Pod", p.metadata.name, p.metadata.namespace).spec.node_name
                     for p in ps]
            check(all(nodes) or not any(nodes),
                  f"gang_journal {point}: gang {name} bound {sum(map(bool, nodes))}/{len(ps)}")
            if all(nodes):
                bound.add(name)
        slice_bound = {str(("default", n)) for n, _ in low + mid + high if n in bound}
        ledger = {str(k): (ng.node, r) for ng in topo.LEDGER.snapshot()
                  for k, r in ng.carves.items()}
        check(set(ledger) == slice_bound, f"gang_journal {point}: ledger {sorted(ledger)} "
                                          f"!= bound slice gangs {sorted(slice_bound)}")
        for key, (node, r) in ledger.items():
            on = {p.metadata.name for p in kube.pods_on_node(node)}
            check({n for _, n in r.pods} <= on, f"gang_journal {point}: {key} not on {node}")
        open_ = journal.open_intents()
        check({i.kind for i in open_.values()} <= {"carve"}
              and set(open_) == {r.intent_id for _, r in ledger.values()},
              f"gang_journal {point}: open intents {sorted(i.kind for i in open_.values())}")
        found = soak.leaks(cluster)
        check(not found["leaked"] and not found["ghosts"], f"gang_journal {point}: {found}")
        journal.close_journal()
        return {"point": point, "seed": seed, "stats": stats, "recovery_s": recovery_s,
                "gangs_bound": len(bound), "gangs": len(gangs), "carves": len(ledger),
                "max_abs_err": err}
    finally:
        provisioning.dispatch_gang_window = dispatch
        shutil.rmtree(d, ignore_errors=True)
        topo.LEDGER.reset()


def phase_gang_journal(device):
    """controller_gang's scenario journaled (fsync on): tpu_catalog(), 96
    slice gangs, 48 plain gangs, 4,096 pods, the second wave, the high-band
    preemptions and the carved node terminated, every gang window held
    against the plain version. Afterwards the only open intents are the live
    carves; LEDGER_REPLAYS cold replays (LEDGER.reset(), a fresh journal,
    RecoveryController.run()) each rebuild the ledger bit for bit equal to
    the snapshot taken before (bench.py config_17's recovered_bitident),
    timed. Then one crash at each of GANG_CRASH_POINTS (gang_crash_cell)."""
    import shutil

    from karpenter_tpu_torch.controllers.recovery import RecoveryController
    from karpenter_tpu_torch.ops import topology as topo
    from karpenter_tpu_torch.runtime.journal import IntentJournal

    d = journal_dir("gang")
    journal = IntentJournal(d, fsync=True)

    def after(run):
        live = {r.intent_id for ng in topo.LEDGER.snapshot() for r in ng.carves.values()}
        opened = journal.open_intents()
        check({i.kind for i in opened.values()} == {"carve"} and set(opened) == live
              and "" not in live, "gang_journal: the open intents are not the live carves")
        before = ledger_bits()
        journal.close_journal()
        walls = []
        for _ in range(LEDGER_REPLAYS):
            topo.LEDGER.reset()
            with IntentJournal(d, fsync=True) as j2:
                t0 = time.perf_counter()
                stats = RecoveryController(run.kube, run.provisioning.cloud_provider, j2).run()
                walls.append((time.perf_counter() - t0) * 1e3)
                check(stats["errors"] == 0 and stats["rollback"] == 0,
                      f"gang_journal: replay {stats}")
                check(set(j2.open_intents()) == set(opened), "gang_journal: replay changed "
                                                             "the open intents")
            check(ledger_bits() == before, "gang_journal: the replayed ledger is not the "
                                           "snapshot bit for bit")
        ms = sorted(walls)
        return {"open_carves": len(opened), "ledger_nodes": len(before),
                "recovered_bitident": True, "replays": LEDGER_REPLAYS, "replay_ms": ms,
                "p50_ms": ms[len(ms) // 2], "p99_ms": ms[-1]}

    try:
        rec = phase_controller_gang(device, journal=journal, after=after, phase="gang_journal")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    cells = [gang_crash_cell(point, device) for point in GANG_CRASH_POINTS]
    out = {"phase": "gang_journal_crashes", "cells": cells,
           "max_abs_err": max(c["max_abs_err"] for c in cells)}
    emit(out)
    return {"scenario": rec, "crashes": out,
            "max_abs_err": max(rec["max_abs_err"], out["max_abs_err"])}


# -- the controller process (A7 and the process half of A8-main) -------------

NATIVE_SIZES = (16, 64, 256, 511, 512, 2048, 9984)
# above this size the oracle is the per-pod C++ ring (kt_ffd_pack_per_pod),
# the transcription of host_ffd.pack that tests/test_torch_native_ffd.py
# holds equal to it to the full result key: host_ffd.pack itself takes 18 s
# at 2,048 pods and 414 s at 9,984 on config_4's catalog on one CPU core
NATIVE_PYTHON_ORACLE_MAX = 512
# config_12's window at 21 pods a schedule (504 pods: under the gate) with
# WARM_RUNS timed runs, and at 416 (9,984 pods) with 5
NATIVE_WINDOWS = ((21, WARM_RUNS), (416, 5))
# config_12's window under the Manager: 416 pods a schedule, 9,984 pods
# (the wire phase; manager_flood's largest)
MAIN_PER = 416
# the in-memory main phase's depth: 104 pods a schedule (2,496 pods), since
# the wire phase drives the full width through the same Manager and the
# script's total must stay inside its limit
MAIN_MEMORY_PER = 104
MAIN_LATE_PODS = 40
MAIN_FLOOD_DEADLINE_S = 240.0
MAIN_PROCESS_DEADLINE_S = 120.0


def oracle_result(pods, catalog, constraints):
    """The per-pod oracle materialized like solve(): host_ffd.pack up to
    NATIVE_PYTHON_ORACLE_MAX pods, its C++ transcription above."""
    from karpenter_tpu_torch.solver import host_ffd
    from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
    from karpenter_tpu_torch.solver.native_ffd import solve_ffd_per_pod_native
    from karpenter_tpu_torch.solver.solve import SolverConfig, materialize

    packables, sorted_types = build_packables(catalog, constraints, pods, [])
    vecs, ids = pod_vectors(pods), list(range(len(pods)))
    if len(pods) <= NATIVE_PYTHON_ORACLE_MAX:
        host = host_ffd.pack(vecs, ids, packables)
    else:
        host = solve_ffd_per_pod_native(vecs, ids, packables)
    return materialize(host, pods, sorted_types, constraints, SolverConfig())


def ring_config():
    """The solver configuration that answers every problem on the native
    ring, whatever its size: the other side of card_config() in the gate's
    timings."""
    from karpenter_tpu_torch.solver.solve import SolverConfig

    return SolverConfig(device_min_pods=sys.maxsize)


def median_wall_ms(fn, runs):
    """The median host wall of ``fn`` followed by a synchronize, over
    ``runs`` calls after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000.0)
    return p50(walls)


def phase_native_ring(device):
    """The native host ring and its gate (SolverConfig.device_min_pods, 512)
    on config_4's catalog (400 types, MIXED_SHAPES):

    a. solve() at each of NATIVE_SIZES: equal to the per-pod oracle
       (oracle_result), answered "native" below 512 pods and "device" at
       and above, the pack kernel launched exactly when "device";
    b. the timings the gate waits for: at each size the median wall of
       WARM_RUNS warm solves on the ring (ring_config) and on the card
       (card_config), and the sizes where the card wins;
       config_12's 24-schedule window (NATIVE_WINDOWS) batched on the card
       against each problem alone on the ring, the same plans;
    c. the per-pod ring on the 50,016-pod window's 24 problems: the node
       counts of the batched device solve."""
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.solver.adapter import build_packables, pod_vectors
    from karpenter_tpu_torch.solver.batch_solve import dispatch_batch, solve_batch
    from karpenter_tpu_torch.solver.native_ffd import solve_ffd_per_pod_native
    from karpenter_tpu_torch.solver.solve import solve, universe_constraints

    catalog = make_catalog(400)
    constraints = universe_constraints(catalog)
    sizes = []
    for n in NATIVE_SIZES:
        pods = make_pods(n, MIXED_SHAPES)
        reset_counts()
        got = solve(constraints, pods, catalog, device=device)
        launched = pack_cuda.LAUNCHES + pack_cuda.BATCH_LAUNCHES
        executor = "native" if n < 512 else "device"
        check(executor_counts() == {executor: 1},
              f"native_ring: {n} pods answered by {executor_counts()}")
        check((launched > 0) == (executor == "device"),
              f"native_ring: {n} pods launched the pack kernel {launched} times")
        check(canonical(got, pods) == canonical(oracle_result(pods, catalog, constraints), pods),
              f"native_ring: {n} pods != the per-pod oracle")
        sizes.append({
            "pods": n, "executor": executor, "nodes": got.node_count, "launches": launched,
            "oracle": ("host_ffd.pack" if n <= NATIVE_PYTHON_ORACLE_MAX
                       else "kt_ffd_pack_per_pod"),
            "native_p50_ms": median_wall_ms(
                lambda: solve(constraints, pods, catalog, device=device,
                              config=ring_config()), WARM_RUNS),
            "device_p50_ms": median_wall_ms(
                lambda: solve(constraints, pods, catalog, device=device,
                              config=card_config()), WARM_RUNS)})
    faster = [s["pods"] for s in sizes if s["device_p50_ms"] < s["native_p50_ms"]]

    windows = []
    wcat = make_catalog(WINDOW_TYPES)
    for per, runs in NATIVE_WINDOWS:
        problems = window_problems(wcat, per)
        batched = solve_batch(problems, card_config(), device=device)
        reset_counts()
        alone = [solve(p.constraints, p.pods, wcat, device=device) for p in problems]
        check(executor_counts() == {"native": len(problems)},
              f"native_ring: the {per}-pod problems answered by {executor_counts()}")
        check([canonical(r, p.pods) for r, p in zip(alone, problems)] ==
              [canonical(r, p.pods) for r, p in zip(batched, problems)],
              f"native_ring: the {per}-pod problems alone on the ring != the batch")
        windows.append({
            "schedules": len(problems), "pods": sum(len(p.pods) for p in problems),
            "runs": runs, "nodes": sum(r.node_count for r in batched),
            "batched_device_p50_ms": median_wall_ms(
                lambda: solve_batch(problems, card_config(), device=device), runs),
            "alone_native_p50_ms": median_wall_ms(
                lambda: [solve(p.constraints, p.pods, wcat, device=device,
                               config=ring_config()) for p in problems], runs)})

    big = window_problems(wcat, 2084)
    reset_counts()
    results = dispatch_batch(big, device=device).fetch()
    check(executor_counts() == {"device-batch": len(big)},
          f"native_ring: the 50,016-pod window answered by {executor_counts()}")
    t0 = time.perf_counter()
    oracle = []
    for prob in big:
        packables, _ = build_packables(prob.instance_types, prob.constraints, prob.pods,
                                       prob.daemons)
        oracle.append(solve_ffd_per_pod_native(
            pod_vectors(prob.pods), list(range(len(prob.pods))), packables).node_count)
    per_pod_s = time.perf_counter() - t0
    device_nodes = [r.node_count for r in results]
    check(oracle == device_nodes,
          f"native_ring: per-pod ring nodes {oracle} != the device's {device_nodes}")
    rec = {"phase": "native_ring", "types": len(catalog), "gate_pods": 512,
           "sizes": sizes, "device_faster_at": faster,
           "crossover_pods": min(faster) if faster else None, "windows": windows,
           "per_pod_oracle": {"problems": len(big), "pods": sum(len(p.pods) for p in big),
                              "nodes": sum(oracle), "seconds": per_pod_s,
                              "equal_to_device": True}}
    emit(rec)
    return rec


def library_files(path):
    return {p.name: p.stat().st_mtime_ns for p in path.iterdir() if p.suffix == ".so"}


def phase_warmup(device):
    """solver/warmup.warmup_pass on the card, twice, into a library
    directory of its own (configure_compilation_cache): the first pass
    builds the pack, what-if and native libraries cold, the second finds
    all three (the same files, untouched). Each pass's seconds, runs, pack
    launches and ring counters (the ring keeps DeviceRing.max_slots of the
    ladder's 54 buckets resident, the smallest shape buckets); then a
    first solve() at a bucket the ladder leaves resident, (8, 256): 600
    pods of four shapes over 200 types, answered by the device, refills
    the warm slot and allocates no ring buffer."""
    import shutil
    from pathlib import Path

    from karpenter_tpu_torch import build_dir
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.solver import pipeline, warmup
    from karpenter_tpu_torch.solver.solve import solve, universe_constraints

    home = build_dir.PATH
    cache = Path(tempfile.mkdtemp(prefix="warmup-libs-", dir=home))
    passes = []
    try:
        check(warmup.configure_compilation_cache(str(cache)), "warmup: no library directory")
        pipeline.reset_ring()
        for _ in range(2):
            before = library_files(cache)
            reset_counts()
            t0 = time.perf_counter()
            runs = warmup.warmup_pass(device=device)
            seconds = time.perf_counter() - t0
            after = library_files(cache)
            passes.append({"seconds": seconds, "runs": runs,
                           "built": sorted(set(after) - set(before)),
                           "found": sorted(k for k in before if after.get(k) == before[k]),
                           "pack_chunk_launches": pack_cuda.LAUNCHES,
                           "pack_batch_launches": pack_cuda.BATCH_LAUNCHES,
                           "ring": pipeline.get_ring().counters()})
        cold, warm = passes
        check(len(cold["built"]) == 3 and not cold["found"],
              f"warmup: the cold pass built {cold['built']}")
        check(not warm["built"] and len(warm["found"]) == 3,
              f"warmup: the warm pass built {warm['built']}")
        catalog = make_catalog(200)
        pods = make_pods(600, MIXED_SHAPES[:4])
        ring_before = pipeline.get_ring().counters()
        reset_counts()
        solve(universe_constraints(catalog), pods, catalog, device=device)
        ring_after = pipeline.get_ring().counters()
        check(executor_counts() == {"device": 1}, f"warmup: solved by {executor_counts()}")
        check(ring_after["allocations"] == ring_before["allocations"]
              and ring_after["refills"] > ring_before["refills"],
              f"warmup: the first solve at a warmed bucket allocated "
              f"({ring_before} -> {ring_after})")
    finally:
        build_dir.PATH = home
        shutil.rmtree(cache, ignore_errors=True)
    shapes, types = warmup.default_ladder()
    rec = {"phase": "warmup", "buckets": len(shapes) * len(types),
           "shape_buckets": shapes, "type_buckets": types, "cold": cold, "warm": warm,
           "first_solve_ring": {"before": ring_before, "after": ring_after}}
    emit(rec)
    return rec


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(port, path, timeout=5.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def wait_bound(kube, names, deadline_s, what):
    """Poll the API server until every pod of ``names`` is bound."""
    names = set(names)
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        bound = set(kube.scan("Pod", lambda p: p.metadata.name if p.spec.node_name else None))
        if names <= bound:
            return
        # a scan holds the Pod stripe's lock: poll slowly
        time.sleep(0.5)
    check(False, f"{what}: {len(names - bound)} of {len(names)} pods never bound")


def phase_main(device, columnar_binds, per=MAIN_MEMORY_PER):
    """main.build_manager(kube, options) in process with the defaults,
    --journal-dir on the machine's disk and --flight-dir, over a fake
    provider of config_12's catalog (registered as "chip-config12"):

    - config_12's window at ``per`` pods a schedule (MAIN_MEMORY_PER, 104:
      2,496 pods; the wire phase runs the full width) created, then
      recovery.run() and manager.start(): every pod bound exactly once
      (group 15's ENI pods stay Pending), no leaked instance or ghost node,
      no open intent; the batcher's windows and the node count beside
      controller_columnar's 9,984-pod window, and at MAIN_PER where the
      first window took every pod, the same binds (the default global
      backend leaves config_12's plans as they are);
    - then MAIN_LATE_PODS more pods: their FFD problems answered by the
      native ring (the global leg beside them counts "device-global"), no
      pack launch;
    - over HTTP on a free port: /healthz and /readyz 200, /metrics with
      karpenter_cloudprovider_duration_seconds, /debug/vars as JSON with its
      seven keys, 404 otherwise;
    - every pack launch of the phase held bit for bit against the plain
      version on the tensors it launched (PackLaunches);
    - manager.stop() leaves none of its threads, nor the provisioning
      worker's, alive."""
    import shutil
    import threading
    from types import SimpleNamespace

    import torch

    from karpenter_tpu_torch import main as kmain
    from karpenter_tpu_torch.api.core import ObjectMeta
    from karpenter_tpu_torch.api.provisioner import Provisioner
    from karpenter_tpu_torch.chaos import soak
    from karpenter_tpu_torch.cloudprovider import spi
    from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider
    from karpenter_tpu_torch.config.options import Options
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.pressure import set_monitor
    from karpenter_tpu_torch.runtime.journal import IntentJournal
    from karpenter_tpu_torch.runtime.kubecore import KubeCore
    from karpenter_tpu_torch.scheduling import batcher as batcher_mod

    catalog = make_catalog(WINDOW_TYPES)
    spi.register("chip-config12", lambda: FakeCloudProvider(catalog=catalog))
    jdir, fdir = journal_dir("main"), journal_dir("flight")
    options = Options(cluster_name="chip", cluster_endpoint="http://localhost:6443",
                      cloud_provider="chip-config12", journal_dir=jdir, flight_dir=fdir,
                      device=device.type)
    check(options.validate() == [], f"main: options {options.validate()}")
    kube = KubeCore()
    windows, real_wait = [], batcher_mod.Batcher.wait

    def recording_wait(self):
        items, seconds = real_wait(self)
        if items:
            windows.append((len(items), seconds))
        return items, seconds

    t0 = time.perf_counter()
    manager = kmain.build_manager(kube, options)
    build_s = time.perf_counter() - t0
    provisioning = manager.controllers()[0]
    server = kmain.serve_observability(manager, free_port())
    port = server.server_address[1]
    batcher_mod.Batcher.wait = recording_wait
    try:
        kube.create(Provisioner(metadata=ObjectMeta(name="default")))
        pods = config12_controller_pods(catalog, per, "m")
        eni = {p.metadata.name for p in pods if "vpc.amazonaws.com/pod-eni"
               in p.spec.containers[0].resources.requests}
        for p in pods:
            kube.create(p)
        reset_counts()
        with PackLaunches() as launches:
            stats = manager.recovery.run()
            cpu0, t0 = thread_cpu_s(), time.perf_counter()
            manager.start()
            wait_bound(kube, [p.metadata.name for p in pods if p.metadata.name not in eni],
                       240.0, "main")
            window_s = time.perf_counter() - t0
            window_cpu = cpu_delta(cpu0, thread_cpu_s())
            torch.cuda.synchronize()
            first = {"executor_counts": executor_counts(),
                     "pack_chunk_launches": pack_cuda.LAUNCHES,
                     "pack_batch_launches": pack_cuda.BATCH_LAUNCHES,
                     "batch_windows": list(windows)}
            check(first["pack_batch_launches"] + first["pack_chunk_launches"] > 0,
                  "main: the window launched no pack kernel")
            check(len(launches.records) == first["pack_batch_launches"]
                  + first["pack_chunk_launches"], "main: a pack launch went unrecorded")
            reset_counts()
            late = [p for p in config12_controller_pods(catalog, 2, "late")
                    if p.metadata.name.split("-")[1] != "g15"][:MAIN_LATE_PODS]
            for p in late:
                kube.create(p)
            t0 = time.perf_counter()
            wait_bound(kube, [p.metadata.name for p in late], 60.0, "main late window")
            late_s = time.perf_counter() - t0
            late_rec = {"pods": len(late), "executor_counts": executor_counts(),
                        "pack_launches": pack_cuda.LAUNCHES + pack_cuda.BATCH_LAUNCHES,
                        "seconds": late_s}
            # the default global backend's relaxation rides every window
            # (as in the JAX package): its schedules count "device-global"
            check(late_rec["executor_counts"].get("native", 0) > 0
                  and set(late_rec["executor_counts"]) <= {"native", "device-global"}
                  and late_rec["pack_launches"] == 0,
                  f"main: the {len(late)}-pod window answered by "
                  f"{late_rec['executor_counts']} with {late_rec['pack_launches']} launches")
            http = {path: http_get(port, path) for path in
                    ("/healthz", "/readyz", "/metrics", "/debug/vars", "/nope")}
        held = len(launches.records)
        err = launches.held()
        check(err == 0, f"main: the phase's pack launches != plain ({err})")
        check(http["/healthz"][0] == 200 and http["/readyz"][0] == 200,
              f"main: healthz {http['/healthz']}, readyz {http['/readyz']}")
        check(http["/metrics"][0] == 200 and "karpenter_cloudprovider_duration_seconds_bucket"
              in http["/metrics"][1], "main: /metrics lacks the provider's durations")
        dv = json.loads(http["/debug/vars"][1])
        check(set(dv) == {"metrics", "pressure", "solver", "ring", "trace", "flight", "slo"},
              f"main: /debug/vars keys {sorted(dv)}")
        check(http["/nope"][0] == 404, "main: an unknown path answered")
        every = [p.metadata.name for p in pods + late if p.metadata.name not in eni]
        bound_once(kube, every, "main")
        found = soak.leaks(SimpleNamespace(kube=kube, provider=provisioning.cloud_provider))
        check(not found["leaked"] and not found["ghosts"], f"main: {found}")
        worker_threads = [w._thread for w in provisioning.workers.values()]
        t0 = time.perf_counter()
        manager.stop()
        stop_s = time.perf_counter() - t0
        alive = [t.name for t in manager.threads() + worker_threads if t.is_alive()]
        alive += [t.name for t in threading.enumerate() if t.name == "eviction-queue"]
        check(alive == [], f"main: threads alive after stop: {alive}")
        manager.journal.close_journal()
        check(IntentJournal(jdir, fsync=False).open_intents() == {}, "main: intents left open")
    finally:
        batcher_mod.Batcher.wait = real_wait
        manager.stop()
        server.shutdown()
        server.server_close()
        set_monitor(None)
        shutil.rmtree(jdir, ignore_errors=True)
        shutil.rmtree(fdir, ignore_errors=True)
    nodes = len(kube.scan("Node", lambda n: n.metadata.name))
    # the ENI pods enter the batcher too (the solve finds no type for them)
    one_window = first["batch_windows"][0][0] >= len(pods)

    def canonical_binds(binds):
        return sorted((t, tuple(sorted(names))) for t, names in binds)

    same = canonical_binds(strip_prefix(node_binds(kube, "m-"))) == \
        canonical_binds(columnar_binds)
    check(same or not one_window or per != MAIN_PER,
          "main: one window took every pod and its binds differ from controller_columnar's")
    rec = {"phase": "main", "per": per, "pods": len(pods), "unschedulable_eni": len(eni),
           "build_manager_s": build_s, "controllers": [type(c).__name__
                                                      for c in manager.controllers()],
           "recovery": stats, "window_s": window_s, "window_cpu_s": window_cpu,
           "first": first,
           "nodes_first_window": len(node_binds(kube, "m-")),
           "columnar_nodes_9984": len(columnar_binds), "one_window": one_window,
           "binds_equal_columnar": same, "late": late_rec,
           "nodes": nodes, "pack_launches_held": held,
           "max_abs_err": err, "stop_s": stop_s,
           "readyz": http["/readyz"][1], "debug_vars_keys": sorted(dv)}
    emit(rec)
    return rec


def thread_cpu_s():
    """CPU seconds so far of each group of live threads, from
    /proc/self/task: the Manager's workers, pumps and mapped pumps by
    controller kind (``work-Pod``, ``pump-Node``, ``map-Pod-Node``), and
    every other thread by name."""
    from collections import Counter
    import threading

    hz = os.sysconf("SC_CLK_TCK")
    out = Counter()
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        group = t.name.rsplit("-", 1)[0] if t.name.startswith("work-") else t.name
        out[group] += (int(fields[11]) + int(fields[12])) / hz
    return out


def cpu_delta(before, after):
    return {k: round(v - before.get(k, 0.0), 2) for k, v in
            sorted(after.items(), key=lambda kv: -(kv[1] - before.get(kv[0], 0.0)))
            if v - before.get(k, 0.0) > 0}


def manager_flood(catalog, per, deadline_s, device):
    """config_12's window at ``per`` pods a schedule under a fresh
    main.build_manager with the defaults (no journal): seconds from
    manager.start() until every pod but the ENI group is bound (or the
    deadline), the pods bound, and the CPU seconds of each thread group
    over that time."""
    import threading

    from karpenter_tpu_torch import main as kmain
    from karpenter_tpu_torch.api.core import ObjectMeta
    from karpenter_tpu_torch.api.provisioner import Provisioner
    from karpenter_tpu_torch.config.options import Options
    from karpenter_tpu_torch.pressure import set_monitor
    from karpenter_tpu_torch.runtime.kubecore import KubeCore

    kube = KubeCore()
    manager = kmain.build_manager(kube, Options(
        cluster_name="chip", cluster_endpoint="http://localhost:6443",
        cloud_provider="chip-config12", device=device.type))
    kube.create(Provisioner(metadata=ObjectMeta(name="default")))
    pods = [p for p in config12_controller_pods(catalog, per, f"f{per}")
            if "vpc.amazonaws.com/pod-eni" not in p.spec.containers[0].resources.requests]
    for p in pods:
        kube.create(p)
    cpu0, t0 = thread_cpu_s(), time.perf_counter()
    manager.start()
    try:
        bound = 0
        while time.perf_counter() - t0 < deadline_s:
            bound = sum(1 for b in kube.scan("Pod", lambda p: bool(p.spec.node_name)) if b)
            if bound == len(pods):
                break
            time.sleep(0.5)
        wall = time.perf_counter() - t0
        cpu, threads = cpu_delta(cpu0, thread_cpu_s()), threading.active_count()
    finally:
        manager.stop()
        set_monitor(None)
    return {"pods": len(pods), "bound": bound, "seconds": wall, "threads": threads,
            "cpu_s": cpu}


def phase_manager_flood(device):
    """``--manager-flood``: manager_flood at 104, 208 and 416 pods a
    schedule (2,496, 4,992 and 9,984 pods less the ENI group), each within
    MAIN_FLOOD_DEADLINE_S."""
    from karpenter_tpu_torch.cloudprovider import spi
    from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider

    catalog = make_catalog(WINDOW_TYPES)
    spi.register("chip-config12", lambda: FakeCloudProvider(catalog=catalog))
    for per in (104, 208, 416):
        emit({"phase": "manager_flood", "per": per,
              **manager_flood(catalog, per, MAIN_FLOOD_DEADLINE_S, device)})


def node_binds(kube, prefix):
    """(instance type, pod names) of every node holding a pod named with
    ``prefix``."""
    from karpenter_tpu_torch.api.wellknown import LABEL_INSTANCE_TYPE

    out = []
    for name, itype in kube.scan("Node", lambda n: (n.metadata.name,
                                                    n.metadata.labels[LABEL_INSTANCE_TYPE])):
        names = [p.metadata.name for p in kube.pods_on_node(name)
                 if p.metadata.name.startswith(prefix)]
        if names:
            out.append((itype, names))
    return out


def phase_main_process(device):
    """``python -m karpenter_tpu_torch.main`` as a process of its own on the
    card, as an operator starts it: --cloud-provider fake --kube-backend
    memory --solver-warmup --leader-elect --journal-dir. The seconds from
    spawn to the first /readyz 200 and the warm-up's share of them (the
    pass's own log line); SIGTERM exits 0 with the Lease released (its log
    line); without --cluster-name the process exits 1."""
    import shutil
    import signal
    import threading

    repo = os.path.dirname(os.path.abspath(__file__))
    d = journal_dir("process")
    port = free_port()
    argv = [sys.executable, "-m", "karpenter_tpu_torch.main", "--cluster-name", "chip",
            "--cluster-endpoint", "http://localhost:6443", "--cloud-provider", "fake",
            "--kube-backend", "memory", "--solver-warmup", "--leader-elect",
            "--journal-dir", d, "--metrics-port", str(port)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    captured = []
    drainer = threading.Thread(target=lambda: captured.extend(proc.stdout), daemon=True)
    drainer.start()
    try:
        ready_s = None
        while time.perf_counter() - t0 < MAIN_PROCESS_DEADLINE_S and proc.poll() is None:
            try:
                if http_get(port, "/readyz", timeout=1.0)[0] == 200:
                    ready_s = time.perf_counter() - t0
                    break
            except OSError:
                pass
            time.sleep(0.05)
        check(ready_s is not None,
              f"main_process: /readyz never answered 200 (rc {proc.poll()}):\n"
              f"{''.join(captured)[-3000:]}")
        metrics = http_get(port, "/metrics")[1]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
        drainer.join(10.0)
        shutil.rmtree(d, ignore_errors=True)
    log = "".join(captured)
    check(rc == 0, f"main_process: SIGTERM exit rc {rc}:\n{log[-3000:]}")
    check("released lease" in log, "main_process: the Lease was not released")
    check(log.index("journal recovery") < log.index("karpenter-tpu started"),
          "main_process: the manager started before recovery")
    warm = [ln for ln in log.splitlines() if "solver warmup:" in ln]
    check(len(warm) == 1, f"main_process: warm-up lines {warm}")
    warm_s = float(warm[0].rsplit(" in ", 1)[1].rstrip("s"))
    bad = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.main",
                          "--cluster-endpoint", "http://localhost:6443",
                          "--cloud-provider", "fake", "--kube-backend", "memory"],
                         cwd=repo, capture_output=True, text=True, timeout=120)
    check(bad.returncode == 1, f"main_process: no --cluster-name exited {bad.returncode}")
    rec = {"phase": "main_process", "boot_to_ready_s": ready_s, "warmup_s": warm_s,
           "warmup_share": warm_s / ready_s, "sigterm_rc": rc, "lease_released": True,
           "no_cluster_name_rc": bad.returncode,
           "device": os.environ.get("KARPENTER_DEVICE", "cuda"),
           "metrics_series": metrics.count("# TYPE ")}
    emit(rec)
    return rec


WIRE_WATCH_IDLE_S = 60.0
WIRE_WRITERS = 8
WIRE_SETTLE_DEADLINE_S = 120.0
WIRE_STOP_TIMEOUT_S = 120.0


def process_cpu_s(pid="self"):
    """User + system CPU seconds of a process so far, from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def stub_state(url):
    import urllib.request

    with urllib.request.urlopen(f"{url}/stub/state", timeout=30.0) as r:
        return json.loads(r.read())


def stub_behavior(url, update):
    import urllib.request

    req = urllib.request.Request(f"{url}/stub/behavior", data=json.dumps(update).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30.0) as r:
        r.read()


def start_stub():
    """runtime/stubserver.py in a child process of its own (its threads and
    GIL apart from the controller's) on a free port over plain HTTP: the
    process and its URL."""
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.runtime.stubserver",
         "--watch-idle-seconds", str(WIRE_WATCH_IDLE_S)],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout=30.0)
        check(False, f"wire: the stub API server did not start (rc {proc.returncode})")
    return proc, json.loads(line)["url"]


def writes_settled(url, deadline_s, hold_s=5.0):
    """Seconds until the stub has seen no binding POST and no node create
    for ``hold_s``: the selection controller requeues a pod until its bind
    reaches the informer cache, so windows of pods already bound run (their
    binds answer 409) until the cache has caught up. The ENI group's pods
    stay Pending and keep coming back in windows of their own, which
    launch and bind nothing."""
    t0 = quiet = time.perf_counter()
    last = None
    while time.perf_counter() - t0 < deadline_s:
        counts = stub_state(url)["counts"]
        now = time.perf_counter()
        seen = (counts.get("create pods/binding", 0), counts.get("create nodes", 0))
        if seen != last:
            last, quiet = seen, now
        elif now - quiet >= hold_s:
            return now - t0
        time.sleep(0.25)
    check(False, f"wire: binds and node creates still coming after {deadline_s} s")


def wire_binds(kube, every, eni):
    """One LIST of the pods and one of the nodes, read over the wire: the
    pods of ``every`` not bound to a node that exists, the ENI pods that
    were bound, and the nodes whose pods' summed requests exceed their
    capacity. A pod has one spec.nodeName and the binding subresource
    refuses a second bind, so a pod bound is bound once."""
    from collections import defaultdict

    cap = {n.metadata.name: n.status.capacity for n in kube.list("Node", namespace=None)}
    node_of = {}
    used = defaultdict(dict)
    for p in kube.list("Pod"):
        node_of[p.metadata.name] = p.spec.node_name
        if p.spec.node_name not in cap:
            continue
        u = used[p.spec.node_name]
        for c in p.spec.containers:
            for k, q in c.resources.requests.items():
                u[k] = u[k].add(q) if k in u else q
    unbound = [n for n in every if node_of.get(n) not in cap]
    over = [name for name, u in used.items()
            if any(k not in cap[name] or q.cmp(cap[name][k]) > 0 for k, q in u.items())]
    return unbound, [n for n in eni if node_of.get(n)], over


def phase_wire(device, per=MAIN_PER):
    """The Manager over HTTP at full width: runtime/stubserver.py in a child
    process, a second client (its own generous limiter) creating
    Provisioner("default") and config_12's window at ``per`` pods a schedule
    (9,984 at MAIN_PER, the ENI group among them), then
    main.build_manager(KubeApiClient(url), Options(defaults)) with the
    default 200 QPS / 300 burst, --journal-dir and --flight-dir on the
    machine's disk, recovery.run() and manager.start(); once the batcher
    has taken its first window the stub ends the next Pod watch stream
    with a 410 Expired. Checks, each read back from the stub over the wire:

    - every pod but the ENI group bound exactly once within
      MAIN_FLOOD_DEADLINE_S, each bound pod's node exists and its pods'
      summed requests fit its capacity;
    - no leaked instance, no ghost Node, no open intent;
    - at least one pack_batch launch on the card, every pack launch of the
      phase held bit for bit against the plain version (PackLaunches);
    - karpenter_watch_relist_total{reason="expired"} rose, no pod was lost
      across the relist (the stub holds every pod created);
    - once the re-offered windows have run out (the selection controller
      requeues a pod until its bind reaches the informer cache;
      writes_settled), manager.stop() and the client's stop_watches()
      leave no thread alive, and the stub's process exits 0 on SIGTERM.

    Records the seconds to all bound, the batcher's windows and the nodes,
    the requests by verb and resource as the stub counted them, the count
    and sum of karpenter_kube_client_throttle_seconds, the highest pressure
    level and throttle signal seen, and each thread group's CPU seconds."""
    import shutil
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    import torch

    from karpenter_tpu_torch import main as kmain
    from karpenter_tpu_torch.api.core import ObjectMeta
    from karpenter_tpu_torch.api.provisioner import Provisioner
    from karpenter_tpu_torch.chaos import soak
    from karpenter_tpu_torch.cloudprovider import spi
    from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider
    from karpenter_tpu_torch.config.options import Options
    from karpenter_tpu_torch.metrics.pressure import KUBE_CLIENT_THROTTLE_SECONDS
    from karpenter_tpu_torch.metrics.recovery import WATCH_RELIST_TOTAL
    from karpenter_tpu_torch.ops import pack_cuda
    from karpenter_tpu_torch.pressure import get_monitor, set_monitor
    from karpenter_tpu_torch.runtime.journal import IntentJournal
    from karpenter_tpu_torch.runtime.kubeclient import KubeApiClient
    from karpenter_tpu_torch.scheduling import batcher as batcher_mod

    def relists():
        return {dict(lv).get("reason"): v for lv, v in WATCH_RELIST_TOTAL.collect().items()
                if dict(lv).get("kind") == "Pod"}

    def throttle():
        _, total, count = KUBE_CLIENT_THROTTLE_SECONDS.collect().get((), ([], 0.0, 0))
        return total, count

    catalog = make_catalog(WINDOW_TYPES)
    spi.register("chip-config12", lambda: FakeCloudProvider(catalog=catalog))
    jdir, fdir = journal_dir("wire"), journal_dir("wire-flight")
    proc, url = start_stub()
    windows, real_wait = [], batcher_mod.Batcher.wait

    def recording_wait(self):
        items, seconds = real_wait(self)
        if items:
            windows.append((len(items), seconds))
        return items, seconds

    manager = kube = None
    try:
        writer = KubeApiClient(url, qps=1e6, burst=1_000_000)
        pods = config12_controller_pods(catalog, per, "w")
        eni = {p.metadata.name for p in pods if "vpc.amazonaws.com/pod-eni"
               in p.spec.containers[0].resources.requests}
        t0 = time.perf_counter()
        writer.create(Provisioner(metadata=ObjectMeta(name="default")))
        with ThreadPoolExecutor(WIRE_WRITERS) as pool:
            list(pool.map(writer.create, pods))
        create_s = time.perf_counter() - t0
        check(stub_state(url)["pods"] == len(pods), "wire: the stub holds fewer pods than made")
        options = Options(cluster_name="chip", cluster_endpoint=url,
                          cloud_provider="chip-config12", journal_dir=jdir, flight_dir=fdir,
                          device=device.type)
        check(options.validate() == [], f"wire: options {options.validate()}")
        kube = KubeApiClient(url, qps=options.kube_client_qps, burst=options.kube_client_burst)
        t0 = time.perf_counter()
        manager = kmain.build_manager(kube, options)
        build_s = time.perf_counter() - t0
        provisioning = manager.controllers()[0]
        monitor = get_monitor()
        relist0, throttle0 = relists(), throttle()
        batcher_mod.Batcher.wait = recording_wait
        reset_counts()
        want = len(pods) - len(eni)
        with PackLaunches() as launches:
            stats = manager.recovery.run()
            cpu0, t0 = thread_cpu_s(), time.perf_counter()
            manager.start()
            armed_at, level, signal_max, state, progress = None, 0, 0.0, {}, []
            while time.perf_counter() - t0 < MAIN_FLOOD_DEADLINE_S:
                if armed_at is None and windows:
                    stub_behavior(url, {"watch_410_next": "Pod"})
                    armed_at = time.perf_counter() - t0
                level = max(level, int(monitor.level()))
                signal_max = max(signal_max, monitor.signals()["throttle_seconds"])
                state = stub_state(url)
                now = time.perf_counter() - t0
                if not progress or now - progress[-1][0] >= 10.0:
                    # (s, pods bound, binding POSTs, windows, level, limiter
                    # waits, CPU s of this process and of the stub's)
                    progress.append((round(now, 1), state["pods_bound"],
                                     state["counts"].get("create pods/binding", 0),
                                     len(windows), int(monitor.level()), throttle()[1],
                                     round(process_cpu_s(), 1),
                                     round(process_cpu_s(proc.pid), 1)))
                if state["pods_bound"] >= want:
                    break
                time.sleep(0.25)
            bound_s = time.perf_counter() - t0
            cpu = cpu_delta(cpu0, thread_cpu_s())
            settle_s = None
            if state.get("pods_bound") == want:
                # every launch of the phase is held, the re-offered windows' too
                settle_s = writes_settled(url, WIRE_SETTLE_DEADLINE_S)
            if device.type == "cuda":
                torch.cuda.synchronize()
            launched = {"pack_chunk": pack_cuda.LAUNCHES, "pack_batch": pack_cuda.BATCH_LAUNCHES}
        check(state.get("pods_bound") == want,
              f"wire: {state.get('pods_bound')} of {want} pods bound in "
              f"{MAIN_FLOOD_DEADLINE_S} s; windows {windows}; (s, bound, binding POSTs, "
              f"windows, level, limiter waits, CPU s, stub CPU s) {progress}; requests "
              f"{state.get('counts')}; CPU s by thread group {cpu}")
        check(state["pods"] == len(pods), f"wire: pods lost: {state['pods']} of {len(pods)}")
        relisted = {k: v - relist0.get(k, 0.0) for k, v in relists().items()}
        check(armed_at is not None and relisted.get("expired", 0) >= 1,
              f"wire: no expired relist of the Pod watch ({relisted})")
        if device.type == "cuda":
            check(launched["pack_batch"] >= 1, "wire: the window launched no pack_batch")
        check(len(launches.records) == launched["pack_batch"] + launched["pack_chunk"],
              "wire: a pack launch went unrecorded")
        held = len(launches.records)
        err = launches.held()
        check(err == 0, f"wire: the phase's pack launches != plain ({err})")
        every = [p.metadata.name for p in pods if p.metadata.name not in eni]
        unbound, eni_bound, over = wire_binds(writer, every, eni)
        check(not unbound and not eni_bound and not over,
              f"wire: pods not on a live node {unbound[:3]}, ENI pods bound {eni_bound[:3]}, "
              f"nodes over capacity {over[:3]}")
        found = soak.leaks(SimpleNamespace(kube=writer, provider=provisioning.cloud_provider))
        check(not found["leaked"] and not found["ghosts"], f"wire: {found}")
        throttled = throttle()
        worker_threads = [w._thread for w in provisioning.workers.values()]
        t0 = time.perf_counter()
        manager.stop(timeout=WIRE_STOP_TIMEOUT_S)
        kube.stop_watches()
        for t in kube._watch_threads:
            t.join(10.0)
        stop_s = time.perf_counter() - t0
        alive = [t.name for t in manager.threads() + worker_threads + kube._watch_threads
                 if t.is_alive()]
        alive += [t.name for t in threading.enumerate() if t.name == "eviction-queue"]
        check(alive == [], f"wire: threads alive after stop: {alive}")
        manager.journal.close_journal()
        check(IntentJournal(jdir, fsync=False).open_intents() == {}, "wire: intents left open")
        nodes = len(writer.list("Node", namespace=None))
        requests = stub_state(url)["counts"]
    finally:
        batcher_mod.Batcher.wait = real_wait
        if manager is not None:
            manager.stop()
        if kube is not None:
            kube.stop_watches()
        set_monitor(None)
        proc.terminate()
        try:
            stub_rc = proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            stub_rc = proc.wait(timeout=30.0)
        shutil.rmtree(jdir, ignore_errors=True)
        shutil.rmtree(fdir, ignore_errors=True)
    check(stub_rc == 0, f"wire: the stub process exited {stub_rc}")
    rec = {"phase": "wire", "pods": len(pods), "unschedulable_eni": len(eni),
           "create_s": create_s, "build_manager_s": build_s, "recovery": stats,
           "seconds_to_all_bound": bound_s, "expired_armed_at_s": armed_at,
           "progress": progress,
           "batch_windows": windows, "nodes": nodes, "main_nodes": 161,
           "launches": launched, "pack_launches_held": held, "max_abs_err": err,
           "settle_s": settle_s,
           "bind_conflicts": requests.get("create pods/binding", 0) - (len(pods) - len(eni)),
           "relists": relisted, "requests": dict(sorted(requests.items())),
           "throttle_seconds": {"count": throttled[1] - throttle0[1],
                                "sum": throttled[0] - throttle0[0]},
           "pressure": {"highest_level": level, "throttle_signal_max": signal_max},
           "cpu_s": cpu, "stop_s": stop_s, "stub_rc": stub_rc}
    emit(rec)
    return rec


def phase_webhook(device):
    """webhooks.server.serve on the card's host over plain HTTP, with the
    port's fake provider and no CertManager: a defaulting review (its JSON
    patch the capacity-type requirement's, as the CPU tests hold against the
    JAX package), two validating reviews (one valid, one denied with its
    reasons) and a logging-config review; /healthz; the server shuts down
    and its thread ends."""
    import base64
    import threading
    import urllib.request

    from karpenter_tpu_torch.cloudprovider import spi
    from karpenter_tpu_torch.cloudprovider.fake import provider as _fake  # noqa: F401 — "fake"
    from karpenter_tpu_torch.webhooks import server as wserver

    manifest = {"apiVersion": "karpenter.sh/v1alpha5", "kind": "Provisioner",
                "metadata": {"name": "default"},
                "spec": {"labels": {"team": "ml"},
                         "requirements": [{"key": "topology.kubernetes.io/zone",
                                           "operator": "In", "values": ["test-zone-1"]}],
                         "ttlSecondsAfterEmpty": 30}}
    bad = json.loads(json.dumps(manifest))
    bad["spec"]["labels"] = {"kubernetes.io/hostname": "x"}
    bad["spec"]["requirements"][0]["operator"] = "Exists"

    class CapacityTypeDefault:
        """The fake provider, defaulting an on-demand capacity type."""

        def __init__(self, provider):
            self.provider = provider

        def default(self, constraints):
            from karpenter_tpu_torch.api.core import NodeSelectorRequirement

            if constraints.requirements.capacity_types() is None:
                constraints.requirements = constraints.requirements.add(NodeSelectorRequirement(
                    key="karpenter.sh/capacity-type", operator="In", values=["on-demand"]))

        def validate(self, constraints):
            return self.provider.validate(constraints)

    server = wserver.serve(port=0, cloud_provider=CapacityTypeDefault(spi.resolve("fake")),
                           host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True, name="webhook")
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def review(path, obj, uid):
        req = urllib.request.Request(base + path, data=json.dumps(
            {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
             "request": {"uid": uid, "object": obj}}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=30.0) as r:
            body = json.loads(r.read())
        return body, (time.perf_counter() - t0) * 1e3

    try:
        ms = {}
        d, ms["default"] = review("/default-resource", manifest, "u-default")
        ok, ms["validate_ok"] = review("/validate-resource", manifest, "u-ok")
        no, ms["validate_denied"] = review("/validate-resource", bad, "u-bad")
        cfg, ms["config"] = review("/config-validation", {
            "metadata": {"name": "config-logging"},
            "data": {"zap-logger-config": '{"level": "info"}'}}, "u-cfg")
        health = http_get(server.server_address[1], "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10.0)
    for body, uid in ((d, "u-default"), (ok, "u-ok"), (no, "u-bad"), (cfg, "u-cfg")):
        check(body.get("apiVersion") == "admission.k8s.io/v1"
              and body.get("kind") == "AdmissionReview"
              and body["response"]["uid"] == uid, f"webhook: reply {body}")
    patch = json.loads(base64.b64decode(d["response"]["patch"]))
    # _json_patch replaces a list whole: the requirements with the default added
    want_patch = [{"op": "replace", "path": "/spec/requirements",
                   "value": manifest["spec"]["requirements"] + [{
                       "key": "karpenter.sh/capacity-type", "operator": "In",
                       "values": ["on-demand"]}]}]
    check(d["response"]["allowed"] is True and d["response"]["patchType"] == "JSONPatch"
          and patch == want_patch, f"webhook: defaulting patch {patch}")
    check(ok["response"]["allowed"] is True, f"webhook: a valid manifest denied {ok}")
    message = no["response"].get("status", {}).get("message", "")
    check(no["response"]["allowed"] is False and "operator Exists" in message
          and "kubernetes.io/hostname" in message, f"webhook: the bad manifest {no}")
    check(cfg["response"]["allowed"] is True, f"webhook: config review {cfg}")
    check(health == (200, "ok"), f"webhook: /healthz {health}")
    check(not thread.is_alive(), "webhook: the server thread is alive after shutdown")
    rec = {"phase": "webhook", "reviews_ms": ms, "patch": patch,
           "denied": message, "healthz": health[1]}
    emit(rec)
    return rec


def phase_wire_alone(device):
    """``--wire``: the kernels built, then the wire and webhook phases."""
    build_all()
    phase_wire(device)
    phase_webhook(device)


def build_all():
    """Build every kernel library at once, one nvcc each, and load them."""
    import threading

    from karpenter_tpu_torch.ops import pack_cuda, whatif_cuda

    errors = []

    def run(build):
        try:
            build()
        except Exception as e:  # reported below, from this thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(b,))
               for b in (pack_cuda.build, whatif_cuda.build)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    pack_cuda._library()
    whatif_cuda._library()


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def main(argv) -> int:
    t_start = time.perf_counter()
    if argv not in ([], ["--kernel-times"], ["--solve-times"], ["--controller-deployed"],
                    ["--whatif-times"], ["--manager-flood"], ["--wire"]):
        print("usage: chip_smoke.py [--kernel-times | --solve-times | --controller-deployed"
              " | --whatif-times | --manager-flood | --wire]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from karpenter_tpu_torch.ops import pack_cuda, whatif_cuda

    device = torch.device("cuda")
    card = card_line()
    if argv:
        emit({"phase": "card", "nvidia_smi": card})
        {"--kernel-times": phase_kernel_times, "--solve-times": phase_solve_times,
         "--controller-deployed": phase_controller_deployed,
         "--whatif-times": phase_whatif_times,
         "--manager-flood": phase_manager_flood,
         "--wire": phase_wire_alone}[argv[0]](device)
        return 0
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    build_all()
    emit({"phase": "build", "seconds": pack_cuda.BUILD_SECONDS,
          "ptxas": ptxas_lines(pack_cuda.BUILD_LOG),
          "launch": {f"T={T}": {"cluster": c, "types_per_thread": 1,
                                "threads": pack_cuda.launch_threads(T, c)}
                     for T in (8, 512, 4096) for c in [pack_cuda.launch_shape(T)]},
          "whatif": {"seconds": whatif_cuda.BUILD_SECONDS,
                     "ptxas": ptxas_lines(whatif_cuda.BUILD_LOG)}})

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(json.dumps({"phase_seconds": name, "seconds": time.perf_counter() - t0}),
              flush=True)
        return out

    wf = timed("whatif_fuzz", phase_whatif_fuzz, device)
    fuzz_err = timed("fuzz", phase_fuzz, device)
    batch_err = timed("batch_fuzz", phase_batch_fuzz, device)
    c4 = timed("config4", phase_config4, device)
    hc = timed("highcard", phase_highcard, device)
    timed("mask", phase_mask, device)
    win = timed("window_416", phase_window, device, 416, WARM_RUNS)   # 9,984 pods
    timed("window_2084", phase_window, device, 2084, WARM_RUNS)       # 50,016 pods
    timed("mixed_window", phase_mixed_window, device)
    md = timed("marshal_delta", phase_marshal_delta, device)
    timed("controller", phase_controller, device)
    cc = timed("controller_columnar", phase_controller_columnar, device)
    timed("observability", phase_observability, device, cc["binds"])
    jn = timed("journal", phase_journal, device, cc["binds"])
    gp = timed("global_program", phase_global_program, device)
    gw = timed("global_window", phase_global_window, device)
    timed("global_window_400", phase_global_window_400, device)
    ww = timed("whatif_window", phase_whatif_window, device)
    dp = timed("deprovision", phase_deprovision, device)
    af = timed("affinity_fuzz", phase_affinity_fuzz, device)
    pw = timed("policy_window", phase_policy_window, device)
    ca = timed("controller_affinity", phase_controller_affinity, device)
    gf = timed("gang_fuzz", phase_gang_fuzz, device)
    cf = timed("carve_fuzz", phase_carve_fuzz, device)
    gw10 = timed("gang_window", phase_gang_window, device)
    timed("carve_window", phase_carve_window, device)
    cg = timed("controller_gang", phase_controller_gang, device)
    gj = timed("gang_journal", phase_gang_journal, device)
    timed("native_ring", phase_native_ring, device)
    timed("warmup", phase_warmup, device)
    mn = timed("main", phase_main, device, cc["binds"])
    timed("main_process", phase_main_process, device)
    wr = timed("wire", phase_wire, device)
    timed("webhook", phase_webhook, device)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    b8 = gw["relax_pack"]
    b6 = pw["config13"]["program"]
    priced = pw["config13"]["priced_pack_batch"]
    emit({"device_programs": [{
        "name": "relax_node_counts (window)",
        "source": "karpenter_tpu_torch/solver/global_solve.py",
        "replaces": "karpenter_tpu/solver/global_solve.py:77",
        "runs": gp["runs"], "launches_per_call": gp["launches_per_call"],
        "max_abs_err": gp["max_abs_err"], "ms": gp["ms"], "cpu_ms": gp["cpu_ms"],
        "bound_ms": gp["bound_ms"], "bound_by": gp["bound_by"],
        "eager_state_bound_ms": gp["eager_state_bound_ms"],
        "shape": [gp["b"], gp["sb"], gp["tb"]],
    }, {
        "name": "relax_node_counts (repack, B = 1)",
        "source": "karpenter_tpu_torch/solver/relax.py",
        "replaces": "karpenter_tpu/solver/relax.py:87",
        "runs": b8["runs"], "launches_per_call": b8["launches_per_call"],
        "max_abs_err": b8["max_abs_err"], "ms": b8["ms"], "cpu_ms": b8["cpu_ms"],
        "bound_ms": b8["bound_ms"], "bound_by": b8["bound_by"],
        "eager_state_bound_ms": b8["eager_state_bound_ms"],
        "shape": [b8["b"], b8["sb"], b8["tb"]],
    }, {
        "name": "affinity_program (B5)",
        "source": "karpenter_tpu_torch/ops/device_filter.py",
        "replaces": "karpenter_tpu/ops/device_filter.py:709",
        "runs": ca["runs"]["cheapest"]["programs"]["affinity"],
        "launches_per_call": af["launches_per_call"], "max_abs_err": af["max_abs_err"],
        "ms": af["ms"], "cpu_ms": af["cpu_ms"], "bound_ms": af["bound_ms"],
        "bound_by": af["bound_by"], "shape": af["shape"],
    }, {
        "name": "policy scoring _cells_expr (B6)",
        "source": "karpenter_tpu_torch/ops/policy.py",
        "replaces": "karpenter_tpu/ops/policy.py:267",
        "runs": ca["runs"]["interruption-priced"]["programs"]["policy"],
        "launches_per_call": b6["launches_per_call"], "max_abs_err": b6["mirror_divergence"],
        "ms": b6["ms"], "cpu_ms": b6["cpu_ms"], "bound_ms": b6["bound_ms"],
        "bound_by": b6["bound_by"], "shape": b6["shape"],
        "soft_rows": {k: pw["config18"]["program"][k] for k in
                      ("ms", "cpu_ms", "bound_ms", "launches_per_call", "shape")},
    }, {
        "name": "carve_program (B11)",
        "source": "karpenter_tpu_torch/solver/topology.py",
        "replaces": "karpenter_tpu/solver/topology.py:63",
        "runs": cg["window1"]["launches"]["carve"],
        "launches_per_call": cf["program"]["launches_per_call"], "max_abs_err": cf["max_abs_err"],
        "ms": cf["program"]["ms"], "cpu_ms": cf["program"]["cpu_ms"],
        "bound_ms": cf["program"]["bound_ms"], "bound_by": cf["program"]["bound_by"],
        "shape": cf["program"]["shape"],
    }, {
        "name": "gang_member_column (B4's rest)",
        "source": "karpenter_tpu_torch/ops/device_filter.py",
        "replaces": "karpenter_tpu/ops/device_filter.py:339",
        "runs": cg["window1"]["launches"]["member_column"],
        "launches_per_call": cf["member_column"]["launches_per_call"], "max_abs_err": 0,
        "ms": cf["member_column"]["ms"], "cpu_ms": cf["member_column"]["cpu_ms"],
        "bound_ms": cf["member_column"]["bound_ms"], "bound_by": cf["member_column"]["bound_by"],
        "shape": cf["member_column"]["shape"],
    }, {
        "name": "ring refill (B13)",
        "source": "karpenter_tpu_torch/solver/pipeline.py",
        "replaces": "karpenter_tpu/solver/pipeline.py:77",
        # a copy on the copy engine, not a kernel: the refills of the
        # controller's steady 9,984-pod window (controller_columnar's
        # second columnar window), timed on the solve's working set
        "runs": sum(r["ring"]["refills"] for r in cc["columnar"]),
        "launches_per_call": md["refill"]["copies"],
        "refills_per_window": cc["columnar"][1]["ring"]["refills"],
        "reuses_per_window": cc["columnar"][1]["ring"]["reuses"],
        "max_abs_err": md["refill"]["max_abs_err"], "ms": md["refill"]["ms"],
        "cpu_ms": md["refill"]["cpu_ms"], "bound_ms": md["refill"]["bound_ms"],
        "bound_by": md["refill"]["bound_by"], "bytes": md["refill"]["bytes"],
        "probe_16mib": {k: md["refill_16mib"][k] for k in ("bytes", "ms", "bound_ms")},
    }]})
    k4, kw = c4["kernel"], win["kernel"]
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
    }, {
        "name": "pack_batch",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/pack.cu",
        "replaces": "karpenter_tpu/parallel/sharded_pack.py:90",
        "launches": win["launches_per_window"]["pack_batch"],
        # the batched launches of phase 7 and of the policy window, every
        # pack launch of the journal phase's re-driven windows after a crash
        # and every one of the main and wire phases' windows under the Manager
        "max_abs_err": max(batch_err, kw["max_abs_err"], priced["max_abs_err"],
                           jn["crash"]["max_abs_err"], mn["max_abs_err"], wr["max_abs_err"]),
        "ms": kw["ms"], "plain_ms": kw["plain_ms"],
        "bound_ms": kw["bound_ms"], "bound_by": kw["bound_by"],
        "priced": {"ms": priced["ms"], "unpriced_ms": priced["unpriced_ms"],
                   "plain_ms": priced["plain_ms"], "bound_ms": priced["bound_ms"],
                   "bound_by": priced["bound_by"],
                   "launches": pw["config13"]["launches"]["pack_batch"]},
        "library_ms": None,
    }, {
        "name": "whatif_scan",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/whatif.cu",
        "replaces": "karpenter_tpu/solver/whatif.py:49",
        "launches": dp["whatif_launches"],
        "max_abs_err": max(wf["max_abs_err"], ww["kernel"]["max_abs_err"], dp["max_abs_err"]),
        "ms": dp["kernel"]["ms"], "device_ms": dp["kernel"]["device_ms"],
        "plain_ms": dp["kernel"]["plain_ms"],
        "bound_ms": dp["kernel"]["bound_ms"], "bound_by": dp["kernel"]["bound_by"],
        "shape": dp["kernel"]["shape"], "library_ms": None,
    }, {
        "name": "whatif_scan (gang co-pack, B10)",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/whatif.cu",
        "replaces": "karpenter_tpu/solver/gang.py:56",
        "launches": cg["window1"]["launches"]["whatif"],
        "max_abs_err": max(gf["max_abs_err"], gw10["config11"]["kernel"]["max_abs_err"],
                           gw10["full"]["kernel"]["max_abs_err"], cg["max_abs_err"],
                           gj["max_abs_err"]),
        # the times and the bound are the full-width window's; the main
        # path's launches (controller_gang window 1) were at main_path_shapes
        "main_path_shapes": cg["window1"]["gang_shapes"],
        "ms": gw10["full"]["kernel"]["ms"], "device_ms": gw10["full"]["kernel"]["device_ms"],
        "queued_ms": gw10["full"]["kernel"]["queued_ms"],
        "plain_ms": gw10["full"]["kernel"]["plain_ms"],
        "bound_ms": gw10["full"]["kernel"]["bound_ms"],
        "bound_by": gw10["full"]["kernel"]["bound_by"],
        "shape": gw10["full"]["kernel"]["shape"], "library_ms": None,
        "config11": {k: gw10["config11"]["kernel"][k] for k in
                     ("ms", "device_ms", "queued_ms", "plain_ms", "bound_ms", "bound_by",
                      "shape")},
    }]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
