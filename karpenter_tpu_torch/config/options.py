"""Process options: flags + environment.

Reference: pkg/utils/options/options.go:33-76. Flags fall back to
KARPENTER_-prefixed environment variables; validation mirrors the
reference's required-field and port checks.

The JAX package's flags, environment names, defaults and checks, with
these differences:

- ``--device`` (``cuda``, the default, or ``cpu``) names where the solver
  and its kernels run; it takes the place of ``JAX_PLATFORMS``: ``cuda``
  is the solver mesh of every visible card (``CUDA_VISIBLE_DEVICES``
  restricts it, as it restricts ``jax.devices()``), over which every
  device window splits its rows (parallel/mesh.py), ``cpu`` one CPU
  device;
- ``--trace-annotations`` replaces ``--trace-jax``: every entered span is
  also a ``torch.profiler.record_function`` range;
- ``--solver-use-device`` is gone: the port always solves a problem at or
  above ``SolverConfig.device_min_pods`` on the device;
- ``--solver-compile-cache-dir`` names the directory the kernel libraries
  are built into and loaded from (solver/warmup.py);
- ``--kube-backend in-cluster`` builds the API client
  (runtime/kubeclient.py) from the pod's service account, with
  ``--kube-client-qps`` / ``--kube-client-burst`` as its budget;
- a boolean flag also takes ``=true`` / ``=false`` (``--leader-elect=false``),
  as Go's flags do: the port's chart (charts/karpenter-tpu-torch) writes
  its boolean flags from values that way.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Options:
    cluster_name: str = ""
    cluster_endpoint: str = ""
    metrics_port: int = 8080
    health_probe_port: int = 8081
    webhook_port: int = 8443
    kube_client_qps: int = 200
    kube_client_burst: int = 300
    cloud_provider: str = "fake"
    # the controller's own namespace: where config-logging lives and where
    # the election Lease is written. Defaults from the POD_NAMESPACE
    # downward-API env (deploy/controller.yaml) so the deployed namespace
    # ("karpenter") wins over the dev default.
    namespace: str = field(
        default_factory=lambda: os.environ.get("POD_NAMESPACE", "default"))
    # API backend: "in-cluster" (real API server via the service account,
    # runtime/kubeclient.py) or "memory" (runtime/kubecore.py — dev/tests)
    kube_backend: str = "memory"
    # single-writer guard across replicas (cmd/controller/main.go:80-81)
    leader_elect: bool = False
    # batching (batcher.go:23-28 defaults; max_items raised — see batcher.py)
    batch_idle_seconds: float = 1.0
    batch_max_seconds: float = 10.0
    batch_max_items: int = 50_000
    # horizontal control-plane shards: N long-lived
    # intake/provisioning workers, provisioners assigned by crc32(name)%N;
    # 0 = one worker per Provisioner CR (the reference's shape)
    provisioning_shards: int = 0
    # where the solver and its kernels run: "cuda" (the card) or "cpu" (the
    # plain PyTorch versions, for tests)
    device: str = "cuda"
    # pipelined hot loop (solver/pipeline.py): dispatched-but-unfetched
    # solve chunks in flight (1 = serial; collapses to 1 at pressure L1+)
    pipeline_depth: int = 2
    # L0 chunk size the pipeline overlaps over; applied at every depth so
    # serial and pipelined runs see identical chunk boundaries; 0 disables
    pipeline_chunk_items: int = 4096
    # step the depth 1↔3 from measured per-window overlap instead of
    # pinning the flag (solver/pipeline.py _AdaptiveDepth); pipeline-depth
    # becomes the starting point
    pipeline_adaptive: bool = True
    # device ring (solver/pipeline.py DeviceRing): steady-state chunks
    # refill device-resident buffers in place instead of allocating; off
    # copies every solve's inputs to fresh tensors
    solver_donate: bool = True
    # build the kernel libraries and launch the (shape × type) bucket ladder
    # at boot (solver/warmup.py)
    solver_warmup: bool = False
    # packing policy (solver/policy.py registry): cheapest |
    # interruption-priced | throughput-per-dollar. The default preserves
    # today's cheapest-feasible ordering/tiebreak bit-for-bit.
    packing_policy: str = "cheapest"
    # pins the interruption-priced policy's repack price ($/h) instead of the
    # per-chunk what-if estimate; 0 = let the what-if engine price each chunk.
    # Also the consolidation keep-cost premium on spot nodes (rate x this).
    policy_repack_cost: float = 0.0
    # provisioning-window packing backend (solver/global_solve.py): ffd |
    # global. "global" solves the whole window jointly as one batched
    # relaxation with FFD as the exact rounding oracle; pressure L1+ and
    # gang schedules keep FFD, and KARPENTER_GLOBAL_SOLVE=0 kills the
    # global path regardless. The relaxation only replaces FFD plans it
    # strictly beats in exact micro-$, so the default is cost-monotone.
    window_backend: str = "global"
    # the directory the kernel libraries are built into and loaded from
    # ("" keeps the package's build/ directory): libraries are named by
    # their sources' digests, so a restart loads instead of rebuilding
    solver_compile_cache_dir: str = ""
    # capacity garbage collection (controllers/gc.py): sweep cadence and the
    # both-directions grace window; 0 interval disables the controller
    gc_interval_seconds: float = 120.0
    gc_grace_seconds: float = 600.0
    # brownout / pressure ladder (karpenter_tpu_torch/pressure/)
    pressure_enabled: bool = True
    pressure_max_depth: int = 100_000       # batcher hard depth bound
    pressure_rss_watermark_mb: int = 4096   # L3 RSS watermark; 0 disables
    pressure_dwell_seconds: float = 5.0     # hysteresis dwell per rung
    pressure_split_items: int = 4096        # L1+ max pods per solve chunk
    pressure_aging_seconds: float = 60.0    # one band promotion per step
    # observability (karpenter_tpu_torch/obs/): span tracer off by default;
    # disabled it is a no-op
    trace_enabled: bool = False
    # write a Chrome-trace-event dump here on shutdown ("" disables)
    trace_dump: str = ""
    # make every entered span a torch.profiler.record_function range, so a
    # torch.profiler session correlates kernels to window spans
    trace_annotations: bool = False
    # flight recorder dump directory ("" keeps the ring in memory only)
    flight_dir: str = ""
    # write-ahead intent journal directory (runtime/journal.py); "" disables
    # journaling AND startup recovery
    journal_dir: str = ""
    # fsync every journal append (crash-safe); disable only for benches
    # where the journal's durability is not under test
    journal_fsync: bool = True
    # per-pod SLO engine (obs/slo.py): mergeable latency digests per
    # (band × stage) + burn-rate sentinel; a no-op branch disabled
    slo_enabled: bool = True
    # objective overrides, "band=seconds[:target]" comma-separated — e.g.
    # "default=30,high=20:0.995"; "" keeps the built-in defaults
    # (system-critical 30s, high 45s, default 60s, all at 0.99)
    slo_objectives: str = ""
    # burn-rate windows and thresholds (multi-window multi-burn alerting:
    # burning iff fast-window burn >= fast AND slow-window burn >= slow)
    slo_fast_window_seconds: float = 60.0
    slo_slow_window_seconds: float = 1800.0
    slo_fast_burn: float = 6.0
    slo_slow_burn: float = 1.0
    # AWS provider (options.go:45-49)
    aws_node_name_convention: str = "ip-name"  # ip-name | resource-name
    aws_eni_limited_pod_density: bool = True

    def validate(self) -> List[str]:
        errs = []
        if not self.cluster_name:
            errs.append("cluster-name is required")
        if not self.cluster_endpoint:
            errs.append("cluster-endpoint is required")
        for name, port in (("metrics-port", self.metrics_port),
                           ("health-probe-port", self.health_probe_port),
                           ("webhook-port", self.webhook_port)):
            if not (0 < port < 65536):
                errs.append(f"{name} out of range: {port}")
        if self.kube_backend not in ("memory", "in-cluster"):
            errs.append(f"kube-backend invalid: {self.kube_backend}")
        if self.device not in ("cuda", "cpu"):
            errs.append(f"device invalid: {self.device} (available: cuda | cpu)")
        if self.gc_interval_seconds < 0 or self.gc_grace_seconds < 0:
            errs.append("gc-interval-seconds/gc-grace-seconds must be >= 0")
        if self.pressure_max_depth < 1:
            errs.append(
                f"pressure-max-depth must be >= 1: {self.pressure_max_depth}")
        if self.pressure_rss_watermark_mb < 0:
            errs.append("pressure-rss-watermark-mb must be >= 0")
        if self.pressure_dwell_seconds < 0:
            errs.append("pressure-dwell-seconds must be >= 0")
        if self.pressure_split_items < 1:
            errs.append(
                f"pressure-split-items must be >= 1: {self.pressure_split_items}")
        if self.pressure_aging_seconds < 0:
            errs.append("pressure-aging-seconds must be >= 0")
        if self.provisioning_shards < 0:
            errs.append("provisioning-shards must be >= 0 (0 = one worker "
                        f"per provisioner): {self.provisioning_shards}")
        if self.pipeline_depth < 1:
            errs.append(f"pipeline-depth must be >= 1: {self.pipeline_depth}")
        if self.pipeline_chunk_items < 0:
            errs.append("pipeline-chunk-items must be >= 0 (0 disables "
                        f"chunking): {self.pipeline_chunk_items}")
        if self.slo_fast_window_seconds <= 0 or self.slo_slow_window_seconds <= 0:
            errs.append("slo-fast/slow-window-seconds must be > 0")
        if self.slo_fast_burn <= 0 or self.slo_slow_burn <= 0:
            errs.append("slo-fast/slow-burn must be > 0")
        if self.slo_objectives:
            try:
                self.parse_slo_objectives()
            except ValueError as e:
                errs.append(f"slo-objectives invalid: {e}")
        from karpenter_tpu_torch.solver import policy as packing_policies

        if self.packing_policy not in packing_policies.available():
            errs.append(f"packing-policy invalid: {self.packing_policy} "
                        f"(available: {packing_policies.available()})")
        if self.policy_repack_cost < 0:
            errs.append(
                f"policy-repack-cost invalid: {self.policy_repack_cost}")
        if self.window_backend not in ("ffd", "global"):
            errs.append(f"window-backend invalid: {self.window_backend} "
                        "(available: ffd | global)")
        if self.aws_node_name_convention not in ("ip-name", "resource-name"):
            errs.append(
                f"aws-node-name-convention invalid: {self.aws_node_name_convention}")
        return errs

    def parse_slo_objectives(self) -> dict:
        """Parse ``slo_objectives`` ("band=seconds[:target]", comma-sep)
        into ``{band: (threshold_s, target)}``. Raises ValueError on a
        malformed entry (surfaced by validate())."""
        out = {}
        for entry in self.slo_objectives.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise ValueError(f"expected band=seconds[:target]: {entry!r}")
            band, _, rest = entry.partition("=")
            threshold, _, target = rest.partition(":")
            threshold_s = float(threshold)
            target_f = float(target) if target else 0.99
            if threshold_s <= 0:
                raise ValueError(f"threshold must be > 0: {entry!r}")
            if not (0.0 < target_f < 1.0):
                raise ValueError(f"target must be in (0, 1): {entry!r}")
            out[band.strip()] = (threshold_s, target_f)
        return out


def _env(name: str, default):
    v = os.environ.get(f"KARPENTER_{name.upper().replace('-', '_')}")
    if v is None:
        return default
    if isinstance(default, bool):
        return v.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(v)
    if isinstance(default, float):
        return float(v)
    return v


def parse(argv: Optional[List[str]] = None) -> Options:
    defaults = Options()
    p = argparse.ArgumentParser("karpenter-tpu")
    p.add_argument("--cluster-name", default=_env("cluster-name", defaults.cluster_name))
    p.add_argument("--cluster-endpoint",
                   default=_env("cluster-endpoint", defaults.cluster_endpoint))
    p.add_argument("--metrics-port", type=int,
                   default=_env("metrics-port", defaults.metrics_port))
    p.add_argument("--health-probe-port", type=int,
                   default=_env("health-probe-port", defaults.health_probe_port))
    p.add_argument("--webhook-port", type=int,
                   default=_env("webhook-port", defaults.webhook_port))
    p.add_argument("--kube-client-qps", type=int,
                   default=_env("kube-client-qps", defaults.kube_client_qps))
    p.add_argument("--kube-client-burst", type=int,
                   default=_env("kube-client-burst", defaults.kube_client_burst))
    p.add_argument("--cloud-provider",
                   default=_env("cloud-provider", defaults.cloud_provider))
    p.add_argument("--namespace",
                   default=_env("namespace", defaults.namespace))
    p.add_argument("--kube-backend", choices=["memory", "in-cluster"],
                   default=_env("kube-backend", defaults.kube_backend))
    p.add_argument("--leader-elect", action=argparse.BooleanOptionalAction,
                   default=_env("leader-elect", defaults.leader_elect))
    p.add_argument("--batch-idle-seconds", type=float,
                   default=_env("batch-idle-seconds", defaults.batch_idle_seconds))
    p.add_argument("--batch-max-seconds", type=float,
                   default=_env("batch-max-seconds", defaults.batch_max_seconds))
    p.add_argument("--batch-max-items", type=int,
                   default=_env("batch-max-items", defaults.batch_max_items))
    p.add_argument("--provisioning-shards", type=int,
                   default=_env("provisioning-shards",
                                defaults.provisioning_shards),
                   help="horizontal control-plane shards: N long-lived "
                        "intake/provisioning workers keyed by provisioner "
                        "hash (0 = one worker per Provisioner CR)")
    p.add_argument("--device", choices=["cuda", "cpu"],
                   default=_env("device", defaults.device),
                   help="where the solver and its kernels run: cuda (the "
                        "mesh of every visible card) or cpu (the plain "
                        "PyTorch versions)")
    p.add_argument("--pipeline-depth", type=int,
                   default=_env("pipeline-depth", defaults.pipeline_depth),
                   help="provisioning pipeline depth: solve chunks in "
                        "flight (1=serial; collapses to 1 at pressure L1+)")
    p.add_argument("--pipeline-chunk-items", type=int,
                   default=_env("pipeline-chunk-items",
                                defaults.pipeline_chunk_items),
                   help="max pods per pipelined solve chunk at L0 "
                        "(0 disables chunking)")
    p.add_argument("--pipeline-adaptive",
                   action=argparse.BooleanOptionalAction,
                   default=_env("pipeline-adaptive",
                                defaults.pipeline_adaptive),
                   help="adapt pipeline depth 1-3 to measured overlap "
                        "(pipeline-depth is the starting point)")
    p.add_argument("--solver-donate", action=argparse.BooleanOptionalAction,
                   default=_env("solver-donate", defaults.solver_donate),
                   help="device buffer ring + donation: steady-state solve "
                        "chunks reuse device memory in place")
    p.add_argument("--solver-warmup", action=argparse.BooleanOptionalAction,
                   default=_env("solver-warmup", defaults.solver_warmup),
                   help="build the kernel libraries and launch each solver "
                        "bucket once at boot, before any controller starts "
                        "(solver/warmup.py); a failure fails the boot")
    p.add_argument("--packing-policy",
                   default=_env("packing-policy", defaults.packing_policy),
                   help="packing-policy scoring (solver/policy.py): "
                        "cheapest (default, preserves cheapest-feasible "
                        "exactly) | interruption-priced (spot taxed by "
                        "reclaim-rate x what-if repack cost) | "
                        "throughput-per-dollar (heterogeneous accelerator "
                        "catalogs)")
    p.add_argument("--policy-repack-cost", type=float,
                   default=_env("policy-repack-cost",
                                defaults.policy_repack_cost),
                   help="pin the interruption-priced policy's repack price "
                        "($/h); 0 lets the what-if engine price each chunk")
    p.add_argument("--window-backend", choices=["ffd", "global"],
                   default=_env("window-backend", defaults.window_backend),
                   help="provisioning-window packing backend: global "
                        "(whole-window ADMM relaxation with FFD as the "
                        "exact rounding oracle and bit-for-bit fallback; "
                        "the default — L1+ pressure and gang schedules "
                        "keep ffd) | ffd (per-schedule greedy batch, the "
                        "pre-v18 default)")
    p.add_argument("--solver-compile-cache-dir",
                   default=_env("solver-compile-cache-dir",
                                defaults.solver_compile_cache_dir),
                   help="directory the kernel libraries are built into "
                        "and loaded from (empty keeps the package's build/)")
    p.add_argument("--gc-interval-seconds", type=float,
                   default=_env("gc-interval-seconds", defaults.gc_interval_seconds))
    p.add_argument("--gc-grace-seconds", type=float,
                   default=_env("gc-grace-seconds", defaults.gc_grace_seconds))
    p.add_argument("--pressure-enabled", action=argparse.BooleanOptionalAction,
                   default=_env("pressure-enabled", defaults.pressure_enabled),
                   help="brownout ladder: pressure-aware admission/shedding")
    p.add_argument("--pressure-max-depth", type=int,
                   default=_env("pressure-max-depth",
                                defaults.pressure_max_depth),
                   help="hard bound on pods awaiting a batch window")
    p.add_argument("--pressure-rss-watermark-mb", type=int,
                   default=_env("pressure-rss-watermark-mb",
                                defaults.pressure_rss_watermark_mb),
                   help="process RSS watermark (MiB) for L2/L3; 0 disables")
    p.add_argument("--pressure-dwell-seconds", type=float,
                   default=_env("pressure-dwell-seconds",
                                defaults.pressure_dwell_seconds),
                   help="seconds below a rung before the ladder steps down")
    p.add_argument("--pressure-split-items", type=int,
                   default=_env("pressure-split-items",
                                defaults.pressure_split_items),
                   help="max pods per solve chunk when splitting at L1+")
    p.add_argument("--pressure-aging-seconds", type=float,
                   default=_env("pressure-aging-seconds",
                                defaults.pressure_aging_seconds),
                   help="queued/shed pods gain one priority band per step")
    p.add_argument("--trace-enabled", action=argparse.BooleanOptionalAction,
                   default=_env("trace-enabled", defaults.trace_enabled),
                   help="span tracer (obs/trace.py): per-window spans with "
                        "stage children; disabled mode is a no-op")
    p.add_argument("--trace-dump",
                   default=_env("trace-dump", defaults.trace_dump),
                   help="write a Chrome-trace-event JSON dump here on "
                        "shutdown (empty disables)")
    p.add_argument("--trace-annotations", action=argparse.BooleanOptionalAction,
                   default=_env("trace-annotations", defaults.trace_annotations),
                   help="make every entered span a torch.profiler "
                        "record_function range")
    p.add_argument("--flight-dir",
                   default=_env("flight-dir", defaults.flight_dir),
                   help="flight recorder dump directory for pressure-L3/"
                        "slo-burn/chaos/recovery trips (empty = in-memory "
                        "ring only)")
    p.add_argument("--journal-dir",
                   default=_env("journal-dir", defaults.journal_dir),
                   help="write-ahead intent journal directory; every multi-"
                        "step mutation (launch/bind/gang/drain/delete) is "
                        "journaled there and replayed by startup recovery "
                        "(empty disables journaling and recovery)")
    p.add_argument("--journal-fsync", action=argparse.BooleanOptionalAction,
                   default=_env("journal-fsync", defaults.journal_fsync),
                   help="fsync every journal append (crash durability); "
                        "--no-journal-fsync trades that for speed in "
                        "benches")
    p.add_argument("--slo-enabled", action=argparse.BooleanOptionalAction,
                   default=_env("slo-enabled", defaults.slo_enabled),
                   help="per-pod SLO engine (obs/slo.py): latency digests "
                        "per band/stage + burn-rate sentinel")
    p.add_argument("--slo-objectives",
                   default=_env("slo-objectives", defaults.slo_objectives),
                   help="objective overrides, band=seconds[:target] comma-"
                        "separated (empty keeps built-in defaults)")
    p.add_argument("--slo-fast-window-seconds", type=float,
                   default=_env("slo-fast-window-seconds",
                                defaults.slo_fast_window_seconds),
                   help="fast burn-rate window")
    p.add_argument("--slo-slow-window-seconds", type=float,
                   default=_env("slo-slow-window-seconds",
                                defaults.slo_slow_window_seconds),
                   help="slow burn-rate window")
    p.add_argument("--slo-fast-burn", type=float,
                   default=_env("slo-fast-burn", defaults.slo_fast_burn),
                   help="fast-window burn-rate trip threshold")
    p.add_argument("--slo-slow-burn", type=float,
                   default=_env("slo-slow-burn", defaults.slo_slow_burn),
                   help="slow-window burn-rate trip threshold")
    p.add_argument("--aws-node-name-convention",
                   choices=["ip-name", "resource-name"],
                   default=_env("aws-node-name-convention",
                                defaults.aws_node_name_convention))
    p.add_argument("--aws-eni-limited-pod-density",
                   action=argparse.BooleanOptionalAction,
                   default=_env("aws-eni-limited-pod-density",
                                defaults.aws_eni_limited_pod_density))
    ns = p.parse_args(_bool_values(p, sys.argv[1:] if argv is None else argv))
    return Options(**{k.replace("-", "_"): v for k, v in vars(ns).items()})


_TRUE, _FALSE = ("1", "true", "yes"), ("0", "false", "no")


def _bool_values(p: argparse.ArgumentParser, argv: List[str]) -> List[str]:
    """``--flag=true`` / ``--flag=false`` of a boolean flag as ``--flag`` /
    ``--no-flag``: the value form that Go's flag package takes and that a
    chart writes from a value (``--leader-elect={{ .Values.leaderElect }}``);
    argparse's boolean flags take no value. The words are the environment
    fallback's (``_env``); any other value is an error."""
    flags = {s for a in p._actions if isinstance(a, argparse.BooleanOptionalAction)
             for s in a.option_strings if not s.startswith("--no-")}
    out = []
    for token in argv:
        name, eq, value = token.partition("=")
        if eq and name in flags:
            if value.lower() in _TRUE:
                token = name
            elif value.lower() in _FALSE:
                token = "--no-" + name[2:]
            else:
                p.error(f"argument {name}: expected true or false, got {value!r}")
        out.append(token)
    return out
