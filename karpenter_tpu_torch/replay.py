"""Cluster-in-a-box traffic replay: the sharded control plane under a
synthetic multi-tenant diurnal workload.

The harness drives the port's real stack — KubeCore (striped store)
wrapped in ChaosKube, ProvisioningController with N shard workers on one
device, the selection path, the pressure ladder — with three traffic
streams derived from one seed:

- a **flood**: low/besteffort-band pods offered straight at the shard
  intakes, shaped by a diurnal sine over ``ticks`` buckets with seeded
  burst ticks. The flood is the overload: most of it is *meant* to be
  shed at L2+, and the point is what admission does per band.
- a **bound cohort**: real multi-tenant pods (system-critical / high /
  default bands, zone-routed to their tenant Provisioner) that travel
  the full create → watch → selection → batch → solve → launch → bind
  path; their per-band pending→bound latency is the SLO headline.
- **churn**: short-lived pods created and deleted a tick later,
  exercising store delete + watch fan-out while the flood runs.

The run returns one SLO report dict (see :func:`run_replay`), gated by
:mod:`karpenter_tpu_torch.replay_verdict`. On a single-core host the win
is algorithmic — per-shard admission isolation and the by-kind store
index — not parallel speedup; the report records ``nproc`` honestly.

:func:`store_ab` is the paired micro-benchmark: list-by-kind throughput
of the striped+indexed store vs the single-dict full-scan
:class:`~karpenter_tpu_torch.runtime.kubecore.NaiveKubeCore` at 100k
objects.

    python -m karpenter_tpu_torch.replay --device cpu --pods-total 10000 \\
        --shards 2 | python -m karpenter_tpu_torch.replay_verdict
"""

from __future__ import annotations

import functools
import math
import os
import queue
import random
import time
import uuid
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from karpenter_tpu_torch import pressure
from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import (
    Container, Node, NodeSelectorRequirement as Req, ObjectMeta, Pod, PodCondition,
    PodSpec, PodStatus, ResourceRequirements,
)
from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.backend import DeviceLike
from karpenter_tpu_torch.chaos import inject
from karpenter_tpu_torch.cloudprovider.fake.provider import FakeCloudProvider
from karpenter_tpu_torch.cloudprovider.metrics import decorate
from karpenter_tpu_torch.cloudprovider.spi import Offering, make_instance_type
from karpenter_tpu_torch.controllers.gc import GarbageCollection
from karpenter_tpu_torch.controllers.node import NodeController
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.selection import SelectionController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.obs import slo as obslo
from karpenter_tpu_torch.pressure.monitor import read_rss_bytes
from karpenter_tpu_torch.runtime.journal import IntentJournal
from karpenter_tpu_torch.runtime.kubecore import ApiError, KubeCore, NaiveKubeCore, NotFound
from karpenter_tpu_torch.runtime.manager import Manager
from karpenter_tpu_torch.scheduling.batcher import Batcher

# the same seeded fault kinds as the overload soak, plus delete-path
# stalls for the churn stream
REPLAY_SPECS = [
    inject.FaultSpec("pressure", "depth", "queue-flood", 2),
    inject.FaultSpec("pressure", "rss", "memory-pressure", 2),
    inject.FaultSpec("kube", "create", "slow-apiserver", 2),
    inject.FaultSpec("kube", "delete", "slow-apiserver", 1),
]

COHORT_BANDS = ("system-critical", "high", "default")
FLOOD_BANDS = ("low", "besteffort")

# the pressure ladder's real-memory rung: 1 GiB of RSS growth over the
# run. The port's monitor reads growth since it was made (importing torch
# alone is ~4.4 GiB on a card's host), so this is the JAX replay's
# ``start_rss + 1 GiB`` of absolute RSS, as headroom
RSS_HEADROOM_BYTES = 1024 ** 3


@dataclass
class ReplayConfig:
    """One replay run. Defaults are the million-pod bench shape
    (``make bench-replay``); the smoke test scales every knob down."""

    pods_total: int = 1_000_000   # offered pods: flood + cohort + churn
    shards: int = 4               # provisioning shard workers (>= 1)
    tenants: int = 8              # Provisioner CRs, one zone each
    seed: int = 42
    bound_cohort: int = 2_000     # pods driven through the full bind path
    critical_fraction: float = 0.02   # of the cohort: system-critical band
    high_fraction: float = 0.18       # of the cohort: high band
    churn_pods: int = 2_000       # created then deleted a tick later
    max_depth: int = 20_000       # per-shard batcher depth bound
    ticks: int = 24               # diurnal buckets ("hours")
    tick_sleep_s: float = 0.2     # real time per tick (ladder hysteresis)
    burst_ticks: int = 3          # seeded ticks with 3x flood weight
    chaos: bool = True            # FaultPlan + ChaosKube wrapper
    settle_s: float = 180.0       # post-flood budget: binds + L0 recovery
    flood_pool: int = 512         # distinct flood pod objects (cycled)
    gang_fraction: float = 0.0    # of the cohort: all-or-nothing pod groups
    gang_size: int = 4            # members per injected gang
    # slice shape stamped on every gang member (karpenter.sh/pod-group-
    # slice). Non-empty → the catalog additionally offers a TPU host type
    # per tenant zone and the gangs route through the topology-carve
    # planner, journaling one durable carve intent per committed slice —
    # the carve-journal-tax bench leg (config_17) measures exactly that
    # against this run's paced wall
    gang_slice: str = ""
    # fraction of the default-band cohort pinned to spot capacity
    # (node_selector capacity-type=spot). spot_fraction > 0 also registers
    # the termination + capacity-GC controllers and (chaos on) arms seeded
    # ``spot-interruption`` faults: reclaimed instances leave ghost Nodes,
    # their pods are evicted, and the harness re-offers them like a
    # ReplicaSet would — ``completed`` then asserts every one REBOUND
    spot_fraction: float = 0.0
    # burn-sentinel objective overrides for this run, band -> threshold_s
    # (None keeps whatever obs/slo.py has configured); the bench's seeded-
    # chaos probe leg uses a deliberately impossible objective to prove
    # the sentinel trips under fault injection
    slo_objectives: Optional[Dict[str, float]] = None
    # ALSO keep exact per-pod latency lists alongside the digests and
    # report digest-vs-exact quantile parity (smoke runs only — at the
    # million-pod shape the whole point is NOT materializing the lists)
    slo_exact_check: bool = False
    # write-ahead intent journal directory ("" = journaling off, the
    # historical behavior). The bench uses a journaled leg vs a bare leg
    # to price the bind-path journal overhead (acceptance: <= 1%); the
    # journal's stats land in the report under ``journal``.
    journal_dir: str = ""
    journal_fsync: bool = True

    def validate(self) -> None:
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1: {self.shards}")
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1: {self.tenants}")
        if not 0.0 <= self.gang_fraction <= 1.0:
            raise ValueError(
                f"gang_fraction must be in [0, 1]: {self.gang_fraction}")
        if not 0.0 <= self.spot_fraction <= 1.0:
            raise ValueError(
                f"spot_fraction must be in [0, 1]: {self.spot_fraction}")
        if self.gang_size < 1:
            raise ValueError(f"gang_size must be >= 1: {self.gang_size}")
        overhead = self.bound_cohort + self.churn_pods
        if self.pods_total < overhead:
            raise ValueError(
                f"pods_total {self.pods_total} < cohort+churn {overhead}")


def tenant_catalog(tenants: int, types_per_zone: int = 6) -> list:
    """Instance types offering every tenant zone (replay-zone-1..T), so
    each tenant Provisioner's zone requirement keeps a non-empty catalog
    after the controller injects the universe requirements."""
    zones = [f"replay-zone-{i + 1}" for i in range(tenants)]
    offerings = [Offering(ct, z) for z in zones for ct in ("on-demand", "spot")]
    cpus = [4, 8, 16, 32, 48, 64]
    return [
        make_instance_type(
            name=f"replay-{cpus[i % len(cpus)]}c-{i}",
            cpu=str(cpus[i % len(cpus)]),
            memory=f"{cpus[i % len(cpus)] * 4}Gi",
            pods=str(min(110, cpus[i % len(cpus)] * 8)),
            offerings=offerings,
            price=0.04 * cpus[i % len(cpus)])
        for i in range(types_per_zone)
    ]


def tpu_tenant_types(tenants: int, topology: str) -> list:
    """One multi-host TPU type whose torus can carve ``topology``-shaped
    slices, offered in every tenant zone — the capacity the gang_slice
    cohort lands on. The v5e-4x4 host carves four 2x2 slices, so slice
    gangs pack 4-to-a-node and the carve ledger sees real sharing."""
    zones = [f"replay-zone-{i + 1}" for i in range(tenants)]
    offerings = [Offering(ct, z) for z in zones
                 for ct in ("on-demand", "spot")]
    family = topology.split("-", 1)[0] if "-" in topology else "v5e"
    host = f"{family}-4x4"
    return [make_instance_type(
        name=f"replay-tpu-{host}", cpu="32", memory="64Gi", pods="32",
        offerings=offerings, price=4.0, tpu_topology=host)]


def tenant_zone(tenant: int) -> str:
    return f"replay-zone-{tenant + 1}"


def tenant_provisioner(tenant: int) -> Provisioner:
    """Tenant CR: requires its own zone, so the selection first-match
    routes exactly its zone's pods to it (the universe injection
    intersects per key and cannot widen this back out)."""
    return Provisioner(
        metadata=ObjectMeta(name=f"tenant-{tenant}", namespace="default"),
        spec=ProvisionerSpec(constraints=Constraints(
            requirements=Requirements().add(Req(
                key=wellknown.LABEL_TOPOLOGY_ZONE, operator="In",
                values=[tenant_zone(tenant)])))))


def _pending_pod(name: str, zone: Optional[str] = None,
                 requests: Optional[Dict[str, str]] = None,
                 priority: int = 0,
                 priority_class_name: str = "") -> Pod:
    """A Pending+Unschedulable pod (the selection controller's trigger
    shape — pkg/test/pods.go:84-96), built without the tests package so
    the replay harness ships with the library."""
    containers = []
    if requests is not None:
        containers = [Container(resources=ResourceRequirements.make(
            requests=requests))]
    return Pod(
        metadata=ObjectMeta(name=name, namespace="default",
                            uid=uuid.uuid4().hex),
        spec=PodSpec(
            node_selector=(
                {wellknown.LABEL_TOPOLOGY_ZONE: zone} if zone else {}),
            containers=containers,
            priority=priority,
            priority_class_name=priority_class_name),
        status=PodStatus(phase="Pending", conditions=[
            PodCondition(type="PodScheduled", status="False",
                         reason="Unschedulable")]))


def diurnal_weights(ticks: int, burst_ticks: int,
                    rng: random.Random) -> List[float]:
    """Sine-of-day shape (trough ~1/3 of peak) with seeded burst ticks at
    3x their diurnal weight — the flood schedule, normalized by caller."""
    weights = [1.5 + math.sin(2.0 * math.pi * t / ticks) for t in range(ticks)]
    for t in rng.sample(range(ticks), min(burst_ticks, ticks)):
        weights[t] *= 3.0
    return weights


def _quantiles(values: List[float]) -> Optional[Dict[str, float]]:
    if not values:
        return None
    vs = sorted(values)

    def q(frac):
        return vs[min(len(vs) - 1, int(len(vs) * frac))]

    return {"p50": round(q(0.50), 4), "p99": round(q(0.99), 4),
            "max": round(vs[-1], 4), "n": len(vs)}


class _StoreSampler:
    """Per-tick store op latency probes against the live (chaos-free)
    store: a no-copy point read, a no-copy by-kind scan, and a deep-copy
    list of a minority kind. Reported in microseconds."""

    def __init__(self, core: KubeCore):
        self.core = core
        self.samples: Dict[str, List[float]] = {
            "read_pod": [], "scan_node": [], "list_provisioner": []}

    def sample(self, pod_name: Optional[str]) -> None:
        if pod_name is not None:
            t0 = time.perf_counter()
            try:
                self.core.read("Pod", pod_name, "default",
                               lambda p: p.spec.node_name)
            except NotFound:
                pass
            self.samples["read_pod"].append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        self.core.scan("Node", lambda n: n.metadata.name)
        self.samples["scan_node"].append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        self.core.list("Provisioner")
        self.samples["list_provisioner"].append(
            (time.perf_counter() - t0) * 1e6)

    def report(self) -> Dict[str, Optional[Dict[str, float]]]:
        return {f"{op}_us": _quantiles(vals)
                for op, vals in self.samples.items()}


def run_replay(cfg: ReplayConfig, device: DeviceLike = None) -> dict:
    """Run one replay on ``device`` (default: the CUDA device; ``"cpu"``
    runs the plain versions); returns the SLO report dict.

    The report's gates (checked by :mod:`karpenter_tpu_torch.replay_verdict`):

    - ``completed`` — every offered pod was accounted for and every
      surviving cohort pod bound within the settle budget;
    - ``shed.system-critical == 0`` — the ladder's hard invariant held
      across the whole replay;
    - ``recovery_to_l0_s`` — the ladder released after the flood (None
      means it never did);
    - per-band ``pending_to_bound_s`` p50/p99 for the cohort bands.
    """
    cfg.validate()
    rng = random.Random(cfg.seed)
    # fresh SLO ledger per run: digests, burn rings, and trip counters all
    # start from zero so the report's clean-leg/chaos-leg gates are about
    # THIS run (the objective map is restored in the finally block)
    obslo.reset()
    if cfg.slo_objectives is not None:
        obslo.configure(objectives={
            band: obslo.Objective(threshold_s=t)
            for band, t in cfg.slo_objectives.items()})
    t_run0 = time.perf_counter()
    start_rss = read_rss_bytes()
    monitor = pressure.configure(pressure.PressureConfig(
        max_depth=cfg.max_depth,
        rss_watermark_bytes=RSS_HEADROOM_BYTES,
        dwell_seconds=0.4,
        aging_step_seconds=1.0,
        window_l1_seconds=2.0))
    core = KubeCore()
    kube = inject.ChaosKube(core) if cfg.chaos else core
    catalog = tenant_catalog(cfg.tenants)
    if cfg.gang_slice:
        catalog += tpu_tenant_types(cfg.tenants, cfg.gang_slice)
    fake = FakeCloudProvider(catalog=catalog)
    provider = decorate(fake)
    journal = None
    if cfg.journal_dir:
        journal = IntentJournal(cfg.journal_dir, fsync=cfg.journal_fsync)
    provisioning = ProvisioningController(
        kube, provider,
        journal=journal,
        batcher_factory=functools.partial(
            Batcher, idle_seconds=0.05, max_seconds=0.5,
            max_depth=cfg.max_depth),
        shards=cfg.shards,
        device=device)
    manager = Manager(kube)
    manager.register(provisioning, workers=2)
    manager.register(SelectionController(kube, provisioning), workers=16)
    manager.register(NodeController(kube), workers=4)
    if cfg.spot_fraction > 0.0:
        # spot runs need the full reclaim loop: termination drains the
        # ghost Node, GC reaps it (soak-scale grace)
        manager.register(TerminationController(kube, provider), workers=4)
        manager.register(GarbageCollection(kube, provider,
                                           interval_seconds=0.5,
                                           grace_seconds=2.0))
    for t in range(cfg.tenants):
        core.create(tenant_provisioner(t))  # setup bypasses injection

    plan = None
    if cfg.chaos:
        plan = inject.FaultPlan(cfg.seed, REPLAY_SPECS, window=64)
        inject.install(plan)
    # spot interruptions ride their own seeded stream, drawn once per tick
    # by the harness itself (ticks 1..T-1, window = draw count, so every
    # planned interruption is guaranteed to land mid-run — after the spot
    # cohort had a tick to bind, before the settle phase)
    reclaim_plan = None
    if cfg.chaos and cfg.spot_fraction > 0.0 and cfg.ticks > 1:
        reclaim_plan = inject.FaultPlan(cfg.seed, [
            inject.FaultSpec("provider", "reclaim", "spot-interruption",
                             max(1, min(2, cfg.ticks - 1)))],
            window=cfg.ticks - 1)
    manager.start()

    offered: Dict[str, int] = {b: 0 for b in COHORT_BANDS + FLOOD_BANDS}
    created_at: Dict[str, float] = {}
    band_of: Dict[str, str] = {}
    bound_at: Dict[str, float] = {}
    # per-band pending→bound latency folds into fixed-memory mergeable
    # digests AT BIND TIME — the exact per-pod latency lists never
    # materialize (O(bands × digest) at any pod count)
    lat_digest: Dict[str, obslo.Digest] = {b: obslo.Digest()
                                           for b in COHORT_BANDS}
    exact_lat: Optional[Dict[str, List[float]]] = (
        {b: [] for b in COHORT_BANDS} if cfg.slo_exact_check else None)
    peak_level = 0
    peak_rss = start_rss
    churn_deleted = 0
    sampler = _StoreSampler(core)
    watch_q = core.watch("Pod", meta_only=True)
    # spot bookkeeping: construction shapes for ReplicaSet-style re-offers,
    # the ids an interruption reclaimed, and the displaced/rebound ledger
    cohort_shape: Dict[str, dict] = {}
    reclaimed_ids: List[str] = []
    displaced: set = set()
    spot_offered = 0

    def _shaped_pod(name: str) -> Pod:
        sh = cohort_shape[name]
        pod = _pending_pod(name, zone=sh["zone"], requests=sh["requests"],
                           priority=sh["priority"],
                           priority_class_name=sh["priority_class_name"])
        if sh["spot"]:
            pod.spec.node_selector[wellknown.LABEL_CAPACITY_TYPE] = \
                wellknown.CAPACITY_TYPE_SPOT
        return pod

    def _reoffer(name: str) -> None:
        """A reclaim evicted this bound cohort pod; recreate it with the
        same shape (what its ReplicaSet would do) and restart its
        pending→bound clock — ``completed`` then requires the rebind."""
        displaced.add(name)
        bound_at.pop(name, None)
        created_at[name] = time.perf_counter()
        try:
            kube.create(_shaped_pod(name))
        except ApiError:
            pass  # injected fault: _retry_displaced picks it up

    def _retry_displaced() -> None:
        """Settle-loop sweep: a displaced pod whose re-offer died on an
        injected apiserver fault is offered again until it exists."""
        for name in displaced:
            if name in bound_at:
                continue
            try:
                core.read("Pod", name, "default", lambda p: None)
            except NotFound:
                try:
                    kube.create(_shaped_pod(name))
                    created_at[name] = time.perf_counter()
                except ApiError:
                    pass

    def _observe():
        nonlocal peak_level, peak_rss
        peak_level = max(peak_level, int(monitor.level()))
        peak_rss = max(peak_rss, read_rss_bytes())

    def _drain_watch():
        """Event-driven bind timestamps (no polling scans): a MODIFIED on a
        cohort pod is its bind iff the no-copy read sees a node_name."""
        while True:
            try:
                event = watch_q.get_nowait()
            except queue.Empty:
                return
            name = event.obj.metadata.name
            if (event.type == "DELETED" and name in bound_at
                    and name in cohort_shape):
                # eviction off a reclaimed spot node — the only path that
                # deletes a BOUND cohort pod (churn/gang withdrawals are
                # never in bound_at + cohort_shape)
                _reoffer(name)
            elif (event.type == "MODIFIED" and name in created_at
                    and name not in bound_at):
                try:
                    if core.read("Pod", name, "default",
                                 lambda p: bool(p.spec.node_name)):
                        now = time.perf_counter()
                        bound_at[name] = now
                        band = band_of.get(name)
                        if band in lat_digest:
                            lat_s = now - created_at[name]
                            lat_digest[band].record(lat_s)
                            if exact_lat is not None:
                                exact_lat[band].append(lat_s)
                except NotFound:
                    pass

    try:
        # wait for every tenant engine to attach to its shard worker
        deadline = time.monotonic() + 30.0
        while len(provisioning.targets()) < cfg.tenants:
            if time.monotonic() > deadline:
                raise RuntimeError("tenant engines never attached to shards")
            time.sleep(0.05)
        routes = provisioning.targets()  # [(Provisioner, worker)] snapshot

        # ---- bound cohort: full path, zone-routed to its tenant --------
        n_crit = max(1, int(cfg.bound_cohort * cfg.critical_fraction))
        n_high = int(cfg.bound_cohort * cfg.high_fraction)
        for i in range(cfg.bound_cohort):
            if i < n_crit:
                band, prio, pcn = "system-critical", 0, "system-cluster-critical"
            elif i < n_crit + n_high:
                band, prio, pcn = "high", 100, ""
            else:
                band, prio, pcn = "default", 0, ""
            requests = {"cpu": f"{rng.choice([100, 250, 500])}m",
                        "memory": f"{rng.choice([128, 512])}Mi"}
            # deterministic spot striping over the default band (no rng
            # draw, so spot_fraction=0 runs keep their exact rng stream)
            spot = (band == "default" and cfg.spot_fraction > 0.0
                    and (i % 10) < round(cfg.spot_fraction * 10))
            pod = _pending_pod(
                f"cohort-{band}-{i}", zone=tenant_zone(i % cfg.tenants),
                requests=requests, priority=prio, priority_class_name=pcn)
            if spot:
                pod.spec.node_selector[wellknown.LABEL_CAPACITY_TYPE] = \
                    wellknown.CAPACITY_TYPE_SPOT
            try:
                kube.create(pod)
            except ApiError:
                try:  # injected apiserver fault: one retry, else skip
                    kube.create(pod)
                except ApiError:
                    continue
            offered[band] += 1
            spot_offered += spot
            created_at[pod.metadata.name] = time.perf_counter()
            band_of[pod.metadata.name] = band
            cohort_shape[pod.metadata.name] = {
                "zone": tenant_zone(i % cfg.tenants), "requests": requests,
                "priority": prio, "priority_class_name": pcn, "spot": spot}

        # ---- gang cohort: all-or-nothing pod groups (gang_fraction) ----
        # seeded gang workloads ride the same full path as the cohort;
        # the SLO report asserts ZERO partial gangs — a gang either binds
        # whole or stays wholly Pending
        gang_members: Dict[str, List[str]] = {}
        n_gangs = int(cfg.bound_cohort * cfg.gang_fraction) // cfg.gang_size
        for gi in range(n_gangs):
            gname = f"replay-gang-{gi}"
            zone = tenant_zone(gi % cfg.tenants)
            members: List[str] = []
            ok = True
            for m in range(cfg.gang_size):
                pod = _pending_pod(
                    f"{gname}-m{m}", zone=zone,
                    requests={"cpu": f"{rng.choice([250, 500])}m",
                              "memory": "256Mi"})
                pod.metadata.labels[wellknown.POD_GROUP_LABEL] = gname
                pod.metadata.labels[wellknown.POD_GROUP_SIZE_LABEL] = \
                    str(cfg.gang_size)
                if cfg.gang_slice:
                    pod.metadata.labels[
                        wellknown.POD_GROUP_SLICE_LABEL] = cfg.gang_slice
                try:
                    kube.create(pod)
                except ApiError:
                    try:  # injected apiserver fault: one retry
                        kube.create(pod)
                    except ApiError:
                        ok = False
                        break
                members.append(pod.metadata.name)
            if not ok:
                # a member never reached the apiserver: the gang can never
                # complete, so withdraw the partial group entirely rather
                # than leave a forever-partial gang in the run
                for name in members:
                    try:
                        kube.delete("Pod", name, "default")
                    except ApiError:
                        pass
                continue
            for name in members:
                offered["default"] += 1
                created_at[name] = time.perf_counter()
                band_of[name] = "default"
            gang_members[gname] = members

        # ---- flood + churn, shaped by the diurnal schedule -------------
        flood_total = cfg.pods_total - sum(offered.values()) - cfg.churn_pods
        weights = diurnal_weights(cfg.ticks, cfg.burst_ticks, rng)
        wsum = sum(weights)
        # a cycled pool of flood pods: admission cost is per-ADD, and the
        # batcher never retains shed items, so object identity reuse keeps
        # the 1M-offer loop allocation-free without changing what the
        # admission path sees
        pool = []
        for j in range(cfg.flood_pool):
            if j % 10 < 7:  # 70% besteffort (no requests), 30% low
                pool.append(("besteffort",
                             _pending_pod(f"flood-be-{j}", priority=0)))
            else:
                pool.append(("low", _pending_pod(
                    f"flood-low-{j}", requests={"cpu": "100m"},
                    priority=-10)))
        churn_per_tick = cfg.churn_pods // cfg.ticks
        pending_churn: List[str] = []
        sent = 0
        pod_i = 0
        for tick in range(cfg.ticks):
            quota = (int(flood_total * weights[tick] / wsum)
                     if tick < cfg.ticks - 1 else flood_total - sent)
            # flood offers round-robin across tenants → their shard
            # worker's intake; shed-vs-admit is the shard batcher's call
            for _ in range(quota):
                band, pod = pool[pod_i % cfg.flood_pool]
                prov, worker = routes[pod_i % len(routes)]
                worker.add(pod, provisioner=prov.metadata.name)
                offered[band] += 1
                pod_i += 1
            sent += quota
            # churn: delete last tick's short-lived pods, create this
            # tick's (they ride the real apiserver path; a deleted pod
            # that reached a window is dropped as non-provisionable)
            for name in pending_churn:
                try:
                    kube.delete("Pod", name, "default")
                    churn_deleted += 1
                except ApiError:
                    pass  # injected fault or already reaped
            pending_churn = []
            for j in range(churn_per_tick):
                name = f"churn-{tick}-{j}"
                try:
                    kube.create(_pending_pod(
                        name, zone=tenant_zone(j % cfg.tenants),
                        requests={"cpu": "100m"}))
                    offered["default"] += 1
                    pending_churn.append(name)
                except ApiError:
                    pass
            _observe()
            _drain_watch()
            sampler.sample(next(iter(created_at), None))
            time.sleep(cfg.tick_sleep_s)
            # one interruption draw per tick (tick 0 skipped: the spot
            # cohort needs a tick to land before anything is reclaimable)
            if (reclaim_plan is not None and tick >= 1
                    and reclaim_plan.decide("provider", "reclaim")
                    == "spot-interruption"):
                reclaimed_ids.extend(fake.reclaim_spot(1))
        for name in pending_churn:  # trailing churn tick
            try:
                kube.delete("Pod", name, "default")
                churn_deleted += 1
            except ApiError:
                pass
        flood_end = time.monotonic()

        # ---- settle: cohort binds land, ladder releases to L0 ----------
        recovery_at = None
        deadline = time.monotonic() + cfg.settle_s
        unbound = [n for n in created_at if n not in bound_at]
        while time.monotonic() < deadline:
            _observe()
            _drain_watch()
            _retry_displaced()
            level = int(monitor.level())
            if recovery_at is None and level == 0:
                recovery_at = time.monotonic()
            unbound = [n for n in created_at if n not in bound_at]
            if not unbound and level == 0:
                break
            time.sleep(0.1)
        _drain_watch()
        sampler.sample(next(iter(created_at), None))

        # ---- the SLO report --------------------------------------------
        shed: Dict[str, int] = {}
        for worker in provisioning.workers.values():
            for (_, band), n in dict(worker.batcher.shed).items():
                shed[band] = shed.get(band, 0) + n
        latency = {
            band: (lat_digest[band].report()
                   if lat_digest[band].n else None)
            for band in COHORT_BANDS
        }
        digest_parity = None
        if exact_lat is not None:
            # smoke-run oracle: the digest quantiles must sit within the
            # configured relative-error bound of the exact sorted lists
            digest_parity = {"within_1pct": True}
            for band in COHORT_BANDS:
                ex = _quantiles(exact_lat[band])
                if ex is None:
                    continue
                dg = lat_digest[band].report()
                errs = {
                    q: abs(dg[q] - ex[q]) / max(ex[q], 1e-9)
                    for q in ("p50", "p99")}
                digest_parity[band] = {f"{q}_rel_err": round(e, 5)
                                       for q, e in errs.items()}
                if max(errs.values()) > 0.01:
                    digest_parity["within_1pct"] = False
        # the SLO engine's bounded-growth claim, asserted at every scale:
        # cells ≤ bands × stages and bins ≤ cells × max_bins, regardless
        # of how many pods were offered
        if obslo.enabled():
            obslo.evaluate()
        eng = obslo.engine()
        slo_section = {
            "records": eng.records_total(),
            "cells": eng.cell_count(),
            "total_bins": eng.total_bins(),
            "bounded": (
                eng.cell_count()
                <= len(COHORT_BANDS + FLOOD_BANDS) * len(obslo.STAGES)
                and eng.total_bins()
                <= max(1, eng.cell_count()) * eng.max_bins),
            "burning": obslo.burning(),
            "trips": obslo.trips_total(),
            "burn": obslo.state()["burn"],
        }
        spot_section = None
        if cfg.spot_fraction > 0.0:
            live_spot = sum(
                1 for r in fake.list_instances()
                if r.capacity_type == wellknown.CAPACITY_TYPE_SPOT)
            spot_section = {
                "cohort_spot_pods": spot_offered,
                # every spot launch is either still in the ledger or was
                # reclaimed — their sum is the total spot fleet the run saw
                "spot_instances_live": live_spot,
                "interruptions": (
                    reclaim_plan.fired_counts().get(
                        ("provider", "reclaim", "spot-interruption"), 0)
                    if reclaim_plan is not None else 0),
                "instances_reclaimed": len(reclaimed_ids),
                "displaced": len(displaced),
                "rebound": sum(1 for n in displaced if n in bound_at),
            }
        gangs_full = sum(1 for ms in gang_members.values()
                         if all(n in bound_at for n in ms))
        partial_gangs = sum(
            1 for ms in gang_members.values()
            if 0 < sum(n in bound_at for n in ms) < len(ms))
        report = {
            "config": asdict(cfg),
            "offered": dict(offered),
            "offered_total": sum(offered.values()),
            "bound": len(bound_at),
            "cohort_unbound": len(unbound),
            "pending_to_bound_s": latency,
            "shed": shed,
            "system_critical_shed": shed.get("system-critical", 0),
            "peak_level": peak_level,
            "recovery_to_l0_s": (round(recovery_at - flood_end, 2)
                                 if recovery_at is not None else None),
            "churn_deleted": churn_deleted,
            "gangs": {
                "offered_gangs": len(gang_members),
                "gang_size": cfg.gang_size,
                "gangs_fully_bound": gangs_full,
                "partial_gangs": partial_gangs,
            },
            "spot": spot_section,
            "journal": journal.stats() if journal is not None else None,
            "store_ops": sampler.report(),
            "slo": slo_section,
            "slo_digest_parity": digest_parity,
            "rss_growth_mib": (peak_rss - start_rss) >> 20,
            "chaos_fired": ({f"{b}/{o}/{k}": n for p in (plan, reclaim_plan)
                             if p is not None
                             for (b, o, k), n in p.fired_counts().items()}
                            if plan is not None else None),
            "workers_healthy": manager.healthz(),
            "nproc": os.cpu_count(),
            "wall_s": round(time.perf_counter() - t_run0, 2),
            "completed": (not unbound and recovery_at is not None
                          and manager.healthz() and partial_gangs == 0),
        }
        return report
    finally:
        if cfg.chaos:
            inject.uninstall()
        manager.stop()
        if journal is not None:
            journal.close_journal()
        core.unwatch(watch_q)
        pressure.set_monitor(None)
        if cfg.slo_objectives is not None:
            obslo.configure(objectives=obslo.default_objectives())


# ---------------------------------------------------------------------------
# Store A/B: indexed+striped list-by-kind vs the naive full-scan store
# ---------------------------------------------------------------------------

def _fill_store(store: KubeCore, objects: int, minority: int) -> None:
    """minority Nodes drowned in (objects - minority) Pods: the by-kind
    regime where an index wins and a full scan pays for every object."""
    for i in range(minority):
        store.create(Node(metadata=ObjectMeta(name=f"ab-node-{i}")))
    for i in range(objects - minority):
        store.create(Pod(metadata=ObjectMeta(
            name=f"ab-pod-{i}", namespace="default")))


def store_ab(objects: int = 100_000, minority: int = 2_000,
             iters: int = 30) -> dict:
    """List-by-kind throughput A/B at ``objects`` total objects: the
    striped store's ``scan("Node", ...)`` touches only the Node stripe
    (``minority`` objects); the naive single-dict store filters all
    ``objects``. The gate (replay_verdict) is on the no-copy scan path —
    the deep-copy ``list()`` leg is reported for honesty but its
    per-object copy cost is identical in both stores and would mask the
    index win. Every scan and list must return ``minority`` Nodes."""
    results = {}
    for label, store in (("striped", KubeCore()), ("naive", NaiveKubeCore())):
        t0 = time.perf_counter()
        _fill_store(store, objects, minority)
        fill_s = time.perf_counter() - t0
        scan_times, list_times = [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = store.scan("Node", lambda n: n.metadata.name)
            scan_times.append(time.perf_counter() - t0)
            if len(out) != minority:
                raise RuntimeError(f"{label} scan returned {len(out)} Nodes, not {minority}")
        for _ in range(max(3, iters // 3)):
            t0 = time.perf_counter()
            out = store.list("Node")
            list_times.append(time.perf_counter() - t0)
            if len(out) != minority:
                raise RuntimeError(f"{label} list returned {len(out)} Nodes, not {minority}")
        results[label] = {
            "fill_s": round(fill_s, 3),
            "scan_p50_ms": round(sorted(scan_times)[len(scan_times) // 2]
                                 * 1e3, 3),
            "list_p50_ms": round(sorted(list_times)[len(list_times) // 2]
                                 * 1e3, 3),
        }
    scan_speedup = (results["naive"]["scan_p50_ms"]
                    / max(results["striped"]["scan_p50_ms"], 1e-6))
    list_speedup = (results["naive"]["list_p50_ms"]
                    / max(results["striped"]["list_p50_ms"], 1e-6))
    return {
        "objects": objects, "minority_kind_objects": minority,
        "iters": iters,
        "striped": results["striped"], "naive": results["naive"],
        "scan_speedup": round(scan_speedup, 1),
        "list_speedup": round(list_speedup, 1),
        "gate": "scan_speedup >= 5 (no-copy by-kind path; the list leg's "
                "deep copies cost the same in both stores)",
    }


def main(argv: Optional[List[str]] = None) -> int:
    """Knob-level CLI for ad-hoc replays: ``python -m
    karpenter_tpu_torch.replay --gang-fraction 0.2`` injects seeded
    all-or-nothing pod groups into the cohort and fails the run if any
    gang bound partially. Prints ONE JSON line, ``{"replay": <report>,
    "store_ab": null}``, the shape :mod:`karpenter_tpu_torch.replay_verdict`
    reads."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="cluster-in-a-box replay")
    ap.add_argument("--pods-total", type=int, default=10_000)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--bound-cohort", type=int, default=200)
    ap.add_argument("--churn-pods", type=int, default=200)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--settle-s", type=float, default=60.0)
    ap.add_argument("--gang-fraction", type=float, default=0.0,
                    help="fraction of the cohort offered as gangs")
    ap.add_argument("--gang-size", type=int, default=4)
    ap.add_argument("--spot-fraction", type=float, default=0.0,
                    help="fraction of the default-band cohort pinned to "
                         "spot; > 0 arms seeded spot-interruption reclaims "
                         "and requires every displaced pod to rebind")
    ap.add_argument("--no-chaos", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the shard workers run on (cuda or cpu)")
    args = ap.parse_args(argv)
    cfg = ReplayConfig(
        pods_total=args.pods_total, shards=args.shards,
        tenants=args.tenants, seed=args.seed,
        bound_cohort=args.bound_cohort, churn_pods=args.churn_pods,
        max_depth=max(400, args.pods_total // 3), ticks=args.ticks,
        tick_sleep_s=0.1, chaos=not args.no_chaos, settle_s=args.settle_s,
        flood_pool=128, gang_fraction=args.gang_fraction,
        gang_size=args.gang_size, spot_fraction=args.spot_fraction)
    report = run_replay(cfg, device=args.device)
    print(json.dumps({"replay": report, "store_ab": None}, default=str))
    return 0 if report["completed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
