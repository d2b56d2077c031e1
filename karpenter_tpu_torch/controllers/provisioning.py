"""Provisioning controller + Provisioner workers: the window path on the card.

Reference: pkg/controllers/provisioning/{controller.go,provisioner.go}, and
the JAX package's ``controllers/provisioning.py``, trimmed to its window
path:

- the controller reconciles Provisioner CRs into in-memory workers (one
  thread each), refreshes the universe requirements from the live catalog
  and restarts a worker on a spec change;
- the worker owns the hot loop: batch → schedule → solve (the batched pack
  kernel, beside it the global window backend) → launch → bind, through a
  bounded-depth pipeline (solver/pipeline.py) that overlaps one chunk's
  device solve with the previous chunk's launch and bind.

Both deployment shapes of the reference come with it: ``shards=0`` (one
worker per Provisioner) and ``shards=N`` (N long-lived shard workers, each
Provisioner's engine on shard ``crc32(name) % N``). They share the code.

The device is resolved once, when the controller or a worker is made, so a
missing card raises there and not halfway through a window. Every window
runs on it: ``dispatch_batch`` answers each schedule (``"device-batch"``,
or ``"device"`` for a lone problem) and the global backend its relaxation
(``"device-global"``). The window never drops to a host oracle: an error
of ``dispatch_batch`` or of its fetch propagates through the pipeline's
drain. The one error that is caught is the global leg's, as the reference
catches it: the chunk keeps its FFD plans, which came from the same device
path, and the worker counts it in ``global_errors``.

The scheduler injects pod-(anti-)affinity (its match matrix on the same
device). The packing policy and its context ride the worker's
``solver_config``; under ``interruption-priced`` with no pinned repack
price, each chunk prices its own (``_chunk_solver_config``), and a
schedule with soft-affinity votes launches in the zone its row was priced
at (``_steer``).

Gang schedules peel off into the chunk's co-pack window
(``_encode_gangs``): one launch of the what-if kernel for every complete
gang of the chunk, beside the carve program when a gang declares a TPU
slice (``dispatch_gang_window``), then ``plan_gang_window`` re-verifies
each gang on host ints, prices preemption of lower-band residents against
fresh nodes, and ``_launch_gang`` binds it all or nothing. Bound slice
gangs commit their carves to the occupancy ledger (``ops/topology.LEDGER``),
whose partly carved nodes come back to the next window as seed bins.

Observability is the JAX package's: each window is one ``provision``
window span (its id, from ``obs/trace.new_window_id()``, is the
``window_id=`` of every log line) with the ``intake``, ``feasibility`` and
``bind`` spans and the pipeline's stage spans under it; the scheduling,
binpacking and bind histograms (the bind's exemplar is the window's trace
id); the window splits, gang, carve, preemption and soft-affinity
counters; and the per-pod SLO stamps (``_stamp_chunk_slo``) from the
pipeline's own dispatch, fetch and done stamps. A caught global-leg error
counts the chunk's schedules in ``karpenter_global_fallback_total`` under
``error`` (and in ``global_errors``).

Crash safety is the JAX package's write-ahead intent journal
(runtime/journal.py), on when the controller is given ``journal=``: each
launch is a ``fleet-launch`` intent whose nonce is durable before the
provider create (``jr.preassigned_nonce``), each node a ``bind`` intent,
each gang a ``gang-bind`` intent (nonces and created nodes noted as they
grow, the unwind bracketed by ``unwinding`` / ``unwound``), each bound
slice gang's carve a long-lived ``carve`` intent (its payload also rides
the gang's ``bound`` append) and each displacement a ``preempt`` intent.
Startup recovery (controllers/recovery.py) replays what a dead process
left open. With ``journal=None`` (the default) none of this runs.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Node, NodeSelectorRequirement, Pod, Taint
from karpenter_tpu_torch.api.gang import gang_of
from karpenter_tpu_torch.api.provisioner import Provisioner, set_condition
from karpenter_tpu_torch.backend import DeviceLike, resolve_device
from karpenter_tpu_torch.cloudprovider.spi import CloudProvider
from karpenter_tpu_torch import pressure
from karpenter_tpu_torch.metrics.gang import (
    GANG_WINDOWS_TOTAL, GANGS_PLACED_TOTAL, GANGS_UNPLACEABLE_TOTAL,
)
from karpenter_tpu_torch.metrics.global_solve import GLOBAL_FALLBACK_TOTAL
from karpenter_tpu_torch.metrics.policy import SOFT_AFFINITY_STEERED_TOTAL
from karpenter_tpu_torch.metrics.pressure import WINDOW_SPLITS_TOTAL
from karpenter_tpu_torch.metrics.registry import HISTOGRAMS
from karpenter_tpu_torch.metrics.topology import (
    PREEMPTION_DISPLACED_PODS_TOTAL, PREEMPTIONS_TOTAL, TOPOLOGY_CARVE_WINDOWS_TOTAL,
    TOPOLOGY_CARVES_COMMITTED_TOTAL,
)
from karpenter_tpu_torch.models.consolidate import NANO, free_capacity_vector
from karpenter_tpu_torch.obs import slo
from karpenter_tpu_torch.obs import trace as obtrace
from karpenter_tpu_torch.ops import feasibility
from karpenter_tpu_torch.ops import policy as ops_policy
from karpenter_tpu_torch.ops import topology as topo_ops
from karpenter_tpu_torch.ops.gang import GangBin, GangEncoding, encode_gang_window
from karpenter_tpu_torch.pressure.bands import RANK
from karpenter_tpu_torch.runtime import journal as jr
from karpenter_tpu_torch.runtime.kubecore import AlreadyExists, ApiError, KubeCore, NotFound
from karpenter_tpu_torch.scheduling.batcher import Batcher
from karpenter_tpu_torch.scheduling.preempt_budget import PreemptionBudget
from karpenter_tpu_torch.scheduling.scheduler import Scheduler
from karpenter_tpu_torch.solver import adapter, global_solve
from karpenter_tpu_torch.solver import topology as topo_solver
from karpenter_tpu_torch.solver.adapter import pod_vector
from karpenter_tpu_torch.solver.batch_solve import Problem, dispatch_batch
from karpenter_tpu_torch.solver.gang import (
    GangPlacement, PreemptCandidate, PreemptContext, dispatch_gang_window, plan_gang_window,
)
from karpenter_tpu_torch.solver.host_ffd import R_PODS
from karpenter_tpu_torch.solver.pipeline import PipelineConfig, SolvePipeline
from karpenter_tpu_torch.solver.policy import PolicyContext, whatif_repack_cost
from karpenter_tpu_torch.solver.solve import (
    SolveResult, SolverConfig, global_requirements, solver_health,
)
from karpenter_tpu_torch.utils import node as nodeutil
from karpenter_tpu_torch.utils import pod as podutil

log = logging.getLogger("karpenter.provisioning")


class _NoChange(Exception):
    """Raised inside a patch fn to abort a no-op status write (kubecore.patch
    applies fn under the store lock; an exception leaves the store untouched,
    so no MODIFIED event fires and condition refreshes cannot self-loop)."""


def shard_of(name: str, shards: int) -> int:
    """Stable provisioner→shard assignment: crc32 of the CR name, stable
    across processes and restarts."""
    return zlib.crc32(name.encode()) % shards


@dataclass
class _ChunkPrep:
    """Host state of one window chunk, handed stage to stage through the
    pipeline (schedule → dispatch → launch/bind)."""

    schedules: list
    problems: List[Problem]
    pods: list = field(default_factory=list)
    schedule_s: float = 0.0
    dispatch_s: float = 0.0
    # the global backend's in-flight handle when this chunk dispatched one;
    # its fetch substitutes only strictly cheaper host-verified plans, so
    # None (or a declined schedule) keeps the FFD result
    global_handle: Optional[object] = None
    # chunk-scoped SolverConfig: the interruption-priced policy's repack
    # cost priced for this chunk (None: the worker's config as-is)
    solver_config: Optional[SolverConfig] = None
    # the gang co-pack half of the chunk: one batched solve for every
    # complete pod group the scheduler grouped out of it
    gang_enc: Optional[GangEncoding] = None
    gang_types: list = field(default_factory=list)  # type idx → (schedule, it)
    gang_handle: Optional[object] = None
    gang_nodes: Dict[int, str] = field(default_factory=dict)  # bin → node
    # the gang window's readings (encode, plan and launch/bind seconds,
    # counts, executor, kernel ms), once completed
    gang: dict = field(default_factory=dict)


class ProvisionerEngine:
    """Per-Provisioner solve machinery, independent of intake: the
    scheduler and ONE long-lived SolvePipeline (its adaptive depth learns
    across windows). A shard worker hosts one engine per Provisioner; in
    the one-worker-per-Provisioner shape it hosts exactly one."""

    def __init__(self, provisioner: Provisioner, kube: KubeCore,
                 pipeline_config: Optional[PipelineConfig] = None,
                 device: DeviceLike = None, shard: str = ""):
        self.provisioner = provisioner
        self.pipeline_config = pipeline_config or PipelineConfig()
        self.pipeline = SolvePipeline(self.pipeline_config, shard=shard)
        self.scheduler = Scheduler(kube, device=device)


class ProvisionerWorker:
    """One intake shard: a thread + bounded priority batcher hosting the
    engine(s) of the Provisioner(s) assigned to it (provisioner.go:41-76).

    ``device`` (default: the CUDA device; ``"cpu"`` runs the plain
    versions) is resolved here, once. After each window ``last_window``
    holds its readings: the intake wait, and per chunk the schedule,
    dispatch, in-flight, fetch and launch/bind seconds (a chunk with gangs
    adds its gang window's, ``gang``). ``journal`` (an
    ``runtime.journal.IntentJournal``) journals every mutation."""

    def __init__(
        self,
        provisioner: Optional[Provisioner],
        kube: KubeCore,
        cloud_provider: CloudProvider,
        solver_config: Optional[SolverConfig] = None,
        batcher: Optional[Batcher] = None,
        pipeline_config: Optional[PipelineConfig] = None,
        shard: str = "",
        device: DeviceLike = None,
        journal: Optional["jr.IntentJournal"] = None,
    ):
        self.device = resolve_device(device)
        self.journal = journal
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.solver_config = solver_config or SolverConfig()
        self.preempt_budget = PreemptionBudget()
        self.batcher = batcher or Batcher()
        self.pipeline_config = pipeline_config or PipelineConfig()
        self.shard = shard
        if shard:
            self.batcher.shard = shard  # per-shard intake metric labels
        # global-leg failures caught since this worker was made: each chunk
        # kept its FFD plans
        self.global_errors = 0
        # (namespace, name) of the pods in the window being provisioned
        self._inflight: frozenset = frozenset()
        self.last_window: dict = {}
        self._chunks: List[dict] = []
        # engine map is copy-on-write (REPLACED under _engines_lock, never
        # mutated) so the hot loop and selection's targets() iterate a
        # snapshot without taking the lock
        self._engines: Dict[str, ProvisionerEngine] = {}
        self._engines_lock = threading.Lock()
        # the engine a provision pass is serving; the chunk-stage callbacks
        # resolve through it. Only the worker thread writes it during a
        # pass; direct test calls see the default engine.
        self._current: Optional[ProvisionerEngine] = None
        # the id of the window this worker is serving: the trace id of the
        # window span and the window_id= key on every window-scoped log line
        # (present with tracing off too, so logs always join)
        self._window_id: str = "-"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if provisioner is not None:
            self.attach(provisioner)

    # -- engine management ----------------------------------------------------
    def attach(self, provisioner: Provisioner) -> None:
        """Add (or replace, on spec change) the engine for a Provisioner."""
        eng = ProvisionerEngine(provisioner, self.kube, pipeline_config=self.pipeline_config,
                                device=self.device, shard=self.shard)
        with self._engines_lock:
            engines = dict(self._engines)
            engines[provisioner.metadata.name] = eng
            self._engines = engines

    def detach(self, name: str) -> None:
        with self._engines_lock:
            if name in self._engines:
                engines = dict(self._engines)
                del engines[name]
                self._engines = engines

    def engines(self) -> List[ProvisionerEngine]:
        """Snapshot of hosted engines in attach order."""
        return list(self._engines.values())

    def _default_engine(self) -> Optional[ProvisionerEngine]:
        for eng in self._engines.values():
            return eng
        return None

    def _engine(self) -> ProvisionerEngine:
        eng = self._current or self._default_engine()
        if eng is None:
            raise RuntimeError("worker has no attached provisioner engine")
        return eng

    @property
    def provisioner(self) -> Provisioner:
        """The engine currently being served, else the first attached one."""
        return self._engine().provisioner

    @property
    def pipeline(self) -> SolvePipeline:
        return self._engine().pipeline

    @property
    def scheduler(self) -> Scheduler:
        return self._engine().scheduler

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        name = (f"provisioner-shard-{self.shard}" if self.shard
                else f"provisioner-{self.provisioner.metadata.name}")
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the loop; with ``timeout``, also wait up to that long for
        the thread to end."""
        self._stop.set()
        self.batcher.stop()
        if timeout is not None and self._thread is not None:
            self._thread.join(timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.provision()
            except Exception:
                # the loop must outlive one window's failure: its pods stay
                # Pending and the selection requeue re-offers them
                log.exception("provisioning failed window_id=%s", self._window_id)

    # -- API for the selection controller -----------------------------------
    def add(self, pod: Pod, key=None,
            provisioner: Optional[str] = None) -> Optional[threading.Event]:
        """Enqueue a pod; returns the gate to block on (provisioner.go:80-82)
        or None when brownout admission shed the pod. ``key`` (namespace,
        name) enables :meth:`pending` de-duplication. ``provisioner`` routes
        the pod to that engine's group within the shard window; None means
        the default (first attached) engine."""
        band, priority = pressure.classify(pod)
        gspec = gang_of(pod)
        gang = (gspec.key, gspec.size) if gspec is not None and not gspec.error else None
        return self.batcher.add((provisioner, pod), key=key, band=band,
                                priority=priority, gang=gang)

    def pending(self, key) -> bool:
        """True while a pod with this (namespace, name) key awaits a batch
        window or is in the window being provisioned — the selection
        requeue loop skips re-adding it. The JAX package answers for queued
        pods only, so a window that outlasts the requeue interval has its
        pods re-offered; over the wire the next window's provisionability
        check reads an informer cache that lags this worker's own binds,
        and solves, launches and binds them again (each bind a 409)."""
        return key in self._inflight or self.batcher.contains(key)

    # -- the hot loop (provisioner.go:84-120) --------------------------------
    def provision(self) -> Optional[SolveResult]:
        t_wait0 = time.perf_counter()
        items, window = self.batcher.wait()
        t_wait1 = time.perf_counter()
        try:
            if not items or self._stop.is_set():
                return None
            self._inflight = frozenset((p.metadata.namespace, p.metadata.name)
                                       for _, p in items)
            # window marks: the batcher leaves per-pod (band, intake_s)
            # aligned index for index with items; keyed by pod identity
            # they follow the window across chunking and regrouping, and
            # use_marks makes them reachable from every pipeline stage (and,
            # through the BatchHandle's capture, from the fetch side)
            meta = self.batcher.last_window_meta
            self.batcher.last_window_meta = None
            marks = None
            if meta is not None and len(meta) == len(items):
                marks = slo.WindowMarks(
                    t_close=t_wait1, meta={id(it[1]): m for it, m in zip(items, meta)})
            wid = self._window_id = obtrace.new_window_id()
            shard = self.shard or "0"
            level = int(self.batcher._monitor().level())
            self._chunks = []
            with slo.use_marks(marks), \
                    obtrace.window_span("provision", window_id=wid, shard=shard,
                                        pressure_level=level, pods=len(items)):
                # the intake wait predates the window span: its first
                # child, recorded retroactively
                obtrace.add_span("intake", t_wait0, t_wait1, shard=shard,
                                 window_s=round(window, 4))
                log.info("batched %d pods in %.2fs window_id=%s shard=%s",
                         len(items), window, wid, shard)
                # dedupe within the batch: the non-blocking selection path
                # can requeue a still-pending pod into the same window. Then
                # group by engine, PRESERVING the window's priority order
                # within each group (dict insertion order).
                seen = set()
                groups: Dict[Optional[str], List[Pod]] = {}
                for pname, p in items:
                    key = (p.metadata.namespace, p.metadata.name)
                    if key in seen:
                        continue
                    seen.add(key)
                    groups.setdefault(pname, []).append(p)
                last_result = None
                for pname, pods in groups.items():
                    eng = (self._engines.get(pname) if pname is not None
                           else self._default_engine())
                    if eng is None:
                        # provisioner deleted while its pods sat in the
                        # window: the pods stay Pending and the selection
                        # requeue re-routes them to a surviving provisioner
                        log.info("dropping %d pod(s) for detached provisioner %s "
                                 "window_id=%s shard=%s", len(pods), pname, wid, shard)
                        continue
                    result = self._provision_group(eng, pods)
                    if result is not None:
                        last_result = result
            self.last_window = {
                "window_id": wid, "pods": len(items), "pressure_level": level,
                "intake_wait_s": t_wait1 - t_wait0, "batch_window_s": window,
                "chunks": self._chunks, "pipeline": dict(self.pipeline.last_window),
            }
            return last_result
        finally:
            self._inflight = frozenset()
            self.batcher.flush()

    def _provision_group(self, eng: ProvisionerEngine,
                         pods: List[Pod]) -> Optional[SolveResult]:
        """Run one engine's share of the window through its pipeline."""
        pods = [p for p in pods if self._is_provisionable(p)]
        # L1+ batch split: the batcher returns windows in priority order,
        # so chunking preserves it — critical pods solve and bind in the
        # FIRST chunk, and each chunk bounds the solve's p99 under pressure
        monitor = self.batcher._monitor()
        split = monitor.config.split_items
        if int(monitor.level()) >= 1 and 0 < split < len(pods):
            chunks = [pods[i:i + split] for i in range(0, len(pods), split)]
            if self.shard:
                WINDOW_SPLITS_TOTAL.inc(amount=float(len(chunks) - 1), shard=self.shard)
            else:
                WINDOW_SPLITS_TOTAL.inc(amount=float(len(chunks) - 1))
            log.info("pressure L%d: split %d-pod window into %d chunks of <=%d "
                     "window_id=%s shard=%s", int(monitor.level()), len(pods),
                     len(chunks), split, self._window_id, self.shard or "0")
        else:
            # L0: bound chunks to the pipeline's unit size so depth > 1 has
            # work to overlap. The SAME boundaries apply at depth 1, so
            # serial and pipelined runs stay node for node identical
            ci = eng.pipeline_config.chunk_items
            if 0 < ci < len(pods):
                chunks = [pods[i:i + ci] for i in range(0, len(pods), ci)]
            else:
                chunks = [pods]
        # the pipeline consumes FIFO, so the first chunk still launches and
        # binds as soon as its solve lands while the next chunk's solve is
        # in flight; at L1+ the depth collapses to 1 (the serial loop)
        eng.pipeline.set_monitor(monitor)
        self._current = eng
        try:
            results = eng.pipeline.run(
                chunks, prepare=self._prepare_chunk, dispatch=self._dispatch_chunk,
                consume=self._complete_chunk, on_chunk=self._observe_chunk)
        finally:
            self._current = None
            # tag the window span with the pipeline's measured overlap, the
            # same ledger as solver_overlap_seconds_total
            cur = obtrace.current_context()
            lw = eng.pipeline.last_window
            if cur is not None and lw:
                cur.tag(wall_s=round(lw.get("wall_s", 0.0), 6),
                        overlap_s=round(lw.get("overlap_s", 0.0), 6), depth=lw.get("depth"))
        last_result = None
        for result in results:
            if result is not None:
                last_result = result
        return last_result

    # -- pipeline stages (one schedule → solve → launch pass per chunk) ------
    def _prepare_chunk(self, pods: List[Pod]) -> _ChunkPrep:
        """Host stage: schedule the chunk and build its packing problems
        (timed in ``scheduling_duration_seconds``, the scheduler pass in a
        ``feasibility`` span)."""
        t0 = time.perf_counter()
        eng = self._engine()
        name = eng.provisioner.metadata.name
        with HISTOGRAMS.time("scheduling_duration_seconds", provisioner=name):
            with obtrace.span("feasibility", provisioner=name, pods=len(pods)):
                schedules = eng.scheduler.solve(eng.provisioner, pods)
            # gang schedules peel off into the co-pack window; the rest keep
            # the reference's per-schedule packing problems
            gang_scheds = [s for s in schedules if s.gang is not None]
            schedules = [s for s in schedules if s.gang is None]
            problems = [
                Problem(constraints=s.constraints, pods=s.pods,
                        instance_types=self.cloud_provider.get_instance_types(s.constraints),
                        daemons=self._get_daemons(s.constraints),
                        soft_affinity=s.soft_affinity)
                for s in schedules
            ]
        prep = _ChunkPrep(schedules=schedules, problems=problems, pods=pods)
        if gang_scheds:
            t_enc = time.perf_counter()
            prep.gang_enc, prep.gang_types = self._encode_gangs(gang_scheds)
            # seed bins ARE real nodes: their bin → node names make
            # _launch_gang bind onto them without creating anything
            for bi, bn in enumerate(prep.gang_enc.bins):
                if bn.node_name:
                    prep.gang_nodes[bi] = bn.node_name
            prep.gang["encode_s"] = time.perf_counter() - t_enc
        prep.solver_config = self._chunk_solver_config(prep)
        prep.schedule_s = time.perf_counter() - t0
        return prep

    def _chunk_solver_config(self, prep: _ChunkPrep) -> Optional[SolverConfig]:
        """What-if pricing handoff: when the interruption-priced policy is
        active and the operator left repack_cost_per_hour unpinned (0),
        price this chunk's spot-loss cost through
        solver/policy.whatif_repack_cost: 0 when the chunk's pods would
        refit on the fleet's existing free capacity (losing a spot node is
        then free, so spot's discount wins), else the cheapest on-demand
        replacement $/h (spot must now beat its reclaim tax). Returns a
        chunk-scoped SolverConfig carrying the priced PolicyContext, or
        None to use the worker config as-is."""
        cfg = self.solver_config
        if cfg.packing_policy != "interruption-priced":
            return None
        if cfg.policy_context.repack_cost_per_hour > 0.0:
            return None  # operator-pinned: respect the explicit price
        if not prep.problems:
            return None
        free_vecs = []
        for node in self.kube.list("Node"):
            if node.metadata.deletion_timestamp is not None:
                continue
            if not nodeutil.is_ready(node):
                continue
            free_vecs.append(free_capacity_vector(
                node, self.kube.pods_on_node(node.metadata.name)))
        # price the dearest schedule group of the chunk: conservative, spot
        # is only chosen when even the worst-case repack is cheap
        repack = 0.0
        for problem in prep.problems:
            repack = max(repack, whatif_repack_cost(
                [pod_vector(p) for p in problem.pods], free_vecs,
                problem.instance_types, problem.constraints.requirements,
                cfg.cost_config))
        return replace(cfg, policy_context=PolicyContext(
            repack_cost_per_hour=repack, throughput=cfg.policy_context.throughput))

    def _dispatch_chunk(self, prep: _ChunkPrep):
        """ALL the chunk's schedules pack in one batched device launch
        instead of the reference's sequential per-schedule loop
        (provisioner.go:109-120); the global backend's relaxation of the
        same problems rides the same stage. Asynchronous: returns the
        in-flight BatchHandle for the pipeline to fetch."""
        t0 = time.perf_counter()
        cfg = prep.solver_config or self.solver_config
        handle = dispatch_batch(prep.problems, config=cfg, device=self.device)
        if (cfg.window_backend == "global" and prep.problems and global_solve.enabled()
                and int(self.batcher._monitor().level()) < 1):
            # at pressure L1+ the window collapses to the FFD backend
            # (chunked solves must stay p99-bounded)
            try:
                prep.global_handle = global_solve.dispatch_global_window(
                    prep.problems, cfg, device=self.device)
            except Exception:
                self._global_failed("dispatch", len(prep.problems))
        if prep.gang_enc is not None and prep.gang_enc.g > 0:
            # the gang window rides the same stage; its fetch comes at launch
            prep.gang_handle = dispatch_gang_window(prep.gang_enc, self.device)
        prep.dispatch_s = time.perf_counter() - t0
        return handle

    def _global_failed(self, stage: str, schedules: int) -> None:
        """The global leg is a filter over FFD's plans: whatever failed, the
        chunk binds the plans dispatch_batch answered on the same device,
        and each of its schedules counts as a global fallback (``error``)."""
        self.global_errors += 1
        GLOBAL_FALLBACK_TOTAL.inc(amount=float(schedules), reason="error")
        log.exception("global window %s failed; keeping FFD plans window_id=%s shard=%s",
                      stage, self._window_id, self.shard or "0")

    def _complete_chunk(self, prep: _ChunkPrep,
                        results: List[SolveResult]) -> Optional[SolveResult]:
        """Launch/bind stage: runs while the NEXT chunk's solve is in
        flight (depth permitting)."""
        global_results: Optional[list] = None
        if prep.global_handle is not None:
            try:
                plan = prep.global_handle.fetch()
            except Exception:
                self._global_failed("fetch", len(prep.problems))
            else:
                global_results = plan.results
                if plan.accepted:
                    log.info("global window solve: %d/%d schedule(s) strictly cheaper "
                             "(executor=%s) window_id=%s shard=%s", plan.accepted,
                             len(plan.results), plan.executor, self._window_id,
                             self.shard or "0")
        last_result = None
        for idx, (schedule, result) in enumerate(zip(prep.schedules, results)):
            if global_results is not None and global_results[idx] is not None:
                result = global_results[idx]
            last_result = result
            for packing in result.packings:
                err = self._launch(self._steer(schedule, packing), packing)
                if err is not None:
                    log.error("could not launch node: %s window_id=%s", err, self._window_id)
        if prep.gang_enc is not None:
            self._complete_gangs(prep)
        return last_result

    # -- gang co-pack (all-or-nothing pod groups) ----------------------------
    def _encode_gangs(self, gang_scheds):
        """Marshal every gang schedule of the chunk into ONE window
        encoding. The window's type axis is the concatenation of each
        schedule's validated, sorted catalog segment, so a gang's group
        column (ops/feasibility.gang_feasibility_mask, on this worker's
        device) is zero outside its own segment: prospective nodes only
        ever carry one schedule's labels and taints."""
        type_frees: list = []
        type_prices: list = []
        type_names: list = []
        type_ctx: list = []
        segments = []
        for s in gang_scheds:
            catalog = self.cloud_provider.get_instance_types(s.constraints)
            packables, sorted_types = adapter.build_packables_cached(
                catalog, s.constraints, s.pods, self._get_daemons(s.constraints))
            allowed = adapter.allowed_sets_cached(s.constraints)
            required = adapter._required_resources(s.pods)
            seg_mask = feasibility.gang_feasibility_mask(
                sorted_types, [(allowed, required)], s.gang.slice_, self.device)
            base = len(type_frees)
            for pk, it in zip(packables, sorted_types):
                type_frees.append([t - r for t, r in zip(pk.total, pk.reserved)])
                type_prices.append(it.price)
                type_names.append(it.name)
                type_ctx.append((s, it))
            segments.append((s, base, seg_mask))
        n = len(type_frees)
        gangs, slice_dims, gang_bands = [], [], []
        for s, base, seg_mask in segments:
            mask = np.zeros(n, bool)
            mask[base:base + len(seg_mask)] = seg_mask
            gangs.append((s.gang.key, s.pods, mask, s))
            slice_dims.append(s.gang.slice_.dims if s.gang.slice_ is not None else None)
            # the gang's band is its highest-priority member's: one
            # critical member makes the whole group preemption-proof
            gang_bands.append(min((pressure.classify(p)[0] for p in s.pods),
                                  key=lambda b: RANK.get(b, RANK["default"]),
                                  default="default"))
        if topo_solver.carve_enabled() and any(d is not None for d in slice_dims):
            # carve mode: the window carries slice grids, bands, per-type
            # torus dims and the ledger's partly carved real nodes as seed
            # bins; with the switch off none of these reach the encoder
            enc = encode_gang_window(
                gangs, type_frees, type_prices, type_names, slices=slice_dims,
                bands=gang_bands, type_grids=[it.grid_dims() for _s, it in type_ctx],
                seed_bins=self._gang_seed_bins(type_ctx))
        else:
            enc = encode_gang_window(gangs, type_frees, type_prices, type_names)
        return enc, type_ctx

    def _gang_seed_bins(self, type_ctx) -> List[GangBin]:
        """The occupancy ledger's partly carved Ready nodes, offered to the
        gang window as seed bins. A node matches by (instance type name,
        constraints signature) against the window's own type axis, so a
        seed only ever hosts gangs whose labels and taints the node
        already carries. Its free capacity is the node's LIVE residual
        (allocatable minus running pods)."""
        dropped = topo_ops.LEDGER.prune([n.metadata.name for n in self.kube.list("Node")])
        if self.journal is not None:
            # a pruned node's carves are gone for good: fold their durable
            # intents so compaction can drop the records
            for rec in dropped:
                if rec.intent_id:
                    self.journal.close(rec.intent_id, outcome="node-pruned")
        snap = topo_ops.LEDGER.snapshot()
        if not snap:
            return []
        index_of: Dict[Tuple[str, tuple], int] = {}
        sig_of: Dict[int, tuple] = {}
        for ti, (s, it) in enumerate(type_ctx):
            sig = sig_of.get(id(s))
            if sig is None:
                sig = sig_of[id(s)] = topo_ops.constraints_sig(s.constraints.labels,
                                                               s.constraints.taints)
            index_of.setdefault((it.name, sig), ti)
        seeds: List[GangBin] = []
        for ng in snap:
            ti = index_of.get((ng.type_name, ng.labels_sig))
            if ti is None:
                continue
            try:
                node = self.kube.get("Node", ng.node, "")
            except NotFound:
                continue
            if node.metadata.deletion_timestamp is not None or not nodeutil.is_ready(node):
                continue
            free = free_capacity_vector(node, self.kube.pods_on_node(ng.node))
            seeds.append(GangBin(name=ng.node, type_index=ti, free=[max(f, 0) for f in free],
                                 grid=ng.dims, occ=ng.occ.copy(), node_name=ng.node))
        return seeds

    def _complete_gangs(self, prep: _ChunkPrep) -> None:
        """Fetch the window's batched gang solve, re-verify every accepted
        gang on exact host ints, and bind each all or nothing. An
        unplaceable gang stays Pending: the selection requeue offers it
        again."""
        enc = prep.gang_enc
        t0 = time.perf_counter()
        GANG_WINDOWS_TOTAL.inc()
        if enc.carve is not None:
            TOPOLOGY_CARVE_WINDOWS_TOTAL.inc()
        for key, reason in enc.skipped:
            GANGS_UNPLACEABLE_TOTAL.inc(reason="no-type")
            log.info("gang %s unplaceable: %s window_id=%s shard=%s", key, reason,
                     self._window_id, self.shard or "0")
        feasible, executor = None, None
        handle = prep.gang_handle
        if handle is not None:
            feasible, _, executor = handle.fetch()
            log.info("gang window solved: %d gang(s) executor=%s window_id=%s shard=%s",
                     enc.g, executor, self._window_id, self.shard or "0")
        t_fetch = time.perf_counter()
        preempt = self._build_preempt_context(prep) if enc.carve is not None else None
        plan = plan_gang_window(enc, feasible, preempt)
        t_plan = time.perf_counter()
        for e, reason in plan.unplaced:
            GANGS_UNPLACEABLE_TOTAL.inc(reason=reason)
            log.info("gang %s unplaceable: %s window_id=%s shard=%s", e.key, reason,
                     self._window_id, self.shard or "0")
        pre_of: Dict[int, List[PreemptCandidate]] = {}
        for e, cand in plan.preemptions:
            pre_of.setdefault(e.index, []).append(cand)
        placed = failed = preempted = 0
        for placement in plan.placements:
            # victims ride into _launch_gang: they unbind only once every
            # beneficiary node exists, but before its members bind
            victims = pre_of.pop(placement.gang.index, [])
            err = self._launch_gang(prep, placement, victims)
            if err is None:
                GANGS_PLACED_TOTAL.inc()
                placed += 1
                preempted += len(victims)
            else:
                GANGS_UNPLACEABLE_TOTAL.inc(reason="bind-failed")
                failed += 1
                log.error("gang %s bind failed (unwound): %s window_id=%s shard=%s",
                          placement.gang.key, err, self._window_id, self.shard or "0")
        prep.gang.update({
            "gangs": enc.g, "bins": enc.b, "skipped": len(enc.skipped),
            "placed": placed, "unplaced": len(plan.unplaced), "bind_failed": failed,
            "preemptions": preempted, "executor": executor,
            "cells": enc.cells, "carve": enc.carve is not None,
            "kernel_ms": handle.kernel_ms if handle is not None else None,
            "carve_ms": handle.carve_ms if handle is not None else None,
            "fetch_s": t_fetch - t0, "plan_s": t_plan - t_fetch,
            "launch_bind_s": time.perf_counter() - t_plan})

    def _build_preempt_context(self, prep: _ChunkPrep) -> Optional[PreemptContext]:
        """Price every displaceable resident of the window's seed bins.
        System-critical residents are never offered; every other one is
        priced by solver/policy.whatif_repack_cost (0 when its members
        refit on the fleet's free capacity, else the cheapest replacement
        node's $/h), so the planner preempts exactly when displacement is
        cheaper than a fresh node. The budget filters the candidates
        first."""
        enc = prep.gang_enc
        seeds = [(bi, bn) for bi, bn in enumerate(enc.bins) if bn.node_name]
        if not seeds:
            return None
        self.preempt_budget.tick()
        by_node = {ng.node: ng for ng in topo_ops.LEDGER.snapshot()}
        free_vecs: Optional[list] = None
        cands: List[PreemptCandidate] = []
        for bi, bn in seeds:
            ng = by_node.get(bn.node_name)
            if ng is None:
                continue
            sched, _it = prep.gang_types[bn.type_index]
            seg_types = [it for s2, it in prep.gang_types if s2 is sched]
            for rec in ng.carves.values():
                if rec.band == "system-critical":
                    continue
                vecs, live = [], []
                refund = [0] * len(bn.free)
                for pns, pname in rec.pods:
                    try:
                        p = self.kube.get("Pod", pname, pns)
                    except NotFound:
                        continue
                    v = pod_vector(p)
                    vecs.append(v)
                    refund = [a + b for a, b in zip(refund, v)]
                    refund[R_PODS] += NANO  # the pod slot comes back too
                    live.append((pns, pname))
                if free_vecs is None:
                    free_vecs = [
                        free_capacity_vector(node, self.kube.pods_on_node(node.metadata.name))
                        for node in self.kube.list("Node")
                        if node.metadata.deletion_timestamp is None and nodeutil.is_ready(node)]
                cost = (whatif_repack_cost(vecs, free_vecs, seg_types,
                                           sched.constraints.requirements,
                                           self.solver_config.cost_config) if vecs else 0.0)
                cands.append(PreemptCandidate(
                    gang_key=rec.gang_key, bin_index=bi, node=ng.node, band=rec.band,
                    pods=live, cells=rec.cells.copy(), refund=refund,
                    displacement_cost=cost))
        # anti-thrash gate before the planner prices anything: a window the
        # budget caps falls back to fresh nodes
        cands = self.preempt_budget.admit(cands)
        return PreemptContext(cands) if cands else None

    def _execute_preemption(self, cand: PreemptCandidate,
                            beneficiary=None) -> Optional[str]:
        """Displace one resident gang: unbind its members, release its
        ledger carves, and requeue the whole group atomically through the
        band-aware batcher (shed-proof: the members were running).

        Journaled, the displacement is bracketed by a ``preempt`` intent:
        the victim list is durable before the first unbind, and the phase
        advances to ``victims-unbound`` once the requeue and the carve
        release landed. Returns the intent id, which ``_launch_gang``
        advances to ``beneficiary-bound`` once the winner's members land."""
        journal = self.journal
        piid = None
        if journal is not None:
            piid = journal.open_intent(
                "preempt", gang=str(cand.gang_key), node=cand.node, band=cand.band,
                pods=[f"{pns}/{pname}" for pns, pname in cand.pods],
                beneficiary=str(beneficiary) if beneficiary else "")

        def clear(obj):
            if getattr(obj.spec, "node_name", ""):
                obj.spec.node_name = ""
            else:
                raise _NoChange

        entries = []
        for pns, pname in cand.pods:
            try:
                self.kube.patch("Pod", pname, pns, clear)
            except (_NoChange, NotFound):
                pass
            try:
                p = self.kube.get("Pod", pname, pns)
            except NotFound:
                continue
            band, priority = pressure.classify(p)
            gspec = gang_of(p)
            gang = (gspec.key, gspec.size) if gspec is not None and not gspec.error else None
            entries.append(((None, p), (pns, pname), band, priority, gang))
        if entries:
            self.batcher.requeue_displaced(entries)
        for _node, rec in topo_ops.LEDGER.pop_gang(cand.gang_key):
            if journal is not None and rec.intent_id:
                # fold the victim's durable carve
                journal.close(rec.intent_id, outcome="preempted")
        self.preempt_budget.charge(cand.gang_key, cand.band)
        if piid is not None:
            journal.advance(piid, "victims-unbound")
        PREEMPTIONS_TOTAL.inc(band=cand.band)
        if entries:
            PREEMPTION_DISPLACED_PODS_TOTAL.inc(amount=float(len(entries)))
        log.info("preempted gang %s on %s: band=%s %d pod(s) requeued displacement=$%.4f/h "
                 "window_id=%s shard=%s", cand.gang_key, cand.node, cand.band, len(entries),
                 cand.displacement_cost, self._window_id, self.shard or "0")
        return piid

    def _carve_payload(self, prep: _ChunkPrep, placement: GangPlacement) -> List[dict]:
        """JSON-ready carve records of a placement, one per carved bin: the
        data a ``carve`` intent carries. Built before the gang-bind intent
        advances to ``bound`` so the payload rides that append, and a crash
        between the bind and the carve commits re-commits from it."""
        if not getattr(placement, "carves", None):
            return []
        enc = prep.gang_enc
        constraints = placement.gang.context.constraints
        sig = topo_ops.constraints_sig(constraints.labels, constraints.taints)
        members = {bi: [(p.metadata.namespace, p.metadata.name) for p in pods]
                   for bi, pods in placement.node_sets}
        payload: List[dict] = []
        for bi, cells in placement.carves.items():
            node = prep.gang_nodes.get(bi)
            bn = enc.bins[bi]
            if node is None or bn.grid is None:
                continue
            _s, itype = prep.gang_types[bn.type_index]
            payload.append(dict(
                gang=str(placement.gang.key), node=node, grid=[int(d) for d in bn.grid],
                type=itype.name, sig=sig, cells=[int(c) for c in cells],
                band=placement.gang.band,
                pods=[f"{ns}/{nm}" for ns, nm in members.get(bi, [])]))
        return payload

    def _commit_carves(self, prep: _ChunkPrep, placement: GangPlacement,
                       carves: Optional[List[dict]] = None) -> None:
        """Record a bound slice gang's carve cells in the occupancy ledger,
        so later windows seed its nodes' residual grids back into the pool
        (and can price this gang as a preemption victim). Journaled, each
        commit is a long-lived ``carve`` intent opened before the ledger
        changes (an open one of the same (gang, node) is reused).
        ``carves`` is the payload the caller already built (None: build
        it)."""
        journal = self.journal
        if carves is None:
            carves = self._carve_payload(prep, placement)
        live: Dict[Tuple[str, str], str] = {}
        if journal is not None and carves:
            live = {(str(c.data.get("gang") or ""), str(c.data.get("node") or "")): c.id
                    for c in journal.open_of_kind("carve")}
        for rec in carves:
            cid = ""
            if journal is not None:
                cid = live.get((rec["gang"], rec["node"])) or journal.open_intent("carve", **rec)
            topo_ops.LEDGER.commit(
                rec["node"], tuple(rec["grid"]), rec["type"], rec["sig"], placement.gang.key,
                rec["cells"], rec["band"],
                [tuple(str(p).partition("/")[::2]) for p in rec["pods"]], intent_id=cid)
            TOPOLOGY_CARVES_COMMITTED_TOTAL.inc()

    def _launch_gang(self, prep: _ChunkPrep, placement: GangPlacement,
                     victims: Optional[List[PreemptCandidate]] = None) -> Optional[str]:
        """Atomic gang launch: every member binds or none stays bound. Two
        phases: create every node object first, then bind the members, so
        a launch failure costs no bind; a bind failure unwinds the bound
        members and hands the created nodes to the termination finalizer.
        ``victims`` (this gang's planned preemptions) are displaced between
        the phases: only once every node exists, so a refused launch
        evicts nothing, yet before any member binds onto the freed
        capacity. Journaled, the member set and the created-node set are
        durable as they grow, each fresh node's launch nonce before its
        provider create."""
        constraints = placement.gang.context.constraints
        provisioner = self._engine().provisioner
        try:
            latest = self.kube.get("Provisioner", provisioner.metadata.name)
        except NotFound:
            return "provisioner deleted"
        err = provisioner.spec.limits.exceeded_by(latest.status.resources)
        if err is not None:
            return err
        enc = prep.gang_enc
        journal = self.journal
        iid = None
        if journal is not None:
            iid = journal.open_intent(
                "gang-bind", gang=str(placement.gang.key),
                members=[f"{p.metadata.namespace}/{p.metadata.name}"
                         for p in placement.gang.pods])
        # phase 1: every node object exists before any member binds
        created: List[str] = []
        nonces: List[str] = []
        node_of: Dict[int, str] = {}
        for bin_index, _pods in placement.node_sets:
            name = prep.gang_nodes.get(bin_index)
            if name is None:
                _, itype = prep.gang_types[enc.bins[bin_index].type_index]
                if iid is not None:
                    nonce = jr.new_nonce()
                    nonces.append(nonce)
                    journal.note(iid, nonces=list(nonces))
                    with jr.preassigned_nonce(nonce):
                        name = self._create_gang_node(constraints, itype)
                else:
                    name = self._create_gang_node(constraints, itype)
                if name is None:
                    self._unwind_gang_journaled(iid, prep, placement, node_of, created)
                    return f"could not launch node for bin {enc.bins[bin_index].name}"
                prep.gang_nodes[bin_index] = name
                created.append(name)
                if iid is not None:
                    journal.note(iid, created=list(created))
            node_of[bin_index] = name
        if iid is not None:
            journal.advance(iid, "nodes-created", nodes=sorted(set(node_of.values())),
                            created=list(created))
        preempt_iids: List[str] = []
        for cand in victims or ():
            piid = self._execute_preemption(cand, beneficiary=placement.gang.key)
            if piid is not None:
                preempt_iids.append(piid)
        # phase 2: bind the members node set by node set
        for bin_index, pods in placement.node_sets:
            name = node_of[bin_index]
            try:
                errs = self.kube.bind_pods(pods, name)
            except ApiError as e:
                errs = [str(e)] * len(pods)
            errs = [e for e in errs if "already bound" not in e and "already exists" not in e]
            if errs:
                self._unwind_gang_journaled(iid, prep, placement, node_of, created)
                if journal is not None:
                    # the victims were unbound and requeued already: the
                    # displacement stands though the winner unwound
                    for piid in preempt_iids:
                        journal.close(piid, outcome="beneficiary-unwound")
                return f"binding to {name}: " + "; ".join(errs)
        # the carve payload rides the bound append: one durable record
        # covers the bind and the carve commits
        carves = self._carve_payload(prep, placement)
        if iid is not None:
            journal.advance(iid, "bound", carves=carves)
        self._commit_carves(prep, placement, carves)
        if iid is not None:
            for piid in preempt_iids:
                journal.advance(piid, "beneficiary-bound")
                journal.close(piid)
            journal.close(iid)
        log.info("gang %s bound: %d pod(s) across %d node(s) window_id=%s shard=%s",
                 placement.gang.key, len(placement.gang.pods), len(placement.node_sets),
                 self._window_id, self.shard or "0")
        return None

    def _unwind_gang_journaled(self, iid: Optional[str], prep: _ChunkPrep,
                               placement: GangPlacement, node_of: Dict[int, str],
                               created: List[str]) -> None:
        """The unwind bracketed by the journal: ``unwinding`` is durable
        before the first rollback write and ``unwound`` after the last, so
        recovery resumes (unwinding) or skips (unwound) a crashed one."""
        journal = self.journal
        if journal is not None and iid is not None:
            journal.advance(iid, "unwinding", nodes=sorted(set(node_of.values())),
                            created=list(created))
        self._unwind_gang(prep, placement, node_of, created)
        if journal is not None and iid is not None:
            journal.advance(iid, "unwound")
            journal.close(iid, outcome="unwound")

    def _create_gang_node(self, constraints: Constraints, itype) -> Optional[str]:
        """Launch ONE node of ``itype`` and create its Node object
        (finalizer + not-ready taint) without binding anything."""
        names: List[str] = []

        def bind(node: Node) -> Optional[str]:
            node.metadata.labels.update(constraints.labels)
            node.spec.taints.extend(constraints.taints)
            err = self._bind(node, [])
            if err is None:
                names.append(node.metadata.name)
            return err

        errs = [e for e in self.cloud_provider.create(constraints, [itype], 1, bind) if e]
        if errs:
            log.error("gang node launch failed: %s window_id=%s", "; ".join(errs),
                      self._window_id)
        return names[0] if names else None

    def _unwind_gang(self, prep: _ChunkPrep, placement: GangPlacement,
                     node_of: Dict[int, str], created: List[str]) -> None:
        """Roll a partly bound gang back to nothing: unbind every member
        that landed on one of this gang's nodes, then delete the nodes
        created for it (the termination finalizer tears them down)."""
        names = set(node_of.values())

        def clear(obj):
            if getattr(obj.spec, "node_name", "") in names:
                obj.spec.node_name = ""
            else:
                raise _NoChange

        for pod in placement.gang.pods:
            try:
                self.kube.patch("Pod", pod.metadata.name, pod.metadata.namespace, clear)
            except (_NoChange, NotFound):
                pass
        gone = set(created)
        for bi in [b for b, n in prep.gang_nodes.items() if n in gone]:
            del prep.gang_nodes[bi]  # a later gang must not bind here
        for name in created:
            try:
                self.kube.delete("Node", name, "")
            except (NotFound, ApiError):
                pass

    def _observe_chunk(self, prep: _ChunkPrep, stats: dict) -> None:
        # binpacking = the solver wall the hot loop paid (dispatch + the
        # blocked fetch); device time hidden behind launch/bind lands in
        # solver_overlap_seconds_total instead
        HISTOGRAMS.histogram("binpacking_duration_seconds").observe(
            prep.dispatch_s + stats["device_s"],
            provisioner=self._engine().provisioner.metadata.name)
        if slo.enabled():
            self._stamp_chunk_slo(prep, stats)
        self._chunks.append({
            "pods": len(prep.pods), "problems": len(prep.problems),
            "global": prep.global_handle is not None,
            "schedule_s": prep.schedule_s, "dispatch_s": prep.dispatch_s,
            "inflight_s": stats["inflight_s"], "fetch_s": stats["device_s"],
            "launch_bind_s": stats["launch_bind_s"], "t_dispatch": stats["t_dispatch"],
            "t_fetch": stats["t_fetch"], "t_done": stats["t_done"],
            "gang": dict(prep.gang) if prep.gang_enc is not None else None})

    def _stamp_chunk_slo(self, prep: _ChunkPrep, stats: dict) -> None:
        """Fold the chunk into the SLO digests from the pipeline's own stage
        boundaries (its t_dispatch / t_fetch / t_done perf_counter stamps)
        against the window marks' close stamp: nothing is timed again.
        Stage durations are shared chunk-wide, so they fold as one weighted
        record per band; only e2e (intake varies per pod) is per pod."""
        marks = slo.current_marks()
        if marks is None or not prep.pods:
            return
        t_dispatch, t_fetch, t_done = stats["t_dispatch"], stats["t_fetch"], stats["t_done"]
        schedule_s = max(0.0, t_dispatch - marks.t_close)
        solve_s = max(0.0, t_fetch - t_dispatch)
        bind_s = max(0.0, t_done - t_fetch)
        tail_s = max(0.0, t_done - marks.t_close)
        band_counts: Dict[str, int] = {}
        for p in prep.pods:
            m = marks.meta.get(id(p))
            if m is None:
                continue
            band, intake_s = m
            band_counts[band] = band_counts.get(band, 0) + 1
            slo.record(band, "e2e", intake_s + tail_s)
        for band, cnt in band_counts.items():
            slo.record(band, "schedule", schedule_s, count=cnt)
            slo.record(band, "solve", solve_s, count=cnt)
            slo.record(band, "bind", bind_s, count=cnt)

    def _is_provisionable(self, candidate: Pod) -> bool:
        """Fresh read per pod to avoid duplicate binds (provisioner.go:
        126-135), without a copy: a one-field check."""
        try:
            return not self.kube.read("Pod", candidate.metadata.name,
                                      candidate.metadata.namespace, podutil.is_scheduled)
        except NotFound:
            return False

    def _get_daemons(self, constraints: Constraints) -> List[Pod]:
        """Daemonset pods that would schedule on these nodes (packer.go:148-162)."""
        daemons = []
        for ds in self.kube.list("DaemonSet"):
            pod = Pod(spec=ds.spec.template.spec)
            if constraints.validate_pod(pod) is None:
                daemons.append(pod)
        return daemons

    def _steer(self, schedule, packing) -> Constraints:
        """Soft-affinity zone steering: the scoring program priced this
        schedule's row at its best-case zone (ops/policy.py soft term); the
        fleet launch would otherwise pick the lowest price among ALL
        allowed zones and could scatter the cohort. steer_zone re-derives
        the winning zone on the host in the same exact int micro-$ fixed
        point and the launch narrows to it, on a copy, never the cached
        schedule constraints. No votes, the kill switch off or a zone
        already pinned: the original constraints object."""
        soft = schedule.soft_affinity
        if not soft:
            return schedule.constraints
        cfg = self.solver_config
        zone = ops_policy.steer_zone(
            packing.instance_type_options, schedule.constraints.requirements,
            cfg.cost_config, cfg.policy_context, soft)
        if zone is None:
            return schedule.constraints
        steered = schedule.constraints.deepcopy()
        steered.requirements.items.append(NodeSelectorRequirement(
            key=wellknown.LABEL_TOPOLOGY_ZONE, operator="In", values=[zone]))
        SOFT_AFFINITY_STEERED_TOTAL.inc()
        return steered

    def _launch(self, constraints: Constraints, packing) -> Optional[str]:
        """Limits check + CloudProvider.create with the bind callback
        (provisioner.go:137-157)."""
        provisioner = self._engine().provisioner
        try:
            latest = self.kube.get("Provisioner", provisioner.metadata.name)
        except NotFound:
            return "provisioner deleted"
        err = provisioner.spec.limits.exceeded_by(latest.status.resources)
        if err is not None:
            return err
        pods_per_node = list(packing.pods)

        def bind(node: Node) -> Optional[str]:
            node.metadata.labels.update(constraints.labels)
            node.spec.taints.extend(constraints.taints)
            return self._bind(node, pods_per_node.pop(0) if pods_per_node else [])

        journal = self.journal
        if journal is None:
            errs = self.cloud_provider.create(constraints, packing.instance_type_options,
                                              packing.node_quantity, bind)
            errs = [e for e in errs if e]
            return "; ".join(errs) if errs else None
        # journaled fleet launch: the nonce is drawn and durable BEFORE the
        # provider create and pre-stamped onto the capacity it launches, so
        # a crash anywhere inside leaves instances recovery attributes
        nonce = jr.new_nonce()
        iid = journal.open_intent("fleet-launch", nonce=nonce,
                                  provisioner=provisioner.metadata.name,
                                  quantity=int(packing.node_quantity))
        with jr.preassigned_nonce(nonce):
            errs = self.cloud_provider.create(constraints, packing.instance_type_options,
                                              packing.node_quantity, bind)
        journal.advance(iid, "launched")
        errs = [e for e in errs if e]
        journal.close(iid, outcome="error" if errs else "done")
        return "; ".join(errs) if errs else None

    def _bind(self, node: Node, pods: List[Pod]) -> Optional[str]:
        """Create the node object (finalizer + not-ready taint) and bind
        pods (provisioner.go:159-198), in a ``bind`` span, timed in
        ``bind_duration_seconds`` with the window's trace id as exemplar."""
        provisioner = self._engine().provisioner
        t_bind = time.perf_counter()
        try:
            with obtrace.span("bind", node=node.metadata.name, pods=len(pods)):
                return self._bind_traced(node, pods, provisioner)
        finally:
            HISTOGRAMS.histogram("bind_duration_seconds").observe(
                time.perf_counter() - t_bind, exemplar=obtrace.current_trace_id(),
                provisioner=provisioner.metadata.name)

    def _bind_traced(self, node: Node, pods: List[Pod],
                     provisioner: Provisioner) -> Optional[str]:
        node.metadata.namespace = ""
        node.metadata.finalizers.append(wellknown.TERMINATION_FINALIZER)
        node.metadata.labels.setdefault(wellknown.PROVISIONER_NAME_LABEL,
                                        provisioner.metadata.name)
        # prevent the kube scheduler racing our binds (provisioner.go:164-176)
        node.spec.taints.append(Taint(key=wellknown.NOT_READY_TAINT_KEY, effect="NoSchedule"))
        journal = self.journal
        iid = None
        if journal is not None:
            iid = journal.open_intent(
                "bind", node=node.metadata.name, provider_id=node.spec.provider_id,
                pods=[f"{p.metadata.namespace}/{p.metadata.name}" for p in pods])
        try:
            self.kube.create(node)
        except AlreadyExists:
            pass  # self-registered first — idempotent (provisioner.go:177-186)
        except ApiError as e:
            # no Node object: the pods stay pending and re-enter the next
            # batch
            if iid is not None:
                journal.close(iid, outcome="error")
            return f"creating node object {node.metadata.name}: {e}"
        if iid is not None:
            journal.advance(iid, "node-created")
        # one locked pass for the node's whole pod set
        try:
            errs = self.kube.bind_pods(pods, node.metadata.name)
        except ApiError as e:
            errs = [str(e)] * len(pods)
        # an already-bound pod is success, not failure: a stale
        # provisionable read can re-batch a pod whose earlier bind landed,
        # and an error would relaunch capacity for it every window
        errs = [e for e in errs if "already bound" not in e and "already exists" not in e]
        for e in errs:
            log.error("failed to bind to %s: %s", node.metadata.name, e)
        log.info("bound %d pod(s) to node %s window_id=%s shard=%s",
                 len(pods) - len(errs), node.metadata.name, self._window_id,
                 self.shard or "0")
        # propagate instead of swallowing: the joined error surfaces through
        # CloudProvider.create → _launch → the provision loop's error log,
        # and the unbound pods remain provisionable for the next batch
        if errs:
            if iid is not None:
                journal.close(iid, outcome="error")
            return f"binding {len(errs)} pod(s) to {node.metadata.name}: " + "; ".join(errs)
        if iid is not None:
            journal.advance(iid, "bound")
            journal.close(iid)
        return None


class ProvisioningController:
    """Reconciles Provisioner CRs into workers (controller.go:44-128).

    ``shards=0`` (default): one worker per Provisioner, the reference's
    shape. ``shards=N``: N long-lived shard workers; each Provisioner's
    engine attaches to shard ``crc32(name) % N``. ``device`` (default: the
    CUDA device; ``"cpu"`` runs the plain versions) is resolved here, once,
    and every worker runs on it. ``journal`` is handed to every worker."""

    REQUEUE_SECONDS = 5 * 60  # catch zone/type drift (controller.go:82-83)

    def __init__(self, kube: KubeCore, cloud_provider: CloudProvider,
                 solver_config: Optional[SolverConfig] = None,
                 batcher_factory: Optional[Callable[[], Batcher]] = None,
                 pipeline_config: Optional[PipelineConfig] = None,
                 shards: int = 0, device: DeviceLike = None,
                 journal: Optional["jr.IntentJournal"] = None):
        self.device = resolve_device(device)
        self.journal = journal
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.solver_config = solver_config
        self.pipeline_config = pipeline_config
        self.batcher_factory = batcher_factory or Batcher
        self.shards = int(shards or 0)
        # one worker per provisioner name, or "shard-i" → worker
        self.workers: Dict[str, ProvisionerWorker] = {}
        self._hashes: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def kind(self) -> str:
        return "Provisioner"

    def targets(self) -> List[Tuple[Provisioner, ProvisionerWorker]]:
        """Routing snapshot for the selection controller: every hosted
        (provisioner, worker) pair, in worker-creation then engine-attach
        order (selection's first-match semantics depend on a stable
        order)."""
        with self._lock:
            workers = list(self.workers.values())
        return [(eng.provisioner, w) for w in workers for eng in w.engines()]

    def _new_worker(self, provisioner: Optional[Provisioner], shard: str = "") -> ProvisionerWorker:
        worker = ProvisionerWorker(
            provisioner, self.kube, self.cloud_provider, solver_config=self.solver_config,
            batcher=self.batcher_factory(), pipeline_config=self.pipeline_config,
            shard=shard, device=self.device, journal=self.journal)
        worker.start()
        return worker

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        try:
            provisioner = self.kube.get("Provisioner", name, namespace)
        except NotFound:
            with self._lock:
                self._hashes.pop(name, None)
                if self.shards > 0:
                    # the shard worker outlives any one tenant: detach the
                    # engine, keep the shard serving its other provisioners
                    w = self.workers.get(f"shard-{shard_of(name, self.shards)}")
                    if w is not None:
                        w.detach(name)
                    return None
                worker = self.workers.pop(name, None)
            if worker:
                worker.stop()
            return None
        if provisioner.metadata.deletion_timestamp is not None:
            return None

        # refresh the universe requirements from the live catalog
        catalog = self.cloud_provider.get_instance_types(provisioner.spec.constraints)
        provisioner.spec.constraints.requirements = (
            provisioner.spec.constraints.requirements.add(*global_requirements(catalog).items))

        key = _spec_hash(provisioner)
        with self._lock:
            if self._hashes.get(name) != key:
                if self.shards > 0:
                    # attach replaces the engine in place; the shard worker,
                    # its thread and its batcher survive the spec change
                    wname = f"shard-{shard_of(name, self.shards)}"
                    if wname not in self.workers:
                        self.workers[wname] = self._new_worker(
                            None, shard=str(shard_of(name, self.shards)))
                    self.workers[wname].attach(provisioner)
                else:
                    old = self.workers.get(name)
                    if old:
                        old.stop()
                    self.workers[name] = self._new_worker(provisioner)
                self._hashes[name] = key
        # conditions refresh on every reconcile, including the unchanged
        # steady state: the last executor moves between spec changes
        self._update_conditions(name, namespace)
        return float(self.REQUEUE_SECONDS)

    def _update_conditions(self, name: str, namespace: str) -> None:
        """Maintain the living status conditions (provisioner_status.go:38-49):
        ``Active`` and ``SolverHealthy``, the executor that answered last.
        The port has no device breaker (a device error raises), so
        ``SolverHealthy`` has no False state. The status write is skipped
        when nothing changed, so the refresh cannot loop on its own watch
        event."""
        executor = solver_health()["last_executor"]
        # executor name only, no volatile fields: the condition must compare
        # EQUAL between real state changes, or every reconcile writes status
        solver = ("True", "ExecutorRingsNominal",
                  f"last solve: executor={executor}" if executor else "no solves yet")

        def apply(p):
            now = time.time()
            changed = set_condition(p.status.conditions, "Active", "True", "WorkerRunning",
                                    "provisioner worker running", now=now)
            changed |= set_condition(p.status.conditions, "SolverHealthy", *solver, now=now)
            if not changed:
                raise _NoChange

        try:
            self.kube.patch("Provisioner", name, namespace, apply)
        except (_NoChange, NotFound):
            pass

    def stop_all(self, timeout: Optional[float] = None) -> None:
        """Stop every worker thread; with ``timeout``, wait up to that long
        for each to end."""
        with self._lock:
            workers = list(self.workers.values())
            self.workers.clear()
            self._hashes.clear()
        for w in workers:
            w.stop(timeout)


def _spec_hash(p: Provisioner) -> tuple:
    c = p.spec.constraints
    return (
        tuple(sorted((r.key, r.operator, tuple(sorted(r.values))) for r in c.requirements.items)),
        tuple(sorted((t.key, t.value, t.effect) for t in c.taints)),
        tuple(sorted(c.labels.items())),
        p.spec.ttl_seconds_after_empty,
        p.spec.ttl_seconds_until_expired,
    )
