"""Controller-plane entrypoint.

Reference: cmd/controller/main.go — builds the cloud provider via the
registry, wires the controllers into the manager, and serves /metrics,
/healthz, /readyz and /debug/vars. Run as
``python -m karpenter_tpu_torch.main``; the flags are config/options.py's.

The JAX package's ``karpenter_tpu/main.py``, with the same eleven
controllers (the reference's eight, plus consolidation, capacity GC and
logging-config), the journal replayed before the manager starts, and the
same exit codes: 0 on SIGTERM, 1 on bad options, on a failed boot and on
lost leadership. ``--kube-backend memory`` (the default) runs against the
in-memory store; ``in-cluster`` against the API server named by
``KUBERNETES_SERVICE_HOST`` / ``KUBERNETES_SERVICE_PORT``, with the service
account's token and CA (runtime/kubeclient.py): without that environment
the boot fails. Differences: the solver runs on ``--device`` (by default
the mesh of every visible card, parallel/mesh.py); ``--solver-warmup`` runs before any controller starts and a
warm-up failure fails the boot; the jax.profiler server is not part of
this process. ``--cloud-provider aws`` builds the EC2 and SSM clients from
the ambient environment (cloudprovider/aws/awsclient.py: region from
``AWS_REGION`` or IMDS, the credential chain).
"""

from __future__ import annotations

import json
import logging
import signal
import socket
import sys
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

from karpenter_tpu_torch import pressure
from karpenter_tpu_torch.cloudprovider import spi
from karpenter_tpu_torch.cloudprovider.fake import provider as _fake  # noqa: F401 — registers "fake"
from karpenter_tpu_torch.cloudprovider.metrics import decorate
from karpenter_tpu_torch.config.options import Options, parse
from karpenter_tpu_torch.controllers.consolidation import ConsolidationController
from karpenter_tpu_torch.controllers.counter import CounterController
from karpenter_tpu_torch.controllers.gc import GarbageCollection
from karpenter_tpu_torch.controllers.logging_config import LoggingConfigController
from karpenter_tpu_torch.controllers.metrics_controllers import (
    NodeMetricsController, PodMetricsController,
)
from karpenter_tpu_torch.controllers.node import NodeController
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.pvc import PVCController
from karpenter_tpu_torch.controllers.recovery import RecoveryController
from karpenter_tpu_torch.controllers.selection import SelectionController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.metrics import registry
from karpenter_tpu_torch.obs import flight, slo, trace
from karpenter_tpu_torch.runtime.journal import IntentJournal
from karpenter_tpu_torch.runtime.kubeclient import KubeApiClient
from karpenter_tpu_torch.runtime.kubecore import KubeCore
from karpenter_tpu_torch.runtime.leaderelection import LeaderElector
from karpenter_tpu_torch.runtime.manager import Manager
from karpenter_tpu_torch.scheduling.batcher import Batcher
from karpenter_tpu_torch.solver import pipeline
from karpenter_tpu_torch.solver import warmup as solver_warmup
from karpenter_tpu_torch.solver.pipeline import PipelineConfig
from karpenter_tpu_torch.solver.policy import PolicyContext
from karpenter_tpu_torch.solver.solve import SolverConfig, solver_health
from karpenter_tpu_torch.utils.workers import adaptive_workers

log = logging.getLogger("karpenter")


def build_cloud_provider(options: Options):
    """Resolve the provider from the registry and wrap it in the metrics
    decorator, so every SPI call feeds ``cloudprovider_duration_seconds``
    (cmd/controller/main.go:76-77). The AWS provider needs its EC2 and SSM
    clients built first."""
    if options.cloud_provider == "aws":
        import karpenter_tpu_torch.cloudprovider.aws  # noqa: F401 — registers "aws"
        from karpenter_tpu_torch.cloudprovider.aws import sdk as aws_sdk

        ec2api, ssmapi = aws_sdk.default_clients()
        return decorate(spi.resolve(
            "aws", ec2api=ec2api, ssmapi=ssmapi,
            cluster_name=options.cluster_name,
            cluster_endpoint=options.cluster_endpoint,
            eni_limited_pod_density=options.aws_eni_limited_pod_density,
            node_name_convention=options.aws_node_name_convention))
    return decorate(spi.resolve(options.cloud_provider))


def build_manager(kube: Union[KubeCore, KubeApiClient], options: Options) -> Manager:
    """Register the controllers: the reference's eight
    (cmd/controller/main.go:89-98) plus consolidation, GC and
    logging-config. With ``--solver-warmup`` the libraries are built and
    the bucket ladder launched here, before any controller exists; an
    error raises."""
    cloud_provider = build_cloud_provider(options)
    # the brownout ladder is installed before any batcher exists, so every
    # admission decision sees the configured rungs
    pressure.configure(pressure.PressureConfig(
        enabled=options.pressure_enabled,
        max_depth=options.pressure_max_depth,
        rss_watermark_bytes=options.pressure_rss_watermark_mb * 1024 ** 2,
        dwell_seconds=options.pressure_dwell_seconds,
        split_items=options.pressure_split_items,
        aging_step_seconds=options.pressure_aging_seconds))
    solver_warmup.configure_compilation_cache(options.solver_compile_cache_dir)
    solver_config = SolverConfig(
        device_donate=options.solver_donate, packing_policy=options.packing_policy,
        window_backend=options.window_backend,
        policy_context=PolicyContext(repack_cost_per_hour=options.policy_repack_cost))
    if options.solver_warmup:
        solver_warmup.warmup_pass(solver_config, include_ring=options.solver_donate,
                                  device=options.device)
    # crash consistency: the intent journal and startup recovery exist
    # before any controller, so every multi-step mutation is journaled from
    # the first window; main() runs recovery.run() before manager.start()
    # and /readyz answers 503 "recovering" until the replay completes
    journal = recovery = None
    if options.journal_dir:
        journal = IntentJournal(options.journal_dir, fsync=options.journal_fsync)
        recovery = RecoveryController(kube, cloud_provider, journal)
    provisioning = ProvisioningController(
        kube, cloud_provider, journal=journal, solver_config=solver_config,
        pipeline_config=PipelineConfig(depth=options.pipeline_depth,
                                       chunk_items=options.pipeline_chunk_items,
                                       adaptive=options.pipeline_adaptive),
        batcher_factory=lambda: Batcher(idle_seconds=options.batch_idle_seconds,
                                        max_seconds=options.batch_max_seconds,
                                        max_items=options.batch_max_items,
                                        max_depth=options.pressure_max_depth),
        # horizontal shards: N long-lived intake/solve workers with
        # provisioners hashed across them; 0 keeps one worker a Provisioner
        shards=options.provisioning_shards, device=options.device)
    manager = Manager(kube)
    manager.register(provisioning)
    # worker pools are clamped to the host's cores (utils/workers.py)
    manager.register(SelectionController(kube, provisioning), workers=adaptive_workers(64))
    manager.register(NodeController(kube), workers=adaptive_workers(10))
    manager.register(TerminationController(kube, cloud_provider, journal=journal),
                     workers=adaptive_workers(10))
    manager.register(CounterController(kube))
    if options.gc_interval_seconds > 0:
        manager.register(GarbageCollection(
            kube, cloud_provider, interval_seconds=options.gc_interval_seconds,
            grace_seconds=options.gc_grace_seconds, journal=journal))
    manager.register(ConsolidationController(
        kube, provider=cloud_provider, journal=journal, device=options.device,
        # spot keep-cost premium: only the interruption-priced policy
        # charges reclaim risk into the ranking
        repack_cost_per_hour=(options.policy_repack_cost
                              if options.packing_policy == "interruption-priced" else 0.0)))
    manager.register(PVCController(kube))
    manager.register(NodeMetricsController(kube))
    manager.register(PodMetricsController(kube))
    # live log-level reload from config-logging in the controller's own
    # namespace (cmd/controller/main.go:105-117)
    manager.register(LoggingConfigController(kube, namespace=options.namespace))
    manager.journal = journal
    manager.recovery = recovery
    return manager


def debug_vars() -> dict:
    """The /debug/vars payload: one JSON snapshot of the process's ledgers —
    metric series, pressure signals, solver executor counts, device-ring
    counters, tracer, flight-recorder and SLO state."""
    ring = pipeline._RING  # peek: a GET never allocates device memory
    return {
        "metrics": registry.DEFAULT.snapshot(),
        "pressure": pressure.get_monitor().signals(),
        "solver": solver_health(),
        "ring": ring.counters() if ring is not None else None,
        "trace": trace.state(),
        "flight": flight.state(),
        "slo": slo.state(),
    }


class _Handler(BaseHTTPRequestHandler):
    manager: Optional[Manager] = None
    recovery = None  # RecoveryController when --journal-dir is set

    def do_GET(self):
        if self.path == "/metrics":
            body = registry.DEFAULT.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
        elif self.path == "/debug/vars":
            body = json.dumps(debug_vars(), indent=2, default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path in ("/healthz", "/readyz"):
            ok = self.manager is None or self.manager.healthz()
            level = int(pressure.get_monitor().level())
            suffix = ""
            if self.path == "/readyz":
                if self.recovery is not None and self.recovery.recovering():
                    # journal replay in progress: serving windows now could
                    # double-act on the predecessor's open intents
                    ok = False
                    suffix = " recovering"
                if level >= 3:
                    # L3 = system-critical only: stop advertising readiness
                    # (liveness stays green; a restart would make it worse)
                    ok = False
                burning = slo.burning()
                if burning:
                    # sustained SLO burn: the replica is falling behind its
                    # latency objectives
                    ok = False
                    suffix += f" slo-burn={','.join(burning)}"
            body = f"{'ok' if ok else 'unhealthy'} level=L{level}{suffix}".encode()
            self.send_response(200 if ok else 503)
            self.send_header("Content-Type", "text/plain")
        else:
            body = b"not found"
            self.send_response(404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


def serve_observability(manager: Manager, port: int) -> ThreadingHTTPServer:
    """Serve the four endpoints on ``port`` from a daemon thread."""
    handler = type("Handler", (_Handler,),
                   {"manager": manager, "recovery": getattr(manager, "recovery", None)})
    server = ThreadingHTTPServer(("0.0.0.0", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True, name="observability").start()
    return server


def main(argv=None, terminate: Optional[threading.Event] = None) -> int:
    """Run the controller process until SIGTERM (rc 0) or lost leadership
    (rc 1); bad options or a failed boot return 1 at once. ``terminate``,
    when given, acts as SIGTERM does: a caller that runs main() off the
    main thread, where no signal handler can be installed, stops it so."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    options = parse(argv)
    errs = options.validate()
    if errs:
        for e in errs:
            log.error("invalid options: %s", e)
        return 1
    if options.kube_backend == "in-cluster":
        try:
            kube = KubeApiClient.in_cluster(qps=options.kube_client_qps,
                                            burst=options.kube_client_burst)
        except (KeyError, OSError) as e:  # no service account environment
            log.error("boot failed: no in-cluster API server: %r", e)
            return 1
    else:
        kube = KubeCore()
    # observability before any controller runs: the tracer and the flight
    # recorder must see the first window
    if options.trace_enabled:
        trace.enable(annotations=options.trace_annotations)
    if options.flight_dir:
        flight.configure(dir=options.flight_dir)
    objectives = None
    if options.slo_objectives:
        objectives = {band: slo.Objective(threshold_s=t, target=tgt)
                      for band, (t, tgt) in options.parse_slo_objectives().items()}
    slo.configure(enabled=options.slo_enabled, objectives=objectives,
                  fast_window_s=options.slo_fast_window_seconds,
                  slow_window_s=options.slo_slow_window_seconds,
                  fast_burn=options.slo_fast_burn, slow_burn=options.slo_slow_burn)
    try:
        manager = build_manager(kube, options)
    except Exception:  # a broken card, build or warm-up fails the boot
        log.exception("boot failed")
        return 1
    server = serve_observability(manager, options.metrics_port)

    elector = None
    stopping = threading.Event()
    terminated = threading.Event()

    def _on_terminate(*_):
        terminated.set()
        stopping.set()

    # Kubernetes stops pods with SIGTERM; without a handler the process dies
    # before elector.stop() releases the Lease
    try:
        signal.signal(signal.SIGTERM, _on_terminate)
    except ValueError:  # not the main thread
        pass
    if terminate is not None:
        threading.Thread(target=lambda: (terminate.wait(), _on_terminate()),
                         daemon=True, name="terminate").start()
    if options.leader_elect:
        # single writer (cmd/controller/main.go:80-81): campaign before
        # starting controllers; losing the lease means exit and restart
        elector = LeaderElector(kube, identity=f"{socket.gethostname()}-{uuid.uuid4().hex[:6]}",
                                namespace=options.namespace, on_stopped_leading=stopping.set)
        elector.start()
        log.info("campaigning for leadership")
        # interrupt=stopping: a SIGTERM while standing by breaks the wait
        elector.wait_for_leadership(interrupt=stopping)
    try:
        if not stopping.is_set():
            # replay the intent journal BEFORE any controller runs: open
            # intents of a crashed predecessor are rolled forward or back
            # while /readyz answers 503 recovering
            recovery = getattr(manager, "recovery", None)
            if recovery is not None:
                log.info("journal recovery: %s", recovery.run())
            manager.start()
            log.info("karpenter-tpu started (cluster=%s, device=%s, metrics=:%d)",
                     options.cluster_name, options.device, server.server_address[1])
            stopping.wait()
    except KeyboardInterrupt:
        pass
    finally:
        manager.stop()
        if elector is not None:
            elector.stop()
        if isinstance(kube, KubeApiClient):
            kube.stop_watches()
        server.shutdown()
        server.server_close()
        if options.trace_dump:
            try:
                trace.dump_chrome(options.trace_dump)
                log.info("trace dump written to %s", options.trace_dump)
            except OSError as e:  # a debug knob: never fails the exit
                log.warning("trace dump failed: %s", e)
    # SIGTERM (a rollout) is a clean exit; stopping WITHOUT it means lost
    # leadership: nonzero, so the orchestrator restarts and re-campaigns
    return 1 if stopping.is_set() and not terminated.is_set() else 0


if __name__ == "__main__":
    sys.exit(main())
