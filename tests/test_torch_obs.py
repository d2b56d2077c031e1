"""The port's tracer and its observability of whole windows, against the
JAX package's, on the CPU.

**The tracer.** The same span program (window span, retroactive spans,
events, tags, a context carried to another thread) runs on both packages'
``obs/trace``; their ``chrome_events()`` must hold the same event names,
phases, tags and parent links once span ids, trace ids and times are left
out. The disabled path is the allocation-free singleton the JAX package's
own test (tests/test_obs.py) holds it to; the port's dump reads through
``tools/traceview.py``; with ``annotations=True`` every entered span, and
every ``utils/profiling.trace`` label, is a ``torch.profiler`` range.

**Differential windows.** The windows of tests/test_torch_controller.py
(its harness, ``run_worker`` and ``run_gang_worker``) and of
tests/test_torch_consolidation.py run with tracing and the SLO engine on in
both packages, each package's process-wide caches reset first. For every
series the port registers (the JAX package's families), the two packages'
deltas must be equal: each counter's delta, each gauge the window wrote
(which series, and their values) and each histogram's per-series count.
The span-name tree of each window must be equal, and so must the SLO
engine's sample count per (band, stage). Values that are times (histogram
sums, digests, span times) are not compared. Left out of the comparison,
each for a stated reason:

- the device ring's series and ``ring-*`` trace events, and the plane
  reuse counter: the JAX package fills the catalog planes, the global
  window's, the what-if window's and the gang window's inputs through its
  DeviceRing; the port keeps the planes resident on the device and copies
  those inputs directly, so its ring sees only the batched and solo
  solves. Each package's ring series equal its own
  counters (checked here for the port);
- ``solver_overlap_seconds_total`` (seconds) and
  ``solver_device_bytes_in_use`` (a device allocator's reading);
- the SLO gauges the engine publishes on its 1 s and 5 s timers (the
  quantiles, sample counts, burn rates): which values were published
  depends on when the records fell; the engine's own counts are compared
  instead.
"""

import functools
import gc
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from karpenter_tpu.metrics import registry as jax_registry
from karpenter_tpu.obs import slo as jax_slo
from karpenter_tpu.obs import trace as jax_trace
from karpenter_tpu_torch.metrics import registry as port_registry
from karpenter_tpu_torch.obs import slo as port_slo
from karpenter_tpu_torch.obs import trace as port_trace
from karpenter_tpu_torch.utils import profiling
from tests import test_torch_consolidation as consolidation
from tests import test_torch_controller as controller
from tools import traceview

TRACERS = (jax_trace, port_trace)


@pytest.fixture(autouse=True)
def fresh_tracers():
    for t in TRACERS:
        t.disable()
        t.reset()
    yield
    for t in TRACERS:
        t.disable()
        t.reset()


# -- the tracer ----------------------------------------------------------------


def span_program(trace):
    """One window's worth of tracer calls, the same on both packages."""
    trace.enable()
    t0 = time.perf_counter()
    with trace.window_span("provision", window_id="w-program", shard="0", pods=5):
        trace.add_span("intake", t0 - 0.5, t0 - 0.1, shard="0", window_s=0.4)
        with trace.span("feasibility", provisioner="default", pods=5):
            trace.event("ring-alloc", buffer="pods")
        t1 = time.perf_counter()
        trace.add_span("marshal", t1, t1 + 1e-4)
        ctx = trace.current_context()

        def fetch_side():
            # the fetch half of a handle: another thread, the same window
            with trace.use_context(ctx), trace.span("fetch", batched=2):
                trace.event("ring-refill", buffer="counts")

        th = threading.Thread(target=fetch_side)
        th.start()
        th.join()
        with trace.span("bind", node="n-1", pods=3) as sp:
            sp.tag(extra=1)
    trace.event("window-close", items=5, depth_left=0)
    with trace.span("orphan"):
        pass


def normalized(events):
    """Chrome events without ids and times: (name, phase, tags, parent
    name, whether it carries a trace id), sorted."""
    by_id = {e["args"]["span_id"]: e["name"] for e in events}
    out = []
    for e in events:
        args = dict(e["args"])
        parent = args.pop("parent_id", None)
        has_trace = args.pop("trace_id", None) is not None
        args.pop("span_id")
        out.append((e["name"], e["ph"], json.dumps(args, sort_keys=True),
                    by_id.get(parent), has_trace))
    return sorted(out)


class TestTracer:
    def test_chrome_events_equal_the_jax_tracer(self):
        got = {}
        for t in TRACERS:
            span_program(t)
            got[t] = normalized(t.chrome_events())
        assert got[port_trace] == got[jax_trace]
        names = [n for n, *_ in got[port_trace]]
        assert sorted(names) == sorted(["provision", "intake", "feasibility", "ring-alloc",
                                        "marshal", "fetch", "ring-refill", "bind",
                                        "window-close", "orphan"])
        parent = {n: p for n, _, _, p, _ in got[port_trace]}
        assert parent["fetch"] == parent["bind"] == parent["intake"] == "provision"
        assert parent["ring-refill"] == "fetch" and parent["window-close"] is None

    def test_context_carries_across_threads(self):
        port_trace.enable()
        seen = {}
        with port_trace.window_span("provision", window_id="w-ctx") as root:
            ctx = port_trace.current_context()

            def worker():
                seen["before"] = port_trace.current_trace_id()
                with port_trace.use_context(ctx), port_trace.span("fetch") as sp:
                    seen["span"] = (sp.trace_id, sp.parent_id)
                seen["after"] = port_trace.current_trace_id()

            th = threading.Thread(target=worker)
            th.start()
            th.join()
        assert seen == {"before": None, "span": ("w-ctx", root.span_id), "after": None}

    def test_window_ids_exist_with_tracing_off(self):
        assert not port_trace.enabled()
        a, b = port_trace.new_window_id(), port_trace.new_window_id()
        assert a != b and a.startswith("w-") and b.startswith("w-")
        assert port_trace.window_span("provision") is port_trace.span("x")
        assert port_trace.current_context() is None

    def test_disabled_path_allocates_nothing(self):
        """The JAX package's bound (tests/test_obs.py): disabled spans and
        events grow the heap by fewer than 100 blocks over 10,000 calls."""
        assert not port_trace.enabled()
        for _ in range(200):
            with port_trace.span("steady"):
                pass
            port_trace.event("steady")
        gc.collect()
        before = sys.getallocatedblocks()
        for _ in range(10_000):
            with port_trace.span("steady"):
                pass
            port_trace.event("steady")
        assert sys.getallocatedblocks() - before < 100

    def test_dump_reads_through_traceview(self, tmp_path):
        """The port's dump_chrome file: traceview finds the window, its
        stages and the SLO digest extra."""
        port_slo.reset()
        port_slo.record("default", "e2e", 0.5)
        span_program(port_trace)
        path = port_trace.dump_chrome(str(tmp_path / "trace.json"))
        dump = json.loads(open(path).read())
        assert dump["otherData"]["tracer"] == "karpenter_tpu_torch.obs.trace"
        assert dump["otherData"]["slo"]["stages"]["e2e"]["n"] == 1
        reports = traceview.analyze(dump["traceEvents"])
        assert [r["window"] for r in reports] == ["w-program"]
        assert reports[0]["kind"] == "provision"
        assert {"intake", "feasibility", "marshal", "fetch", "bind"} <= set(reports[0]["stages"])
        assert traceview.main([path]) == 0
        port_slo.reset()

    def test_measure_overhead_restores_state(self):
        out = port_trace.measure_overhead(n=2_000)
        assert set(out) == {"disabled_ns_per_span", "enabled_ns_per_span", "n"}
        assert not port_trace.enabled() and port_trace.snapshot() == []
        port_trace.enable(annotations=True)
        port_trace.measure_overhead(n=100)
        assert port_trace.state()["annotations"] is True and port_trace.enabled()

    def test_annotations_are_profiler_ranges(self):
        """With annotations on, every entered span is a record_function
        range in a torch.profiler session, and so is each profiling.trace
        label; retroactive spans enter none; with annotations off spans
        enter none either."""
        from torch.profiler import ProfilerActivity, profile

        def names(annotations):
            port_trace.reset()
            port_trace.enable(annotations=annotations)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with port_trace.window_span("provision", window_id="w-prof"):
                    with port_trace.span("fetch"):
                        torch.ones(4).sum()
                    with profiling.trace("karpenter.solve.batch_device"):
                        torch.ones(4).sum()
                    port_trace.add_span("device_solve", 0.0, 1.0)
            port_trace.disable()
            return {e.name for e in prof.events()}

        on = names(True)
        assert {"provision", "fetch", "karpenter.solve.batch_device"} <= on
        assert "device_solve" not in on
        off = names(False)
        assert "karpenter.solve.batch_device" in off and not {"provision", "fetch"} & off

    def test_an_error_inside_a_span_raises(self):
        """No fallback hides a fault: an error inside a traced span (a
        failed launch, copy or fetch) propagates, and the span still
        closes and restores the thread's context."""
        port_trace.enable(annotations=True)
        with pytest.raises(RuntimeError, match="device fault"):
            with port_trace.window_span("provision", window_id="w-err"):
                with port_trace.span("fetch"):
                    raise RuntimeError("device fault")
        assert port_trace.current_context() is None
        assert [s["name"] for s in port_trace.snapshot()] == ["provision", "fetch"]


# -- differential windows --------------------------------------------------------

RING_SERIES = ("pipeline_ring_allocations_total", "pipeline_ring_refills_total",
               "pipeline_ring_reuses_total", "filter_plane_ring_reuses_total")
TIMED_SERIES = ("solver_overlap_seconds_total", "solver_device_bytes_in_use",
                "slo_stage_latency_p50_seconds", "slo_stage_latency_p99_seconds",
                "slo_samples", "slo_burn_rate", "slo_burning_bands", "slo_burn_trips_total")


def reset_caches():
    """Both packages' process-wide caches that decide what a window
    computes: catalog indexes, masks and columns, packables, the marshal
    arena and catalog encodings, the ring, the intern table, the global
    support controller and the occupancy ledger."""
    from karpenter_tpu.ops import device_filter as jdf
    from karpenter_tpu.ops import encode as jenc
    from karpenter_tpu.ops import feasibility as jfeas
    from karpenter_tpu.ops import global_solve as jgops
    from karpenter_tpu.ops import policy as jpol
    from karpenter_tpu.ops import topology as jtopo
    from karpenter_tpu.solver import adapter as jad
    from karpenter_tpu.solver import pipeline as jpipe
    from karpenter_tpu_torch.ops import device_filter as pdf
    from karpenter_tpu_torch.ops import encode as penc
    from karpenter_tpu_torch.ops import feasibility as pfeas
    from karpenter_tpu_torch.ops import global_solve as pgops
    from karpenter_tpu_torch.ops import policy as ppol
    from karpenter_tpu_torch.ops import topology as ptopo
    from karpenter_tpu_torch.solver import adapter as pad
    from karpenter_tpu_torch.solver import pipeline as ppipe

    jdf.clear_caches()
    jpol.clear_caches()
    pdf.clear_affinity_cache()
    ppol.clear_caches()
    for feas, enc, ad, pipe, gops, topo in ((jfeas, jenc, jad, jpipe, jgops, jtopo),
                                            (pfeas, penc, pad, ppipe, pgops, ptopo)):
        feas.clear_catalog_caches()
        feas.reset_intern_table()
        enc.reset_marshal_arena()
        enc.clear_catalog_encoding_cache()
        with ad._packables_lock:
            ad._PACKABLES_CACHE.clear()
            ad._UNIVERSE_CACHE.clear()
        pipe.reset_ring()
        gops.SUPPORT.reset()
        topo.LEDGER.reset()


class Observed:
    """One package's window under observation: the registry before and
    after, every gauge write between, the spans and the SLO engine's cells.
    Tracing and SLO stamping are on for the window, both reset first."""

    def __init__(self, registry, trace, slo, monkeypatch):
        self.registry, self.trace, self.slo = registry, trace, slo
        self.writes = set()
        self.active = False
        gauge = registry.Gauge
        writes = self.writes

        def recording(method):
            @functools.wraps(method)
            def wrapped(g, *args, **labels):
                if self.active and not isinstance(g, registry.Counter):
                    writes.add((g.name, registry._lv(
                        {k: v for k, v in labels.items() if k != "amount"})))
                return method(g, *args, **labels)
            return wrapped

        monkeypatch.setattr(gauge, "set", recording(gauge.set))
        monkeypatch.setattr(gauge, "inc", recording(gauge.inc))

    def __enter__(self):
        self.trace.reset()
        self.trace.enable()
        self.slo.reset()
        self.slo.enable()
        self.before = self.registry.DEFAULT.snapshot()
        self.active = True
        return self

    def __exit__(self, *exc):
        self.active = False
        self.after = self.registry.DEFAULT.snapshot()
        self.spans = self.trace.snapshot()
        self.cells = {(band, stage): rep["n"]
                      for band, stages in self.slo.snapshot()["cells"].items()
                      for stage, rep in stages.items()}
        self.trace.disable()
        return False

    def counters(self, names):
        out = {}
        for name in names:
            b = self.before.get(name, {}).get("series", {})
            for labels, v in self.after.get(name, {}).get("series", {}).items():
                d = v - b.get(labels, 0.0)
                if d:
                    out[(name, labels)] = d
        return out

    def histograms(self, names):
        out = {}
        for name in names:
            b = self.before.get(name, {}).get("series", {})
            for labels, e in self.after.get(name, {}).get("series", {}).items():
                d = e["count"] - b.get(labels, {}).get("count", 0)
                if d:
                    out[(name, labels)] = d
        return out

    def gauges(self, names):
        series = {}
        for name in names:
            for labels, v in self.after.get(name, {}).get("series", {}).items():
                series[(name, labels)] = v
        wrote = {(n, port_registry._fmt(lv)) for n, lv in self.writes if n in names}
        return {k: series.get(k) for k in wrote}

    def span_tree(self):
        """The spans as name trees (children sorted), ring events left out."""
        spans = [s for s in self.spans if not s["name"].startswith("ring-")]
        ids = {s["span_id"] for s in spans}
        kids = {}
        for s in spans:
            kids.setdefault(s["parent_id"] if s["parent_id"] in ids else 0, []).append(s)

        def tree(s):
            return (s["name"], tuple(sorted(tree(c) for c in kids.get(s["span_id"], []))))

        return sorted(tree(s) for s in kids.get(0, []))


def families():
    """The port's registered series by kind (the JAX package's ported
    families, tests/test_torch_metrics.py holds them equal)."""
    reg = port_registry.DEFAULT.registered()
    hist = sorted(n for n, m in reg.items() if isinstance(m, port_registry.Histogram))
    counters = sorted(n for n, m in reg.items() if isinstance(m, port_registry.Counter))
    gauges = sorted(n for n, m in reg.items()
                    if n not in hist and n not in counters)
    skip = set(RING_SERIES) | set(TIMED_SERIES)
    return ([n for n in counters if n not in skip], [n for n in gauges if n not in skip],
            hist)


def observe_both(run_jax, run_port, monkeypatch):
    """Run the JAX window, then the port's, each observed; returns both
    observations and both results."""
    reset_caches()
    with Observed(jax_registry, jax_trace, jax_slo, monkeypatch) as oj:
        rj = run_jax()
    reset_caches()
    with Observed(port_registry, port_trace, port_slo, monkeypatch) as op:
        rp = run_port()
    return oj, op, rj, rp


def assert_same_observability(oj, op):
    counters, gauges, hist = families()
    assert op.counters(counters) == oj.counters(counters)
    assert op.gauges(gauges) == oj.gauges(gauges)
    assert op.histograms(hist) == oj.histograms(hist)
    assert op.span_tree() == oj.span_tree()
    assert op.cells == oj.cells
    # the port's ring series are its ring's counts
    ring = op.counters(RING_SERIES[:3])
    assert {k: v for k, v in ring.items()} == {
        (f"pipeline_ring_{k}_total", ""): v for k, v in op.ring_delta.items() if v}


@pytest.fixture()
def jax_device_gates(monkeypatch):
    """The JAX package's what-if and gang windows on its device path at any
    size (its defaults answer small windows with the host mirror), so both
    packages record the same dispatch spans."""
    from karpenter_tpu.controllers import consolidation as jcons
    from karpenter_tpu.controllers import provisioning as jprov
    from karpenter_tpu.solver.gang import GangConfig
    from karpenter_tpu.solver.whatif import WhatIfConfig

    init = jcons.ConsolidationController.__init__

    def cons_init(self, *args, **kwargs):
        kwargs.setdefault("whatif_config", WhatIfConfig(device_min_cells=0))
        init(self, *args, **kwargs)

    monkeypatch.setattr(jcons.ConsolidationController, "__init__", cons_init)
    winit = jprov.ProvisionerWorker.__init__

    def worker_init(self, *args, **kwargs):
        winit(self, *args, **kwargs)
        self.gang_config = GangConfig(device_min_cells=0)

    monkeypatch.setattr(jprov.ProvisionerWorker, "__init__", worker_init)


def with_ring(op_holder, fn):
    from karpenter_tpu_torch.solver import pipeline

    def run():
        before = pipeline.get_ring().counters()
        out = fn()
        after = pipeline.get_ring().counters()
        op_holder["ring"] = {k: after[k] - before[k] for k in ("allocations", "refills", "reuses")}
        return out
    return run


def differential(monkeypatch, run_jax, run_port):
    holder = {}
    oj, op, rj, rp = observe_both(run_jax, with_ring(holder, run_port), monkeypatch)
    op.ring_delta = holder["ring"]
    assert_same_observability(oj, op)
    return oj, op, rj, rp


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("seed", [7, 42])
def test_config12_window_observes_as_the_jax_controller(seed, depth, monkeypatch,
                                                        jax_device_gates):
    oj, op, (want, _), (got, worker) = differential(
        monkeypatch,
        lambda: controller.run_worker(controller.JAX, controller.config12_window(
            controller.JAX, seed), depth=depth, chunk_items=50),
        lambda: controller.run_worker(controller.PORT, controller.config12_window(
            controller.PORT, seed), depth=depth, chunk_items=50))
    assert got == want
    # one provision window of 200 pods in 4 chunks, stamped in every stage
    (root,) = [t for t in op.span_tree() if t[0] == "provision"]
    children = [c[0] for c in root[1]]
    assert children.count("device_solve") == children.count("launch_bind") == 4
    assert sum(op.cells[(b, "e2e")] for b, s in op.cells if s == "e2e") == 200
    assert worker.last_window["window_id"].startswith("w-")


@pytest.mark.parametrize("policy", ["interruption-priced"])
def test_affinity_window_observes_as_the_jax_controller(policy, monkeypatch, jax_device_gates):
    def run(pkg):
        return controller.run_worker(pkg, controller.pod_affinity_window(pkg, 1), depth=1,
                                     policy=policy, zones=True)

    oj, op, (want, _), (got, _) = differential(
        monkeypatch, lambda: run(controller.JAX), lambda: run(controller.PORT))
    assert controller.partition(got) == controller.partition(want)
    assert op.counters(["soft_affinity_terms_total"]) != {}


def test_gang_waves_observe_as_the_jax_controller(monkeypatch, jax_device_gates):
    oj, op, want, got = differential(
        monkeypatch,
        lambda: controller.run_gang_worker(controller.JAX, controller.gang_waves(controller.JAX)),
        lambda: controller.run_gang_worker(controller.PORT,
                                           controller.gang_waves(controller.PORT)))
    assert got[:2] == want[:2]
    counted = op.counters(["gang_windows_total", "gangs_placed_total",
                           "topology_carve_windows_total", "topology_carves_committed_total"])
    assert counted[("gangs_placed_total", "")] >= 3
    assert counted[("topology_carves_committed_total", "")] >= 1


def test_consolidation_window_observes_as_the_jax_controller(monkeypatch, jax_device_gates):
    # a float counter's delta depends on its base: both start at 0, so the
    # same increments give the same sums whatever earlier tests added
    for reg in (jax_registry, port_registry):
        reg.DEFAULT.registered()["consolidation_reclaimed_dollars_total"].delete()
    oj, op, (jr, jorder, _), (pr, porder, ctl) = differential(
        monkeypatch,
        lambda: consolidation.drained_in_order(consolidation.JAX, 7, "mixed", 8),
        lambda: consolidation.drained_in_order(consolidation.PORT, 7, "mixed", 8))
    assert (jr, jorder) == (pr, porder) and porder
    (root,) = [t for t in op.span_tree() if t[0] == "consolidate"]
    assert [c[0] for c in root[1]] == sorted(["gather", "encode", "dispatch", "fetch", "plan"])
    assert op.counters(["consolidation_drains_executed_total"]) == {
        ("consolidation_drains_executed_total", ""): float(len(porder))}
