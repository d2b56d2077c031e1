"""The port's SLO engine and flight recorder against the JAX package's.

``karpenter_tpu_torch/obs/slo.py`` and ``obs/flight.py`` are copies of the
JAX package's modules; these tests hold them to it on the CPU. Samples come
from numpy seeds, and every comparison is exact: the digests are built
from the same float samples by the same arithmetic, and the burn
sentinels run on an injected clock, so no value here is a wall time. Both
packages' SLO engines and flight recorders are process-wide: each test
resets both, and restores the objectives, the enabled flag and the dump
directory after itself.
"""

import json
import os
import threading

import numpy as np
import pytest

from karpenter_tpu.obs import flight as jax_flight
from karpenter_tpu.obs import slo as jax_slo
from karpenter_tpu_torch.metrics import slo as port_mslo
from karpenter_tpu_torch.obs import flight as port_flight
from karpenter_tpu_torch.obs import slo as port_slo

SEEDS = (1, 7, 42)
BOTH = ((jax_slo, jax_flight), (port_slo, port_flight))


@pytest.fixture(autouse=True)
def fresh_engines():
    """Both packages' SLO engines, sentinels and flight recorders empty,
    with no dump directory; restored the same way after the test."""
    def reset():
        for slo, flight in BOTH:
            slo.configure(enabled=True, objectives=slo.default_objectives(),
                          fast_window_s=60.0, slow_window_s=1800.0, fast_burn=6.0,
                          slow_burn=1.0, trip_interval_s=30.0)
            slo.reset()
            flight.configure(dir="", min_interval_s=5.0)
            flight.reset()

    reset()
    yield
    reset()


def samples(seed, n=2_000):
    """Latency-shaped samples in seconds: lognormal around 0.2 s, a few at
    or below the digest's zero bucket."""
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(mean=np.log(0.2), sigma=1.2, size=n)
    vals[rng.choice(n, size=n // 50, replace=False)] = 1e-7
    return [float(v) for v in vals]


QUANTILES = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


class TestDigest:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("max_bins", [1024, 16])
    def test_quantiles_equal_the_jax_digest(self, seed, max_bins):
        """Same samples, same alpha and bin cap: equal quantiles, report and
        serialized state (exact); 16 bins forces the low-bucket collapse."""
        vals = samples(seed)
        dj, dp = jax_slo.Digest(max_bins=max_bins), port_slo.Digest(max_bins=max_bins)
        for v in vals:
            dj.record(v)
            dp.record(v)
        assert [dp.quantile(q) for q in QUANTILES] == [dj.quantile(q) for q in QUANTILES]
        assert dp.report() == dj.report()
        assert dp.to_dict() == dj.to_dict()
        assert dp.bins() == dj.bins() <= max_bins

    @pytest.mark.parametrize("seed", SEEDS)
    def test_merges_and_weighted_records_equal(self, seed):
        """Three shards merged (and one weighted record_n per value) equal
        the JAX package's; a digest round-trips through to_dict."""
        vals = samples(seed, n=900)
        rng = np.random.default_rng(seed + 100)
        weights = rng.integers(1, 9, size=len(vals))
        out = {}
        for slo in (jax_slo, port_slo):
            shards = [slo.Digest() for _ in range(3)]
            for i, v in enumerate(vals):
                shards[i % 3].record_n(v, int(weights[i]))
            merged = slo.Digest.merged(shards)
            back = slo.Digest.from_dict(merged.to_dict())
            out[slo] = (merged.to_dict(), [merged.quantile(q) for q in QUANTILES],
                        back.to_dict(), merged.mean())
        assert out[port_slo] == out[jax_slo]
        with pytest.raises(ValueError):
            port_slo.Digest(alpha=0.01).merge(port_slo.Digest(alpha=0.02))


class TestEngine:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_snapshot_equals_the_jax_engine(self, seed):
        """Random (band, stage, seconds, count) records on both engines: the
        same snapshot, stage merges and counts; merge_from folds shards."""
        rng = np.random.default_rng(seed)
        bands = ("system-critical", "high", "default", "low")
        recs = [(bands[rng.integers(len(bands))], port_slo.STAGES[rng.integers(5)],
                 float(rng.lognormal(np.log(0.5), 1.0)), int(rng.integers(1, 5)))
                for _ in range(600)]
        snaps = {}
        for slo in (jax_slo, port_slo):
            a, b = slo.SloEngine(), slo.SloEngine()
            for i, (band, stage, sec, cnt) in enumerate(recs):
                (a if i % 2 else b).record(band, stage, sec, cnt)
            a.merge_from(b)
            snaps[slo] = (a.snapshot(), a.records_total(), a.cell_count(), a.total_bins(),
                          a.stage_digest("e2e").to_dict())
        assert snaps[port_slo] == snaps[jax_slo]
        assert snaps[port_slo][1] == sum(c for *_, c in recs)


class Clock:
    def __init__(self, t=10_000.0):
        self.t = t

    def __call__(self):
        return self.t


class TestBurnSentinel:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_evaluate_and_trips_equal_the_jax_sentinel(self, seed):
        """The same e2e samples and sheds on an injected clock: every
        evaluate() output, the burning set, the trip count and the flight
        recorder's slo-burn records (tags) are the JAX package's."""
        rng = np.random.default_rng(seed)
        steps = [(float(rng.uniform(0.5, 20.0)), bool(rng.random() < 0.1),
                  str(rng.choice(["high", "default", "low"])), float(rng.lognormal(0.0, 1.5)))
                 for _ in range(400)]
        outs = {}
        for slo, flight in BOTH:
            clock = Clock()
            sentinel = slo.BurnSentinel(
                objectives={"high": slo.Objective(2.0), "default": slo.Objective(5.0, 0.9)},
                fast_window_s=60.0, slow_window_s=600.0, timefunc=clock)
            evals = []
            for i, (dt, shed, band, sec) in enumerate(steps):
                clock.t += dt
                if shed:
                    sentinel.observe(band, shed=True)
                else:
                    sentinel.observe(band, sec)
                if i % 10 == 9:
                    evals.append(sentinel.evaluate())
            trips = [(r["trigger"], r["tags"]) for r in flight.recent(256)]
            outs[slo] = (evals, sentinel.burning(), sentinel.trips_total(),
                         sentinel.breaches_total(), sentinel.state(), trips)
        assert outs[port_slo] == outs[jax_slo]
        assert outs[port_slo][2] >= 1, "the seeds must make a band burn"
        assert all(t == "slo-burn" for t, _ in outs[port_slo][5])

    def test_a_burn_storm_writes_one_dump(self, tmp_path):
        """A band breaching on every sample, evaluated again and again inside
        the trip interval and the flight recorder's rate limit: exactly one
        slo-burn dump, tagged with the band, in both packages."""
        for slo, flight in BOTH:
            d = tmp_path / slo.__name__.split(".")[0]
            flight.configure(dir=str(d))
            slo.configure(enabled=True, objectives={"default": slo.Objective(0.001)})
            for _ in range(200):
                slo.record("default", "e2e", 0.25)
                slo.evaluate()
            dumps = sorted(os.listdir(d))
            assert len(dumps) == 1 and dumps[0].endswith("-slo-burn.json"), dumps
            payload = json.loads((d / dumps[0]).read_text())
            assert payload["trigger"] == "slo-burn"
            assert payload["tags"]["band"] == "default" and payload["tags"]["stage"] == "e2e"
            assert slo.burning() == ["default"] and slo.trips_total() == 1
        # the port's burn series: breaches and the burning gauge
        assert port_mslo.SLO_BURNING_BANDS.collect()[()] == 1.0
        assert port_mslo.SLO_BURN_TRIPS.collect()[()] == 1.0


class TestModuleApi:
    def test_record_calls_snapshot_and_state_equal_the_jax_module(self):
        """The module-level API on the same calls: record_calls counts one
        per call (a weighted record is one), and snapshot() and the engine
        part of state() are the JAX package's."""
        for slo, _ in BOTH:
            slo.record("default", "intake", 0.5)
            slo.record("default", "schedule", 0.25, count=40)
            slo.record("high", "e2e", 1.5)
            slo.note_shed("low")
        assert port_slo.record_calls() == jax_slo.record_calls() == 3
        assert port_slo.snapshot() == jax_slo.snapshot()
        assert port_slo.state()["engine"] == jax_slo.state()["engine"]
        assert port_slo.state()["burn"]["objectives"] == jax_slo.state()["burn"]["objectives"]

    def test_disabled_records_nothing(self):
        port_slo.disable()
        port_slo.record("default", "e2e", 1.0)
        port_slo.note_shed("default")
        assert port_slo.record_calls() == 0 and port_slo.snapshot()["records"] == 0

    def test_marks_carry_across_threads(self):
        """use_marks reinstates a window's marks on another thread (the
        fetch half of a handle) and restores the thread's own after."""
        marks = port_slo.WindowMarks(t_close=1.0, meta={1: ("default", 0.5)})
        seen = []

        def fetch_side():
            seen.append(port_slo.current_marks())
            with port_slo.use_marks(marks):
                seen.append(port_slo.current_marks())
            seen.append(port_slo.current_marks())

        t = threading.Thread(target=fetch_side)
        t.start()
        t.join()
        assert seen == [None, marks, None]
        with port_slo.use_marks(None):
            assert port_slo.current_marks() is None

    def test_measure_overhead_keeps_the_live_digests(self):
        """The probe records go to scratch digests; as in the JAX package
        its enabled loop still counts in record_calls."""
        for slo, _ in BOTH:
            slo.record("default", "e2e", 0.5)
            out = slo.measure_overhead(n=500)
            assert set(out) == {"disabled_ns_per_record", "enabled_ns_per_record", "n"}
            assert out["n"] == 500.0 and slo.snapshot()["records"] == 1
        assert port_slo.record_calls() == jax_slo.record_calls() == 501

    def test_objectives_are_published(self):
        port_slo.configure(objectives={"default": port_slo.Objective(12.5)})
        assert port_mslo.SLO_OBJECTIVE.collect()[(("band", "default"),)] == 12.5


class TestFlightRecorder:
    def test_trip_without_dir_stays_in_memory(self):
        assert port_flight.trip("pressure-l3", from_level=1) is None
        rec = port_flight.recent()[-1]
        assert rec["trigger"] == "pressure-l3" and rec["tags"] == {"from_level": 1}
        state = port_flight.state()
        assert state["trips"] == 1 and state["dumps_written"] == 0 and state["dir"] is None

    def test_trip_with_dir_writes_a_tagged_dump(self, tmp_path):
        from karpenter_tpu_torch.obs import trace

        port_flight.configure(dir=str(tmp_path), min_interval_s=0.0)
        trace.enable()
        try:
            with trace.window_span("provision", window_id="w-flight"):
                with trace.span("fetch"):
                    pass
                path = port_flight.trip("pressure-l3", from_level=2, intake_depth=7)
        finally:
            trace.disable()
            trace.reset()
        assert path is not None and path.endswith("-pressure-l3.json")
        payload = json.loads(open(path).read())
        assert payload["trigger"] == "pressure-l3"
        assert payload["tags"] == {"from_level": 2, "intake_depth": 7, "trace_id": "w-flight"}
        assert any(e.get("name") == "fetch" for e in payload["events"])
        assert port_flight.recent_dumps() == [path]

    def test_rate_limit_suppresses_the_dump_not_the_record(self, tmp_path):
        port_flight.configure(dir=str(tmp_path), min_interval_s=3600.0)
        first = port_flight.trip("pressure-l3", from_level=0)
        second = port_flight.trip("pressure-l3", from_level=1)
        # slo-burn runs on its own clock: a pressure dump does not starve it
        burn = port_flight.trip("slo-burn", band="default")
        assert first is not None and second is None and burn is not None
        assert [r["tags"].get("from_level") for r in port_flight.recent()] == [0, 1, None]
        assert len(os.listdir(tmp_path)) == 2

    @pytest.mark.parametrize("uptime", [0.5, 30.0])
    def test_first_trip_dumps_on_a_freshly_booted_host(self, tmp_path, monkeypatch, uptime):
        """time.monotonic() is the host's uptime on Linux: with the clock
        pinned under the interval, the first trip of each trigger still
        dumps and the next one inside the interval does not; reset()
        restores the never-dumped state."""
        monkeypatch.setattr(port_flight.time, "monotonic", lambda: uptime)
        port_flight.configure(dir=str(tmp_path), min_interval_s=60.0)
        assert port_flight.trip("pressure-l3", from_level=0) is not None
        assert port_flight.trip("slo-burn", band="default") is not None
        assert port_flight.trip("pressure-l3", from_level=1) is None
        port_flight.reset()
        # the trip count restarts too, so the dump reuses the first name
        assert port_flight.trip("pressure-l3", from_level=2) is not None
        assert sorted(os.listdir(tmp_path)) == ["flight-00001-pressure-l3.json",
                                                "flight-00002-slo-burn.json"]

    def test_a_failed_write_keeps_the_trip(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        port_flight.configure(dir=str(blocker / "sub"), min_interval_s=0.0)
        assert port_flight.trip("pressure-l3") is None
        assert port_flight.state()["trips"] == 1

    def test_pressure_monitor_trips_on_entering_l3(self, tmp_path):
        """A monitor driven into L3 by its intake depth trips pressure-l3
        once, tagged with the rung it rose from and the depth."""
        from karpenter_tpu_torch.pressure import PressureConfig, PressureMonitor

        port_flight.configure(dir=str(tmp_path), min_interval_s=0.0)
        monitor = PressureMonitor(PressureConfig(max_depth=1000, rss_watermark_bytes=0))
        monitor.note_depth(1, 300)
        assert int(monitor.level()) == 1
        monitor.note_depth(1, 900)
        assert int(monitor.level()) == 3
        monitor.note_depth(1, 950)
        dumps = sorted(os.listdir(tmp_path))
        assert len(dumps) == 1 and dumps[0].endswith("-pressure-l3.json")
        tags = json.loads((tmp_path / dumps[0]).read_text())["tags"]
        assert tags == {"from_level": 1, "intake_depth": 900}
