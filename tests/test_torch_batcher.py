"""The port's batcher, solve pipeline and pressure ladder against the JAX
package's, and alone.

**Differential:** the same seeded stream of adds (keys, bands, priorities
and gang memberships drawn from ``random.Random``) goes into the JAX
package's ``Batcher`` and the port's, each with a monitor held at one
level; every window both return (the items, in order), the shed counts and
the keys still pending must be equal, exactly. The same chunk sequences go
through both packages' ``SolvePipeline`` with counting fake handles, at
each pressure level and with a stage failing: the consumed outputs, the
fetches per handle and the largest number of handles in flight must be
equal.

**Alone:** window timing (idle, max, item cap, gate, stop), the depth
bound and system-critical displacement, the gang hold (incomplete, TTL,
oversize, never split at the cap), the pressure monitor's rise, one-rung
fall per dwell, thresholds and burst guard, and the adaptive depth.
"""

import random
import threading
import time

import pytest

from karpenter_tpu.pressure import monitor as jax_monitor
from karpenter_tpu.scheduling import batcher as jax_batcher
from karpenter_tpu.solver import pipeline as jax_pipeline
from karpenter_tpu_torch.pressure import bands as port_bands
from karpenter_tpu_torch.pressure import monitor as port_monitor
from karpenter_tpu_torch.scheduling import batcher as port_batcher
from karpenter_tpu_torch.solver import pipeline as port_pipeline

BANDS = ("system-critical", "high", "default", "low", "besteffort")


class HeldMonitor:
    """A monitor held at one level with a real config of either package."""

    def __init__(self, monitor_mod, level=0, **config):
        self.config = monitor_mod.PressureConfig(**config)
        self._level = level

    def level(self):
        return self._level

    def note_depth(self, source, depth):
        pass

    def note_window(self, seconds):
        pass

    def forget_source(self, source):
        pass


def stream(seed, n=120):
    """``n`` adds: (item, key, band, priority, gang) with a few gangs, some
    complete, some not, and a repeated key now and then."""
    rng = random.Random(seed)
    adds = []
    gangs = {f"g{i}": rng.choice((2, 3, 4)) for i in range(6)}
    members = {g: 0 for g in gangs}
    for i in range(n):
        band = rng.choice(BANDS)
        priority = rng.randint(-5, 5)
        gang = None
        if rng.random() < 0.25:
            g = rng.choice(sorted(gangs))
            # gang g4 never completes: it keeps one member short
            if members[g] < gangs[g] - (1 if g == "g4" else 0):
                members[g] += 1
                gang = (("default", g), gangs[g])
        name = f"p{i:03d}" if rng.random() < 0.95 else f"p{rng.randrange(max(i, 1)):03d}"
        adds.append((f"item-{i}", ("default", name), band, priority, gang))
    return adds


def run_batcher(batcher_mod, monitor_mod, adds, level, max_items):
    b = batcher_mod.Batcher(idle_seconds=0.001, max_seconds=0.05, max_items=max_items,
                            max_depth=100, monitor=HeldMonitor(monitor_mod, level))
    gates = [b.add(item, key=key, band=band, priority=prio, gang=gang)
             for item, key, band, prio, gang in adds]
    windows = []
    while b.depth() and len(windows) < 20:
        items, _ = b.wait()
        if not items:
            break
        windows.append(items)
        b.flush()
    pending = sorted(key for _, key, *_ in adds if b.contains(key))
    b.stop()
    return windows, dict(b.shed), [g is None for g in gates], pending, b.added_total


@pytest.mark.parametrize("level", [0, 2, 3])
@pytest.mark.parametrize("seed", [1, 7, 42])
def test_windows_match_the_jax_batcher(seed, level):
    adds = stream(seed)
    want = run_batcher(jax_batcher, jax_monitor, adds, level, max_items=25)
    got = run_batcher(port_batcher, port_monitor, adds, level, max_items=25)
    assert got == want
    windows = got[0]
    assert windows and all(len(w) <= 25 for w in windows)


class CountingHandle:
    def __init__(self, results, tracker, boom=False):
        self._results = results
        self._tracker = tracker
        self._boom = boom
        self.fetches = 0

    def fetch(self):
        self.fetches += 1
        self._tracker["now"] -= 1
        if self._boom:
            raise RuntimeError("fetch failed")
        return self._results


def run_pipeline(pipeline_mod, level, depth, fail):
    """Six chunks through a pipeline at ``level``; ``fail`` names the stage
    that raises on chunk 2 ("fetch", "consume" or None)."""
    tracker = {"now": 0, "max": 0}
    handles, consumed, observed = [], [], []

    def dispatch(prep):
        tracker["now"] += 1
        tracker["max"] = max(tracker["max"], tracker["now"])
        handles.append(CountingHandle([prep * 10], tracker, boom=fail == "fetch" and prep == 2))
        return handles[-1]

    def consume(prep, results):
        consumed.append(prep)
        if fail == "consume" and prep == 2:
            raise ValueError("bind failed")
        return results[0]

    pipe = pipeline_mod.SolvePipeline(
        pipeline_mod.PipelineConfig(depth=depth, chunk_items=0, adaptive=False),
        monitor=HeldMonitor(jax_monitor if pipeline_mod is jax_pipeline else port_monitor, level))
    error = None
    outs = None
    try:
        outs = pipe.run(list(range(6)), prepare=lambda c: c, dispatch=dispatch,
                        consume=consume, on_chunk=lambda prep, stats: observed.append(prep))
    except (RuntimeError, ValueError) as e:
        error = type(e).__name__
    return (outs, error, consumed, observed, [h.fetches for h in handles], tracker["max"],
            pipe.last_window["depth"])


@pytest.mark.parametrize("fail", [None, "fetch", "consume"])
@pytest.mark.parametrize("level,depth", [(0, 1), (0, 2), (0, 3), (1, 2), (2, 3)])
def test_pipeline_matches_the_jax_pipeline(level, depth, fail):
    want = run_pipeline(jax_pipeline, level, depth, fail)
    got = run_pipeline(port_pipeline, level, depth, fail)
    assert got == want
    outs, error, consumed, observed, fetches, max_inflight, used = got
    # every dispatched handle fetched exactly once, drain included
    assert set(fetches) == {1}
    assert max_inflight == (1 if level >= 1 else depth) == used
    if fail is None:
        assert outs == [0, 10, 20, 30, 40, 50] and observed == list(range(6))


def test_pipeline_stats_stamp_each_stage():
    stats = []
    pipe = port_pipeline.SolvePipeline(port_pipeline.PipelineConfig(depth=2, adaptive=False))

    class Handle:
        def fetch(self):
            return [1]

    pipe.run([0, 1, 2], prepare=lambda c: c, dispatch=lambda p: Handle(),
             consume=lambda p, r: time.sleep(0.01), on_chunk=lambda p, s: stats.append(s))
    assert len(stats) == 3
    for s in stats:
        assert s["t_dispatch"] <= s["t_fetch"] <= s["t_done"]
        assert s["launch_bind_s"] >= 0.01 and s["inflight_s"] >= 0
    # depth 2: chunk 0 stayed in flight while chunk 1 was prepared
    assert pipe.last_window["overlap_s"] == pytest.approx(sum(s["inflight_s"] for s in stats))


@pytest.mark.parametrize("observations,want", [
    ([(1.0, 0.01, 2), (1.0, 0.01, 2)], 1),        # overlap cannot pay: step down
    ([(1.0, 0.5, 2)], 3),                         # saturated: step up
    ([(1.0, 0.2, 2)], 2),                         # in between: hold
    ([(1.0, 0.0, 1)] * 8, 2),                     # serial for 8 windows: probe 2
    ([(1e-5, 0.0, 2)] * 4, 2),                    # too small to signal
])
def test_adaptive_depth_matches_the_jax_state_machine(observations, want):
    jax_depth = jax_pipeline._AdaptiveDepth(2 if observations[0][2] > 1 else 1)
    port_depth = port_pipeline._AdaptiveDepth(2 if observations[0][2] > 1 else 1)
    for wall, overlap, used in observations:
        assert port_depth.observe(wall, overlap, used) == jax_depth.observe(wall, overlap, used)
    assert port_depth.depth == jax_depth.depth == want


# -- the batcher alone ---------------------------------------------------------

def collect_async(batcher, out):
    t = threading.Thread(target=lambda: out.append(batcher.wait()), daemon=True)
    t.start()
    return t


def test_idle_window_closes_and_extends_on_arrivals():
    b = port_batcher.Batcher(idle_seconds=0.5, max_seconds=5.0,
                             monitor=HeldMonitor(port_monitor))
    out = []
    t = collect_async(b, out)
    for i in range(4):
        b.add(i)
        time.sleep(0.03)  # well under the idle window: the batch stays open
    t.join(timeout=3.0)
    assert not t.is_alive()
    items, window = out[0]
    assert items == [0, 1, 2, 3] and window < 1.0


def test_max_window_caps_a_stream():
    b = port_batcher.Batcher(idle_seconds=0.2, max_seconds=0.3,
                             monitor=HeldMonitor(port_monitor))
    out = []
    t = collect_async(b, out)
    stop, sent = time.monotonic() + 0.6, 0
    while time.monotonic() < stop:
        b.add(sent)
        sent += 1
        time.sleep(0.02)
    t.join(timeout=3.0)
    items, window = out[0]
    # cut by the max window (not by idle, not drained dry)
    assert window >= 0.2 and len(items) < sent


def test_gate_lifecycle_and_stop():
    b = port_batcher.Batcher(idle_seconds=5.0, monitor=HeldMonitor(port_monitor))
    g1 = b.add("x")
    assert not g1.wait(timeout=0.02)
    b.flush()
    assert g1.wait(timeout=1.0)
    g2 = b.add("y")
    assert g2 is not g1 and not g2.is_set()
    b.wait()  # consumes "y"
    out = []
    t = collect_async(b, out)
    time.sleep(0.05)
    b.stop()
    t.join(timeout=3.0)
    assert not t.is_alive() and out[0][0] == []


def test_depth_bound_sheds_and_displaces_for_system_critical():
    b = port_batcher.Batcher(idle_seconds=0.001, max_depth=3, monitor=HeldMonitor(port_monitor))
    for i in range(3):
        assert b.add(f"d{i}", key=("ns", f"d{i}"), band="default") is not None
    assert b.add("d3", key=("ns", "d3"), band="default") is None
    assert b.add("low", key=("ns", "low"), band="low") is None
    assert b.add("crit", key=("ns", "crit"), band="system-critical") is not None
    assert b.shed == {("depth-bound", "default"): 1, ("depth-bound", "low"): 1,
                      ("displaced", "default"): 1}
    items, _ = b.wait()
    assert items[0] == "crit" and len(items) == 3
    assert not b.contains(("ns", "d2"))  # the displaced key was released
    b.stop()


def test_gang_is_held_until_complete_and_never_split():
    b = port_batcher.Batcher(idle_seconds=0.001, max_items=3, monitor=HeldMonitor(port_monitor))
    gang = (("ns", "g"), 3)
    b.add("g0", key=("ns", "g0"), gang=gang)
    b.add("solo", key=("ns", "solo"))
    items, _ = b.wait()
    assert items == ["solo"]  # the partial gang stays queued
    b.add("g1", key=("ns", "g1"), gang=gang)
    b.add("a", key=("ns", "a"), band="high")
    b.add("g2", key=("ns", "g2"), gang=gang)
    items, _ = b.wait()
    # the cap (3) would cut the gang after "a": it waits for the next window
    assert items == ["a"]
    items, _ = b.wait()
    assert sorted(items) == ["g0", "g1", "g2"]
    b.stop()


@pytest.mark.parametrize("size,ttl,reason", [(5, 0.0, "gang-expired"), (9, 60.0, "gang-oversize")])
def test_gang_sheds_whole_past_ttl_or_oversize(size, ttl, reason):
    b = port_batcher.Batcher(idle_seconds=0.001, max_items=8, gang_ttl_seconds=ttl,
                             monitor=HeldMonitor(port_monitor))
    for i in range(2):
        b.add(f"g{i}", key=("ns", f"g{i}"), gang=(("ns", "g"), size))
    b.add("solo", key=("ns", "solo"))
    time.sleep(0.01)
    items, _ = b.wait()
    if reason == "gang-expired":
        # the first window starts the hold; the next one finds it expired
        items += b.wait()[0] if b.depth() else []
    assert "solo" in items and not any(i.startswith("g") for i in items)
    assert b.shed == {(reason, "default"): 2}
    assert not b.contains(("ns", "g0")) and b.depth() == 0
    b.stop()


def test_l1_halves_the_windows():
    b = port_batcher.Batcher(idle_seconds=1.0, max_seconds=10.0,
                             monitor=HeldMonitor(port_monitor, level=1))
    b.add("x")
    t0 = time.monotonic()
    b.wait()
    assert time.monotonic() - t0 < 0.95  # the 1 s idle window halved


# -- the pressure monitor alone -------------------------------------------------

def fake_clock_monitor(**config):
    t = [0.0]
    mon = port_monitor.PressureMonitor(
        port_monitor.PressureConfig(max_depth=100, dwell_seconds=5.0, rss_watermark_bytes=0,
                                    **config),
        timefunc=lambda: t[0], rss_fn=lambda: 0)
    return mon, t


def dwell_levels(mon, t):
    mon.note_depth(1, 90)  # burst: crossing a rung re-evaluates at once
    levels = [int(mon.level())]
    mon.note_depth(1, 0)
    for _ in range(8):
        t[0] += 2.6
        levels.append(int(mon.evaluate()))
    return levels


def test_monitor_rises_at_once_and_falls_one_rung_per_dwell():
    mon, t = fake_clock_monitor()
    jt = [0.0]
    jax_mon = jax_monitor.PressureMonitor(
        jax_monitor.PressureConfig(max_depth=100, dwell_seconds=5.0, rss_watermark_bytes=0),
        timefunc=lambda: jt[0], breaker_fn=lambda: False, rss_fn=lambda: 0)
    levels = dwell_levels(mon, t)
    assert levels == dwell_levels(jax_mon, jt)
    # the first sample below opens the dwell; then one rung per 5 s dwell
    assert levels == [3, 3, 3, 2, 2, 1, 1, 0, 0]


@pytest.mark.parametrize("depth,window,rss,want,base", [
    (19, 0.0, 0, 0, 0), (20, 0.0, 0, 1, 0), (50, 0.0, 0, 2, 0), (85, 0.0, 0, 3, 0),
    (0, 5.0, 0, 1, 0), (0, 30.0, 0, 2, 0), (0, 0.0, 850, 2, 0), (0, 0.0, 1000, 3, 0),
    # a process that starts far above the watermark (torch's libraries)
    # reads the rung of its growth alone
    (0, 0.0, 0, 0, 5000), (0, 0.0, 849, 0, 5000), (0, 0.0, 850, 2, 5000),
    (0, 0.0, 1000, 3, 5000),
])
def test_monitor_signal_thresholds(depth, window, rss, want, base):
    t, now_rss = [0.0], [base]
    mon = port_monitor.PressureMonitor(
        port_monitor.PressureConfig(max_depth=100, rss_watermark_bytes=1000),
        timefunc=lambda: t[0], rss_fn=lambda: now_rss[0])
    now_rss[0] = base + rss  # the RSS signal is the growth since the monitor was made
    mon.note_depth(7, depth)
    if window:
        mon.note_window(window)
    assert int(mon.evaluate()) == want
    assert int(mon.level()) == want  # cached until the next evaluation


def test_bands_match_the_jax_package():
    from karpenter_tpu.pressure import bands as jax_bands

    for rank in range(5):
        for level in range(4):
            assert port_bands.shed_reason(rank, level) == jax_bands.shed_reason(rank, level)
        for age in (0.0, 59.0, 60.0, 130.0, 600.0):
            assert (port_bands.effective_rank(rank, age, 60.0)
                    == jax_bands.effective_rank(rank, age, 60.0))


@pytest.mark.parametrize("level", [0, 3])
def test_requeue_displaced_is_atomic_and_shed_proof_as_jax(level):
    """A displaced gang's members re-enter both packages' batchers whole,
    past a full depth bound and a level that sheds their band, and come out
    in the same window with the same order; a plain add of the same band
    is shed in both."""
    out = []
    for b_mod, m_mod in ((jax_batcher, jax_monitor), (port_batcher, port_monitor)):
        b = b_mod.Batcher(idle_seconds=0.01, max_seconds=1.0, max_depth=1,
                          monitor=HeldMonitor(m_mod, level))
        try:
            assert (b.add("filler", key="filler", band="system-critical") is not None)
            entries = [(f"m{i}", f"m{i}", "low", -5, (("ns", "g"), 3)) for i in range(3)]
            assert b.requeue_displaced(entries) == 3
            assert b.contains("m0") and b.contains("m2")
            shed = b.add("late", key="late", band="low")
            items, _ = b.wait()
            out.append((items, shed is None, b.added_total, sorted(b.shed.items())
                        if isinstance(b.shed, dict) else None))
        finally:
            b.stop()
    assert out[0][:3] == out[1][:3]
    assert out[1][0] == ["filler", "m0", "m1", "m2"] and out[1][1]
