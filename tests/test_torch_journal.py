"""The port's write-ahead intent journal against the JAX package's, on the CPU.

Every case drives the same operations through both packages' journals with
the same draws (``uuid.uuid4`` replaced by one seeded sequence, reset before
each package runs, and both clocks held at one instant), then compares, exactly:

- what the case observed (open intents with their kind, phase, data and
  history, replay stats, raised errors, decoded records);
- the journal directory itself, file name for file name and byte for byte;
- the recovery family's counters the case moved (records by kind, bytes,
  torn records, compactions).

The cases are those of the JAX package's journal tests: framing, replay
with torn tails and mid-segment corruption, rotation, compaction (by hand
and automatic), the state machines, the nonce plumbing and the kill points.
Cross-replay: a directory written by one package opens in the other to the
same open intents, phases, data and torn-record count.
"""

import json
import os
import random
import threading
import uuid
import zlib
from types import SimpleNamespace

import pytest

from karpenter_tpu.chaos import inject as jax_inject
from karpenter_tpu.metrics import recovery as jax_rmetrics
from karpenter_tpu.runtime import journal as jax_jr
from karpenter_tpu.utils import clock as jax_clock
from karpenter_tpu_torch.chaos import inject as port_inject
from karpenter_tpu_torch.metrics import recovery as port_rmetrics
from karpenter_tpu_torch.runtime import journal as port_jr
from karpenter_tpu_torch.utils import clock as port_clock

JAX = SimpleNamespace(name="jax", jr=jax_jr, inject=jax_inject, metrics=jax_rmetrics,
                      clock=jax_clock)
PORT = SimpleNamespace(name="port", jr=port_jr, inject=port_inject, metrics=port_rmetrics,
                       clock=port_clock)
T0 = 1_700_000_000.0
COUNTERS = ("JOURNAL_RECORDS_TOTAL", "JOURNAL_BYTES_TOTAL", "JOURNAL_TORN_RECORDS_TOTAL",
            "JOURNAL_COMPACTIONS_TOTAL")


@pytest.fixture(autouse=True)
def _clean_plans():
    yield
    jax_inject.uninstall()
    port_inject.uninstall()


def seed_uuid(monkeypatch, seed):
    """Replace uuid.uuid4 (both packages' journals draw from it) with a
    sequence made from ``seed``."""
    rng = random.Random(seed)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))


def dir_bytes(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as f:
            out[fn] = f.read()
    return out


def segments(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".wal"))


def raw_lines(d):
    out = []
    for fn in segments(d):
        with open(os.path.join(d, fn), "rb") as f:
            out.extend(line for line in f.read().split(b"\n") if line)
    return out


def index(j):
    """The open-intent index: every field of every open intent."""
    return sorted((i.id, i.kind, i.phase, json.dumps(i.data, sort_keys=True),
                   [list(h) for h in i.history]) for i in j.open_intents().values())


def stats(j):
    s = dict(j.stats())
    s.pop("dir")
    return s


def counters(pkg):
    out = {}
    for name in COUNTERS:
        for labels, v in getattr(pkg.metrics, name).collect().items():
            out[(name, labels)] = v
    return out


def delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v - before.get(k, 0.0)}


def errors_of(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return type(e).__name__
    return None


# -- the cases: each takes (pkg, dir) and returns what it observed --------------

def case_framing(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    iid = j.open_intent("drain", node="n1")
    j.advance(iid, "deleting")
    j.close(iid)
    payload = json.dumps({"id": "x", "kind": "drain", "phase": "open"}).encode()
    good = f"{zlib.crc32(payload):08x} ".encode() + payload
    arr = b"[1,2]"
    decoded = [pkg.jr._decode_line(x) for x in (
        good, b"", b"short", b"zzzzzzzz " + payload, good[:-2],
        good.replace(b'"x"', b'"y"'), f"{zlib.crc32(arr):08x} ".encode() + arr)]
    return {"phases": [pkg.jr._decode_line(line)["phase"] for line in raw_lines(d)],
            "decoded": decoded}


def case_restart(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    j.open_intent("fleet-launch", nonce="abc", quantity=2)
    b = j.open_intent("bind", node="n1", pods=["default/p1"])
    j.advance(b, "node-created")
    c = j.open_intent("drain", node="n2")
    j.close(c)
    j.close_journal()
    j2 = pkg.jr.IntentJournal(d, fsync=False)
    return {"index": index(j2), "stats": stats(j2)}


def case_torn_tail(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    a = j.open_intent("drain", node="n1")
    j.advance(a, "deleting")
    j.close_journal()
    path = os.path.join(d, segments(d)[-1])
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-7])  # a crash mid-append: the last line loses its tail
    j2 = pkg.jr.IntentJournal(d, fsync=False)
    seen = {"index": index(j2), "stats": stats(j2)}
    j2.advance(a, "deleting")  # lands in a fresh segment
    seen["segments"] = segments(d)
    return seen


def case_mid_segment_corruption(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    j.open_intent("drain", node="n1")
    b = j.open_intent("drain", node="n2")
    j.advance(b, "deleting")
    j.close_journal()
    path = os.path.join(d, segments(d)[-1])
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    lines[1] = b"xx" + lines[1][2:]  # b's open corrupted, the rest kept
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))
    j2 = pkg.jr.IntentJournal(d, fsync=False)
    return {"index": index(j2), "stats": stats(j2)}


def case_close_wins(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    j.close(j.open_intent("drain", node="n1"))
    j.close_journal()
    return {"index": index(pkg.jr.IntentJournal(d, fsync=False))}


def case_rotation(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False, segment_max_records=2)
    for _ in range(3):
        j.close(j.open_intent("drain", node="n"))
    return {"segments": segments(d), "stats": stats(j)}


def case_compaction(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False, segment_max_records=2)
    keep = j.open_intent("fleet-launch", nonce="keep-me")
    for _ in range(5):
        j.close(j.open_intent("drain", node="n"))
    before = len(raw_lines(d))
    removed = j.compact()
    lines = [pkg.jr._decode_line(line)["id"] for line in raw_lines(d)]
    j.close_journal()
    j2 = pkg.jr.IntentJournal(d, fsync=False)
    return {"before": before, "removed": removed, "ids": lines, "keep": keep,
            "index": index(j2), "stats": stats(j2)}


def case_compaction_all_closed(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    for _ in range(3):
        j.close(j.open_intent("drain", node="n"))
    j.compact()
    seen = {"lines": raw_lines(d)}
    j.close_journal()
    seen["index"] = index(pkg.jr.IntentJournal(d, fsync=False))
    return seen


def case_append_after_compaction(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    j.close(j.open_intent("drain", node="n"))
    j.compact()
    j.open_intent("drain", node="m")
    j.close_journal()
    return {"index": index(pkg.jr.IntentJournal(d, fsync=False)), "segments": segments(d)}


def case_auto_compaction(pkg, d):
    """Past ``auto_compact_closed`` closed intents, a rotation compacts."""
    j = pkg.jr.IntentJournal(d, fsync=False, segment_max_records=3, auto_compact_closed=4)
    live = [j.open_intent("carve", gang=f"g{i}", node="n", cells=[i]) for i in range(2)]
    for i in range(7):
        iid = j.open_intent("bind", node=f"n{i}", pods=[f"default/p{i}"])
        j.advance(iid, "node-created")
        j.close(iid)
    j.close(live[0], outcome="released")
    return {"segments": segments(d), "lines": len(raw_lines(d)), "index": index(j),
            "stats": stats(j)}


def case_state_machines(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    seen = {"unknown": errors_of(lambda: j.open_intent("teleport"))}
    iid = j.open_intent("bind", node="n1")
    seen["moves"] = [errors_of(lambda p=p: j.advance(iid, p)) for p in (
        "launched", "open", "closed", "bound", "node-created")]
    seen["missing"] = errors_of(lambda: j.advance("no-such-intent", "bound"))
    g = j.open_intent("gang-bind", gang="g", members=["default/a"])
    j.note(g, created=["node-1"])
    j.note(g, created=["node-1", "node-2"])
    seen["note"] = (j.intent(g).phase, j.intent(g).data)
    j.close("never-opened")
    x = j.open_intent("drain", node="n")
    j.close(x, outcome="done")
    j.close(x, outcome="again")  # a double close writes nothing
    j.close_journal()
    seen["lines"] = len(raw_lines(d))
    restored = pkg.jr.IntentJournal(d, fsync=False)
    seen["restored"] = index(restored)
    return seen


def case_covered_nonces(pkg, d):
    j = pkg.jr.IntentJournal(d, fsync=False)
    a = j.open_intent("fleet-launch", nonce="n-a")
    g = j.open_intent("gang-bind", gang="g", members=[])
    j.note(g, nonces=["n-g1", "n-g2"])
    b = j.open_intent("fleet-launch", nonce="n-b")
    j.open_intent("drain", node="x")
    seen = [sorted(j.covered_nonces())]
    j.close(a)
    j.close(g)
    seen.append(sorted(j.covered_nonces()))
    j.close(b)
    seen.append(sorted(j.covered_nonces()))
    return {"covered": seen, "of_kind": [i.id for i in j.open_of_kind("drain")]}


def case_nonces(pkg, d):
    seen = [pkg.jr.current_preassigned_nonce()]
    with pkg.jr.preassigned_nonce("outer"):
        seen.append(pkg.jr.current_preassigned_nonce())
        with pkg.jr.preassigned_nonce("inner"):
            seen.append(pkg.jr.current_preassigned_nonce())
        seen.append(pkg.jr.current_preassigned_nonce())
        other = {}
        t = threading.Thread(target=lambda: other.update(v=pkg.jr.current_preassigned_nonce()))
        t.start()
        t.join()
        seen.append(other["v"])
    seen.append(pkg.jr.current_preassigned_nonce())
    return {"seen": seen, "new": [pkg.jr.new_nonce() for _ in range(3)]}


def case_kill_points(pkg, d):
    seen = {"catalog": list(pkg.jr.KILL_POINTS),
            "machines": {k: list(v) for k, v in pkg.jr.MACHINES.items()},
            "base": [issubclass(pkg.inject.SimulatedCrash, Exception),
                     issubclass(pkg.inject.SimulatedCrash, BaseException)]}
    for point in ("pre:drain:open", "drain:open"):
        sub = os.path.join(d, point.replace(":", "_"))
        j = pkg.jr.IntentJournal(sub, fsync=False)
        pkg.inject.install(pkg.inject.FaultPlan(
            1, [pkg.inject.FaultSpec("journal", point, "crash-point", 1)], window=1))
        try:
            j.open_intent("drain", node="n1")
            seen[point] = None
        except pkg.inject.SimulatedCrash as e:
            seen[point] = e.point
        pkg.inject.uninstall()
        j.close_journal()
        seen[point + " replay"] = index(pkg.jr.IntentJournal(sub, fsync=False))
    j = pkg.jr.IntentJournal(os.path.join(d, "free"), fsync=False)
    j.close(j.open_intent("drain", node="n1"))  # no plan: nothing raised
    return seen


CASES = [case_framing, case_restart, case_torn_tail, case_mid_segment_corruption,
         case_close_wins, case_rotation, case_compaction, case_compaction_all_closed,
         case_append_after_compaction, case_auto_compaction, case_state_machines,
         case_covered_nonces, case_nonces, case_kill_points]


def run_case(pkg, case, d, monkeypatch, seed=5):
    seed_uuid(monkeypatch, seed)
    pkg.clock.DEFAULT.set(T0)
    try:
        before = counters(pkg)
        seen = case(pkg, d)
        moved = {(name, labels): v for (name, labels), v in
                 delta(before, counters(pkg)).items()}
    finally:
        pkg.clock.DEFAULT.reset()
    files = {}
    for root, _dirs, names in os.walk(d):
        for fn in names:
            with open(os.path.join(root, fn), "rb") as f:
                files[os.path.relpath(os.path.join(root, fn), d)] = f.read()
    return seen, files, moved


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_case_equals_the_jax_journal(case, tmp_path, monkeypatch):
    j_seen, j_files, j_moved = run_case(JAX, case, str(tmp_path / "jax"), monkeypatch)
    p_seen, p_files, p_moved = run_case(PORT, case, str(tmp_path / "port"), monkeypatch)
    assert p_seen == j_seen
    assert sorted(p_files) == sorted(j_files)
    for fn in j_files:
        assert p_files[fn] == j_files[fn], fn
    assert p_moved == j_moved


def test_case_observations_hold():
    """The cases observe what the journal promises, not just the same thing
    in both packages: spot checks of their meaning on the port."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        seen = case_torn_tail(PORT, d)
        assert seen["stats"]["torn_records"] == 1 and len(seen["segments"]) == 2
    with tempfile.TemporaryDirectory() as d:
        seen = case_compaction(PORT, d)
        assert seen["removed"] >= 1 and set(seen["ids"]) == {seen["keep"]}
    with tempfile.TemporaryDirectory() as d:
        seen = case_state_machines(PORT, d)
        assert seen["unknown"] == "ValueError" and seen["missing"] == "KeyError"
        assert seen["moves"] == ["ValueError", "ValueError", "ValueError", None, "ValueError"]
        assert seen["lines"] == 7  # bind 2, gang-bind 3, drain 2: no double close
    with tempfile.TemporaryDirectory() as d:
        seen = case_kill_points(PORT, d)
        assert seen["pre:drain:open replay"] == [] and len(seen["drain:open replay"]) == 1
        assert seen["base"] == [False, True] and len(seen["catalog"]) == 50


# -- cross-replay ---------------------------------------------------------------

def write_history(pkg, d, seed, torn):
    """A seeded mix of every kind and transition, with rotation, a
    compaction and (``torn``) a torn tail, written by ``pkg``."""
    rng = random.Random(seed)
    j = pkg.jr.IntentJournal(d, fsync=False, segment_max_records=5, auto_compact_closed=6)
    live = []
    for step in range(60):
        if live and rng.random() < 0.55:
            iid, kind = live[rng.randrange(len(live))]
            phases = pkg.jr.MACHINES[kind]
            cur = j.intent(iid).phase
            later = [p for p in phases[phases.index(cur) + 1:] if p != "closed"]
            roll = rng.random()
            if later and roll < 0.5:
                j.advance(iid, rng.choice(later), step=step)
            elif roll < 0.7 and kind == "gang-bind":
                j.note(iid, nonces=[f"n{step}"], created=[f"node-{step}"])
            else:
                j.close(iid, outcome=rng.choice(["done", "error"]))
                live.remove((iid, kind))
        else:
            kind = rng.choice(sorted(pkg.jr.MACHINES))
            iid = j.open_intent(kind, node=f"node-{step}", nonce=f"nonce-{step}",
                                pods=[f"default/p{step}"], cells=[step % 16], grid=[4, 4])
            live.append((iid, kind))
        if step == 30:
            j.compact()
    j.close_journal()
    if torn:
        path = os.path.join(d, segments(d)[-1])
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[:-5])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("seed,torn", [(1, False), (7, True), (42, True)])
def test_cross_replay(writer, seed, torn, tmp_path, monkeypatch):
    src, dst = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    seed_uuid(monkeypatch, seed)
    src.clock.DEFAULT.set(T0)
    try:
        write_history(src, str(tmp_path / "w"), seed, torn)
    finally:
        src.clock.DEFAULT.reset()
    # each reader gets its own copy: an open starts a fresh segment
    for pkg in (src, dst):
        os.makedirs(tmp_path / pkg.name, exist_ok=True)
        for fn, raw in dir_bytes(str(tmp_path / "w")).items():
            with open(tmp_path / pkg.name / fn, "wb") as f:
                f.write(raw)
    a = src.jr.IntentJournal(str(tmp_path / src.name), fsync=False)
    b = dst.jr.IntentJournal(str(tmp_path / dst.name), fsync=False)
    assert index(b) == index(a)
    assert stats(b) == stats(a)
    assert a.stats()["torn_records"] == (1 if torn else 0)
    assert a.open_intents(), "the history left nothing open"
    assert sorted(b.covered_nonces()) == sorted(a.covered_nonces())
