"""Crash-safe write-ahead intent journal.

A copy of the JAX package's ``runtime/journal.py``: the same record
framing, segment names, rotation and compaction, so a journal directory
written by either package replays in the other to the same open-intent
index.

Every multi-step mutation the control plane performs — fleet launch,
node-create-and-bind, two-phase gang bind, consolidation drain, the
termination finalizer — records its progress here BEFORE acting, so a
process death at any instant leaves a replayable trail instead of
orphaned capacity and half-bound gangs. The startup recovery controller
(controllers/recovery.py) replays open intents against live state and
rolls each forward or back; the GC controller treats journal-covered
launch nonces as owned so the two never double-terminate.

Storage: append-only JSONL segments under the journal directory, one
record per line, CRC-framed::

    <crc32 hex8> <compact json>\n

Appends are flushed and fsync'd per record (``fsync=False`` leaves
durability to the page cache, for tests). A
crash mid-write leaves a torn tail — the trailing line of the last
segment failing its CRC or parse — which replay tolerates and counts;
a fresh segment is started on every open so a torn tail is never
appended after. Segments rotate at ``segment_max_records`` records and
compaction rewrites the sealed set keeping only open intents' records.

Intent state machines, journaled at each phase transition:

========== ======================================================
kind        phases
========== ======================================================
fleet-launch  open → launched → closed
bind          open → node-created → bound → closed
gang-bind     open → nodes-created → bound → closed
              (failure leg: … → unwinding → unwound → closed)
drain         open → deleting → closed
node-delete   open → instance-deleted → closed
carve         open → closed
preempt       open → victims-unbound → beneficiary-bound → closed
========== ======================================================

Two of these make topology state crash-consistent. A ``carve`` intent
is LONG-LIVED: it opens when a slice gang's contiguous cell set is committed to the occupancy ledger and closes
only when the carve is released (preemption, gang teardown, node
termination) — so the set of open carve intents IS the durable form of
:data:`karpenter_tpu_torch.ops.topology.LEDGER`, and startup recovery
rebuilds the ledger from them bit-for-bit before any controller runs.
Compaction keeps open carve records and folds closed carve pairs like
any other intent, so a long-lived fleet's journal stays bounded. A
``preempt`` intent brackets one victim displacement: ``open`` before
the first member unbind, ``victims-unbound`` once the members are
requeued and the victim's ledger cells released, ``beneficiary-bound``
after the displacing gang binds onto the freed capacity.

A ``fleet-launch`` intent is stamped with the ``karpenter.sh/
launch-nonce`` value *before* the provider create runs: the caller
draws the nonce, journals it, and hands it to the provider through
:func:`preassigned_nonce`, so a crash between CreateFleet and the Node
write leaves capacity that recovery can attribute by tag.

Kill points: every transition fires two named chaos crash points on the
``journal`` boundary — ``pre:<kind>:<phase>`` before the record is
durable and ``<kind>:<phase>`` after (chaos/inject.py ``crash-point``
faults raise :class:`~karpenter_tpu_torch.chaos.inject.SimulatedCrash`).
:data:`KILL_POINTS` is the full catalog the crash-restart soak iterates.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import uuid
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.chaos import inject
from karpenter_tpu_torch.metrics.recovery import (
    JOURNAL_APPEND_SECONDS, JOURNAL_BYTES_TOTAL, JOURNAL_COMPACTIONS_TOTAL,
    JOURNAL_OPEN_INTENTS, JOURNAL_RECORDS_TOTAL, JOURNAL_SEGMENTS,
    JOURNAL_TORN_RECORDS_TOTAL)
from karpenter_tpu_torch.utils import clock

log = logging.getLogger("karpenter.journal")

#: phase ladders per intent kind; "closed" is terminal for every kind
MACHINES: Dict[str, Tuple[str, ...]] = {
    "fleet-launch": ("open", "launched", "closed"),
    "bind": ("open", "node-created", "bound", "closed"),
    "gang-bind": ("open", "nodes-created", "bound",
                  "unwinding", "unwound", "closed"),
    "drain": ("open", "deleting", "closed"),
    "node-delete": ("open", "instance-deleted", "closed"),
    # durable occupancy-ledger entry: open = carve committed and live,
    # closed = released (long-lived; survives compaction while open)
    "carve": ("open", "closed"),
    # one victim displacement, bracketed end to end
    "preempt": ("open", "victims-unbound", "beneficiary-bound", "closed"),
}

#: every named crash point the soak can arm: pre (record not yet
#: durable) and post (durable, control not yet returned) per transition
KILL_POINTS: List[str] = [
    name
    for kind, phases in MACHINES.items()
    for phase in phases
    for name in (f"pre:{kind}:{phase}", f"{kind}:{phase}")
]

_SEGMENT_RE = re.compile(r"^journal-(\d{8})\.wal$")


@dataclass
class Intent:
    """Live-index view of one journaled mutation."""

    id: str
    kind: str
    phase: str = "open"
    data: Dict[str, object] = field(default_factory=dict)
    history: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def closed(self) -> bool:
        return self.phase == "closed"


# ---------------------------------------------------------------------------
# Launch-nonce pre-stamp: the journal needs the nonce known BEFORE the
# provider create, but providers historically drew it internally at
# launch time. The caller journals a nonce and providers consult this
# thread-local instead of uuid4 while the context is active.
# ---------------------------------------------------------------------------

_TLS = threading.local()


@contextmanager
def preassigned_nonce(nonce: str):
    """Hand ``nonce`` to every provider create on this thread for the
    duration of the block (nests; restores the previous value)."""
    prev = getattr(_TLS, "nonce", None)
    _TLS.nonce = nonce
    try:
        yield
    finally:
        _TLS.nonce = prev


def current_preassigned_nonce() -> Optional[str]:
    """Provider side: the journaled nonce for this thread's in-flight
    create, or None (provider draws its own uuid4 as before)."""
    return getattr(_TLS, "nonce", None)


def new_nonce() -> str:
    return uuid.uuid4().hex


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------


class IntentJournal:
    """Append-only, fsync'd, CRC-framed intent journal over a directory
    of JSONL segments. Thread-safe; one instance per process."""

    def __init__(self, dir: str, fsync: bool = True,
                 segment_max_records: int = 4096,
                 auto_compact_closed: int = 1024):
        self.dir = dir
        self.fsync = fsync
        self.segment_max_records = max(1, int(segment_max_records))
        self.auto_compact_closed = int(auto_compact_closed)
        self._lock = threading.RLock()
        self._intents: Dict[str, Intent] = {}
        self._file = None
        self._seg_records = 0
        self._closed_since_compact = 0
        self._torn = 0
        self._scanned = 0
        os.makedirs(dir, exist_ok=True)
        self._replay_segments()
        # appends go to a FRESH segment: a torn tail from the previous
        # process is never appended after, so one segment has at most
        # one torn record and it is always the last line
        self._seq = (max(self._segment_seqs(), default=0)) + 1
        self._publish_gauges()

    # -- segment plumbing ---------------------------------------------------
    def _segment_seqs(self) -> List[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = _SEGMENT_RE.match(fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"journal-{seq:08d}.wal")

    def _open_segment(self):
        if self._file is None:
            self._file = open(self._segment_path(self._seq), "ab")
            self._seg_records = 0
        return self._file

    def _rotate(self) -> None:
        """Caller holds the lock and has just filled the segment."""
        self._file.close()
        self._file = None
        self._seq += 1
        if (self.auto_compact_closed > 0
                and self._closed_since_compact >= self.auto_compact_closed):
            self._compact_locked()
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        JOURNAL_OPEN_INTENTS.set(float(len(self._intents)))
        JOURNAL_SEGMENTS.set(float(len(self._segment_seqs())))

    # -- replay -------------------------------------------------------------
    def _replay_segments(self) -> None:
        seqs = self._segment_seqs()
        for i, seq in enumerate(seqs):
            last_segment = i == len(seqs) - 1
            path = self._segment_path(seq)
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except OSError as e:
                log.warning("journal segment %s unreadable: %s", path, e)
                continue
            lines = raw.split(b"\n")
            for j, line in enumerate(lines):
                if not line:
                    continue
                rec = _decode_line(line)
                if rec is None:
                    self._torn += 1
                    JOURNAL_TORN_RECORDS_TOTAL.inc()
                    tail = last_segment and j >= len(lines) - 2
                    if tail:
                        log.info("journal %s: torn tail tolerated", path)
                    else:
                        log.warning("journal %s line %d: corrupt record "
                                    "skipped", path, j + 1)
                    continue
                self._scanned += 1
                self._apply(rec)

    def _apply(self, rec: dict) -> None:
        iid = rec.get("id")
        kind = rec.get("kind")
        phase = rec.get("phase")
        if not iid or not kind or not phase:
            self._torn += 1
            JOURNAL_TORN_RECORDS_TOTAL.inc()
            return
        if phase == "closed":
            self._intents.pop(iid, None)
            return
        intent = self._intents.get(iid)
        if intent is None:
            # records are self-describing (every one carries kind), so a
            # torn/compacted-away "open" does not orphan later phases
            intent = self._intents[iid] = Intent(id=iid, kind=kind)
        intent.phase = phase
        intent.data.update(rec.get("data") or {})
        intent.history.append((phase, rec.get("t", 0.0)))

    # -- append -------------------------------------------------------------
    def _transition(self, iid: str, kind: str, phase: str,
                    data: Dict[str, object]) -> None:
        name = f"{kind}:{phase}"
        # the decision is made but not durable: a crash here must be
        # recovered from live state alone (or the previous record)
        inject.crash_point(f"pre:{name}")
        t0 = time.perf_counter()
        rec = {"id": iid, "kind": kind, "phase": phase,
               "t": clock.now(), "data": data}
        payload = json.dumps(rec, separators=(",", ":"),
                             sort_keys=True).encode()
        line = f"{zlib.crc32(payload):08x} ".encode() + payload + b"\n"
        with self._lock:
            f = self._open_segment()
            f.write(line)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            self._seg_records += 1
            self._apply_live(rec)
            if self._seg_records >= self.segment_max_records:
                self._rotate()
        JOURNAL_RECORDS_TOTAL.inc(kind=kind)
        JOURNAL_BYTES_TOTAL.inc(float(len(line)))
        JOURNAL_APPEND_SECONDS.observe(time.perf_counter() - t0)
        # durable but control has not returned to the caller
        inject.crash_point(name)

    def _apply_live(self, rec: dict) -> None:
        iid, phase = rec["id"], rec["phase"]
        if phase == "closed":
            if self._intents.pop(iid, None) is not None:
                self._closed_since_compact += 1
        else:
            intent = self._intents.get(iid)
            if intent is None:
                intent = self._intents[iid] = Intent(id=iid,
                                                     kind=rec["kind"])
            intent.phase = phase
            intent.data.update(rec["data"])
            intent.history.append((phase, rec["t"]))
        JOURNAL_OPEN_INTENTS.set(float(len(self._intents)))

    # -- public API ---------------------------------------------------------
    def open_intent(self, kind: str, **data) -> str:
        if kind not in MACHINES:
            raise ValueError(f"unknown intent kind {kind!r}")
        iid = uuid.uuid4().hex[:16]
        self._transition(iid, kind, "open", data)
        return iid

    def advance(self, iid: str, phase: str, **data) -> None:
        with self._lock:
            intent = self._intents.get(iid)
        if intent is None:
            raise KeyError(f"intent {iid} is not open")
        machine = MACHINES[intent.kind]
        if phase not in machine or phase in ("open", "closed"):
            raise ValueError(
                f"{intent.kind} has no transition to {phase!r}")
        if machine.index(phase) <= machine.index(intent.phase):
            raise ValueError(
                f"{intent.kind} cannot move {intent.phase!r} → {phase!r}")
        self._transition(iid, intent.kind, phase, data)

    def note(self, iid: str, **data) -> None:
        """Durable data-only update at the intent's CURRENT phase — no
        phase transition, no kill points. Gang launches use this to grow
        the created-node set one durable record per node, so a crash
        mid-phase-1 leaves the exact teardown list on disk."""
        with self._lock:
            intent = self._intents.get(iid)
            if intent is None:
                raise KeyError(f"intent {iid} is not open")
            t0 = time.perf_counter()
            rec = {"id": iid, "kind": intent.kind, "phase": intent.phase,
                   "t": clock.now(), "data": data}
            payload = json.dumps(rec, separators=(",", ":"),
                                 sort_keys=True).encode()
            line = f"{zlib.crc32(payload):08x} ".encode() + payload + b"\n"
            f = self._open_segment()
            f.write(line)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            self._seg_records += 1
            intent.data.update(data)
            if self._seg_records >= self.segment_max_records:
                self._rotate()
        JOURNAL_RECORDS_TOTAL.inc(kind=intent.kind)
        JOURNAL_BYTES_TOTAL.inc(float(len(line)))
        JOURNAL_APPEND_SECONDS.observe(time.perf_counter() - t0)

    def close(self, iid: str, outcome: str = "done", **data) -> None:
        """Terminal transition; closing an unknown/already-closed intent
        is a no-op (recovery and the happy path may race)."""
        with self._lock:
            intent = self._intents.get(iid)
        if intent is None:
            return
        data = dict(data)
        data["outcome"] = outcome
        self._transition(iid, intent.kind, "closed", data)

    def intent(self, iid: str) -> Optional[Intent]:
        with self._lock:
            return self._intents.get(iid)

    def open_intents(self) -> Dict[str, Intent]:
        """Snapshot of the live index (open = not yet closed)."""
        with self._lock:
            return dict(self._intents)

    def open_of_kind(self, kind: str) -> List[Intent]:
        """Open intents of one kind, id-ordered. The carve/preempt paths
        use this to find a gang's durable carve records after a restart,
        when the in-memory gang→intent map is gone."""
        with self._lock:
            return sorted((i for i in self._intents.values()
                           if i.kind == kind), key=lambda i: i.id)

    def covered_nonces(self) -> Set[str]:
        """Launch nonces owned by open intents — the GC ↔ recovery
        handoff: capacity attributed to one of these is a journaled
        in-flight mutation, never a GC orphan. Covers both fleet-launch
        intents (``nonce``) and gang-bind intents (``nonces``, one per
        gang node launch)."""
        out: Set[str] = set()
        with self._lock:
            for i in self._intents.values():
                if i.kind == "fleet-launch" and i.data.get("nonce"):
                    out.add(str(i.data["nonce"]))
                elif i.kind == "gang-bind":
                    out.update(str(n) for n in i.data.get("nonces") or [])
        return out

    # -- compaction ---------------------------------------------------------
    def compact(self) -> int:
        """Rewrite the sealed segment set keeping only open intents'
        records; returns the number of segments removed."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        if self._file is not None:
            self._file.close()
            self._file = None
        old = self._segment_seqs()
        if not old:
            return 0
        self._seq = old[-1] + 1
        live: List[bytes] = []
        open_ids = set(self._intents)
        for seq in old:
            try:
                with open(self._segment_path(seq), "rb") as f:
                    for line in f.read().split(b"\n"):
                        if not line:
                            continue
                        rec = _decode_line(line)
                        if rec is not None and rec.get("id") in open_ids:
                            live.append(line)
            except OSError:
                continue
        # temp-write + fsync + rename: the compacted segment is atomic,
        # and the olds are only unlinked once it is durable
        path = self._segment_path(self._seq)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"\n".join(live) + (b"\n" if live else b""))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        removed = 0
        for seq in old:
            try:
                os.unlink(self._segment_path(seq))
                removed += 1
            except OSError:
                pass
        self._seq += 1  # appends land after the compacted segment
        self._closed_since_compact = 0
        JOURNAL_COMPACTIONS_TOTAL.inc()
        self._publish_gauges()
        return removed

    # -- lifecycle / introspection ------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "dir": self.dir,
                "open_intents": len(self._intents),
                "records_scanned": self._scanned,
                "torn_records": self._torn,
                "segments": len(self._segment_seqs()),
            }

    def sync(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())

    def close_journal(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "IntentJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close_journal()


def _decode_line(line: bytes) -> Optional[dict]:
    """One CRC-framed record, or None when torn/corrupt."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:]
    if zlib.crc32(payload) != crc:
        return None
    try:
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None
