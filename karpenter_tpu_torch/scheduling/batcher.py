"""Windowed pod batcher with bounded, priority-ordered intake.

Reference: pkg/controllers/provisioning/batcher.go. A copy of the JAX
package's batcher with its metrics (sheds, queue depth per shard, gang
hold and gang sheds), its SLO intake stamps and window marks, and its
``window-close`` trace event.
Separates a stream of add() calls into windows: 1 s idle / 10 s max / item
cap — the item cap defaults higher than the reference's 2k because the
solver's cost is sublinear in pods (shape-deduped).

Brownout extensions:

- **Hard depth bound** (``max_depth``): intake is no longer an unbounded
  ``queue.Queue`` a 50k-pod flood can grow until the process dies. A full
  queue sheds the incoming pod (reason ``depth-bound``) — unless the pod
  is system-critical, in which case the *worst* queued non-critical entry
  is displaced to make room (reason ``displaced``); its key is released
  immediately so the selection requeue re-offers it later.
- **Pressure-aware admission**: at L2+ the :mod:`karpenter_tpu_torch.pressure`
  shedding policy refuses low bands at add() time (``add`` returns None,
  no gate, no key registered). Shed pods re-enter through the selection
  controller's existing 5 s re-verify requeue — no new persistence.
- **Priority-ordered windows with aging**: wait() returns items ordered
  by (effective band rank, priority value desc, stable id). A pod's
  first-seen time persists across sheds (keyed re-adds), and every aging
  step promotes it one band, so sustained pressure cannot starve it.
- **Window shrink**: at L1+ the idle/max windows halve so assembly wall
  time — itself a pressure signal — is bounded under load.
- **Gang hold**: items added with ``gang=(key, size)``
  belong to an all-or-nothing pod group. Window assembly holds the group
  until ``size`` distinct members are queued — a partial gang never enters
  a solve window — and never splits a complete group at the item cap. A
  partial group older than ``gang_ttl_seconds`` is shed whole (reason
  ``gang-expired``), keys released immediately, so the selection requeue
  re-offers every member through the band-aware path.
- **Displaced gangs** (:meth:`Batcher.requeue_displaced`): a gang that
  priced preemption displaced is re-admitted whole under one lock, past
  band shedding and the depth bound (its members were running).

Callers block on the gate returned by add(); the provisioning worker
flushes the gate after a provisioning pass so selection reconcilers can
re-verify.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from karpenter_tpu_torch.metrics.gang import GANG_HOLD_SECONDS, GANGS_UNPLACEABLE_TOTAL
from karpenter_tpu_torch.metrics.pressure import INTAKE_QUEUE_DEPTH, PODS_SHED_TOTAL
from karpenter_tpu_torch.obs import slo, trace
from karpenter_tpu_torch.pressure import bands as _bands
from karpenter_tpu_torch.pressure.bands import RANK
from karpenter_tpu_torch.pressure.monitor import AGING_STEP_SECONDS

# first-seen bookkeeping: entries untouched this long are assumed deleted
# (a live shed pod re-touches its entry on every 5 s requeue)
FIRST_SEEN_TTL_SECONDS = 600.0
_FIRST_SEEN_SWEEP_MIN = 1024


class _Entry:
    __slots__ = ("seq", "item", "key", "band", "rank", "priority",
                 "first_seen", "sid", "gang", "gang_size")

    def __init__(self, seq: int, item: Any, key: Any, band: str, rank: int,
                 priority: int, first_seen: float,
                 gang: Any = None, gang_size: int = 0):
        self.seq = seq
        self.item = item
        self.key = key
        self.band = band
        self.rank = rank
        self.priority = priority
        self.first_seen = first_seen
        # gang identity + declared size: a gang is held out of windows
        # until gang_size distinct members are queued (or the TTL sheds it)
        self.gang = gang
        self.gang_size = gang_size
        # stable identity for deterministic ordering: the same pod set
        # sorts identically whatever the arrival interleaving (keyed items;
        # unkeyed test payloads fall back to arrival order)
        self.sid = str(key) if key is not None else f"~{seq:020d}"


class Batcher:
    def __init__(
        self,
        idle_seconds: float = 1.0,
        max_seconds: float = 10.0,
        max_items: int = 50_000,
        max_depth: int = 100_000,
        monitor=None,
        gang_ttl_seconds: float = 30.0,
    ):
        self.idle_seconds = idle_seconds
        self.max_seconds = max_seconds
        self.max_items = max_items
        self.max_depth = max_depth
        self.gang_ttl_seconds = gang_ttl_seconds
        self._monitor_obj = monitor
        # shard label for intake metrics ("" = unsharded: the unlabeled
        # series; the monitor's aggregate intake_queue_depth stays
        # unlabeled either way)
        self.shard = ""
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._entries: List[_Entry] = []
        self._seq = 0
        self._gate = threading.Event()
        self._running = True
        # keys awaiting a window (cleared as wait() consumes them, OR the
        # moment the entry is shed/displaced): lets the selection requeue
        # loop skip the full relax/validate/select path for a pod that is
        # already queued. A shed pod's key MUST leave this set immediately
        # or selection would skip re-queueing it forever.
        self._pending_keys: set = set()
        # key → (first_seen, last_touch): survives sheds so the aging term
        # accrues across re-adds; consumed keys drop their entry, deleted
        # pods age out via the TTL sweep
        self._first_seen: Dict[Any, Tuple[float, float]] = {}
        self._next_first_seen_sweep = 0.0
        # gang → monotonic time its hold started (first member seen while
        # the group was incomplete). Cleared when the gang is released into
        # a window or TTL-shed.
        self._gang_first: Dict[Any, float] = {}
        # monotonic counters for synchronizers (the controller tests):
        # added_total — items ADMITTED; consumed_total — items a wait()
        # window has picked up; processed_total — items whose window has
        # been FLUSHED (provisioning pass complete). A pod is fully
        # processed once processed_total passes its add position — exact
        # even when the pod lands in the window after the one in flight
        # (the pre-captured-gate race, advisor finding r3). Shed items are
        # counted in `shed`, never in added_total (they were refused, and
        # a synchronizer waiting on them would deadlock).
        self.added_total = 0
        self.consumed_total = 0
        self.processed_total = 0
        self.shed: Dict[Tuple[str, str], int] = {}  # (reason, band) → count
        # SLO side channel: (band, intake_seconds) per item of the LAST
        # window, aligned index for index with wait()'s returned items. The
        # worker reads it right after wait() on the same thread, before the
        # next window can overwrite it. None while SLO stamping is off.
        self.last_window_meta: Optional[List[Tuple[str, float]]] = None

    # -- pressure plumbing ---------------------------------------------------
    def _monitor(self):
        if self._monitor_obj is not None:
            return self._monitor_obj
        from karpenter_tpu_torch.pressure import get_monitor

        return get_monitor()

    def _count_shed_locked(self, reason: str, band: str) -> None:
        self.shed[(reason, band)] = self.shed.get((reason, band), 0) + 1
        if self.shard:
            PODS_SHED_TOTAL.inc(reason=reason, priority_band=band, shard=self.shard)
        else:
            PODS_SHED_TOTAL.inc(reason=reason, priority_band=band)

    def _note_depth(self, monitor, depth: int) -> None:
        monitor.note_depth(id(self), depth)
        if self.shard:
            INTAKE_QUEUE_DEPTH.set(float(depth), shard=self.shard)

    def shed_total(self, band: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for (_, b), n in self.shed.items()
                       if band is None or b == band)

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- intake --------------------------------------------------------------
    def add(self, item: Any, key: Any = None, band: str = "default",
            priority: int = 0,
            gang: Optional[Tuple[Any, int]] = None
            ) -> Optional[threading.Event]:
        """Enqueue an item; returns the gate event the caller may wait on
        (batcher.go:61-69), or **None when the item was shed** (pressure
        level refused its band, or the depth bound is hit). ``key``
        (optional) registers the item for :meth:`contains` until its window
        is consumed. The key is registered BEFORE the item becomes
        consumable so a concurrent wait() can never observe the item yet
        miss the key (which would strand it forever). ``gang`` —
        (gang key, declared size) — marks the item as a gang member: the
        window assembly holds the whole group back until ``size`` distinct
        members are queued, and sheds the partial group after
        ``gang_ttl_seconds`` (reason ``gang-expired``, keys released so the
        selection requeue re-offers the members band-aware)."""
        monitor = self._monitor()
        level = int(monitor.level())
        now = time.monotonic()
        rank = RANK.get(band, RANK["default"])
        with self._cv:
            first_seen = now
            if key is not None:
                prev = self._first_seen.get(key)
                if prev is not None:
                    first_seen = prev[0]
                self._first_seen[key] = (first_seen, now)
                self._sweep_first_seen_locked(now)
            eff = _bands.effective_rank(rank, now - first_seen,
                                        AGING_STEP_SECONDS)
            reason = _bands.shed_reason(eff, level)
            if reason is None and len(self._entries) >= self.max_depth:
                if rank == 0:
                    # never shed system-critical: displace the worst queued
                    # non-critical entry instead (or overflow by the
                    # handful of critical pods a cluster actually has)
                    self._displace_locked(now)
                else:
                    reason = "depth-bound"
            if reason is not None:
                self._count_shed_locked(reason, band)
                depth = len(self._entries)
            else:
                entry = _Entry(self._seq, item, key, band, rank, priority,
                               first_seen,
                               gang=gang[0] if gang else None,
                               gang_size=gang[1] if gang else 0)
                self._seq += 1
                self._entries.append(entry)
                if key is not None:
                    self._pending_keys.add(key)
                self.added_total += 1
                gate = self._gate
                depth = len(self._entries)
                self._cv.notify()
        self._note_depth(monitor, depth)
        return None if reason is not None else gate

    def _displace_locked(self, now: float) -> None:
        victims = [e for e in self._entries if e.rank != 0]
        if not victims:
            return  # all queued entries are critical too: admit over bound
        worst = max(victims, key=lambda e: self._sort_key(e, now, AGING_STEP_SECONDS))
        self._entries.remove(worst)
        if worst.key is not None:
            # release the key NOW: selection's next requeue must re-offer
            # the displaced pod, not skip it as "already pending"
            self._pending_keys.discard(worst.key)
        self._count_shed_locked("displaced", worst.band)
        # a displaced pod's latency objective is burning without ever
        # producing a bind sample: feed the burn sentinel directly
        slo.note_shed(worst.band)

    def requeue_displaced(self, entries) -> int:
        """Atomically re-enqueue a preempted gang's members: one lock
        acquisition admits the whole group, so window assembly never sees
        a partial gang. ``entries`` is a list of ``(item, key, band,
        priority, gang)`` tuples, the fields :meth:`add` takes. Unlike
        :meth:`add` this bypasses band shedding and the depth bound: the
        members were RUNNING until the provisioner displaced them, so
        dropping them here would turn a priced preemption into lost
        capacity. Returns the number of entries admitted (all of them)."""
        now = time.monotonic()
        with self._cv:
            for item, key, band, priority, gang in entries:
                rank = RANK.get(band, RANK["default"])
                first_seen = now
                if key is not None:
                    prev = self._first_seen.get(key)
                    if prev is not None:
                        first_seen = prev[0]
                    self._first_seen[key] = (first_seen, now)
                entry = _Entry(self._seq, item, key, band, rank, priority, first_seen,
                               gang=gang[0] if gang else None,
                               gang_size=gang[1] if gang else 0)
                self._seq += 1
                self._entries.append(entry)
                if key is not None:
                    self._pending_keys.add(key)
                self.added_total += 1
            if entries:
                self._cv.notify()
            depth = len(self._entries)
        self._note_depth(self._monitor(), depth)
        return len(entries)

    def contains(self, key: Any) -> bool:
        """True while an item added with ``key`` awaits a window. Returns
        False the moment wait() consumes it — or the moment it is shed or
        displaced — so the caller's next requeue performs the full
        re-verification/re-add."""
        with self._lock:
            return key in self._pending_keys

    def _sweep_first_seen_locked(self, now: float) -> None:
        if (len(self._first_seen) < _FIRST_SEEN_SWEEP_MIN
                or now < self._next_first_seen_sweep):
            return
        self._first_seen = {
            k: v for k, v in self._first_seen.items()
            if now - v[1] < FIRST_SEEN_TTL_SECONDS}
        self._next_first_seen_sweep = now + FIRST_SEEN_TTL_SECONDS / 4

    # -- lifecycle -----------------------------------------------------------
    def flush(self) -> None:
        """Release all waiters and open a new gate (batcher.go:72-77)."""
        with self._lock:
            # wait() → provision → flush() run sequentially in the worker
            # thread, so everything consumed so far has now been processed
            self.processed_total = self.consumed_total
            self._gate.set()
            self._gate = threading.Event()

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._monitor().forget_source(id(self))

    # -- gang hold (all-or-nothing groups) -----------------------------------
    def _gang_gate_locked(self, now: float) -> set:
        """Seqs of gang members to hold OUT of this window because their
        group is incomplete. Partial groups past ``gang_ttl_seconds`` (and
        groups that can never fit one window) are shed here instead:
        entries leave the queue, keys release IMMEDIATELY so the selection
        requeue re-offers every member band-aware — never a silent drop —
        and first_seen persists so aging keeps accruing across the shed."""
        held: set = set()
        groups: Dict[Any, List[_Entry]] = {}
        for e in self._entries:
            if e.gang is not None:
                groups.setdefault(e.gang, []).append(e)
        if not groups:
            return held
        for gkey, members in groups.items():
            distinct = {m.key if m.key is not None else m.seq
                        for m in members}
            size = max(m.gang_size for m in members)
            if len(distinct) >= size and size <= self.max_items:
                continue  # complete: enters this window
            reason = None
            if size > self.max_items:
                reason = "gang-oversize"
            first = self._gang_first.setdefault(gkey, now)
            if reason is None and now - first > self.gang_ttl_seconds:
                reason = "gang-expired"
            if reason is None:
                held.update(m.seq for m in members)
                continue
            shed_seqs = {m.seq for m in members}
            self._entries = [e for e in self._entries
                             if e.seq not in shed_seqs]
            for m in members:
                if m.key is not None:
                    self._pending_keys.discard(m.key)
                self._count_shed_locked(reason, m.band)
                slo.note_shed(m.band)
            self._gang_first.pop(gkey, None)
            GANGS_UNPLACEABLE_TOTAL.inc(
                reason="oversize" if reason == "gang-oversize" else "expired")
        return held

    def _trim_split_gangs(self, take: List[_Entry]) -> List[_Entry]:
        """Never split a gang at the item cap: members whose group the cap
        cut in half stay queued (the group is still complete, so a
        following window carries it whole)."""
        in_take: Dict[Any, set] = {}
        size_of: Dict[Any, int] = {}
        for e in take:
            if e.gang is not None:
                in_take.setdefault(e.gang, set()).add(
                    e.key if e.key is not None else e.seq)
                size_of[e.gang] = max(size_of.get(e.gang, 0), e.gang_size)
        cut = {g for g, ks in in_take.items() if len(ks) < size_of[g]}
        if not cut:
            return take
        return [e for e in take if e.gang not in cut]

    def _note_gangs_released_locked(self, take: List[_Entry], now: float) -> None:
        """Observe the hold time of every gang this window carries and stop
        its TTL clock."""
        done: set = set()
        for e in take:
            if e.gang is None or e.gang in done:
                continue
            done.add(e.gang)
            first = self._gang_first.pop(e.gang, None)
            if first is None:
                first = e.first_seen
            GANG_HOLD_SECONDS.observe(max(0.0, now - first))

    # -- window assembly -----------------------------------------------------
    @staticmethod
    def _sort_key(entry: _Entry, now: float, aging_step: float):
        eff = _bands.effective_rank(entry.rank, now - entry.first_seen,
                                    aging_step)
        return (eff, -entry.priority, entry.sid)

    def wait(self) -> Tuple[List[Any], float]:
        """Collect one windowed batch (batcher.go:80-103): starts at the
        first item; extends on arrivals up to idle/max/size limits; returns
        items in priority order (band rank with aging, then priority value,
        then stable id)."""
        monitor = self._monitor()
        level = int(monitor.level())
        # L1+ window shrink: half windows bound assembly wall time (which
        # is itself a pressure signal — shrinking breaks the feedback loop)
        idle = self.idle_seconds / 2 if level >= 1 else self.idle_seconds
        max_s = self.max_seconds / 2 if level >= 1 else self.max_seconds
        with self._cv:
            while self._running and not self._entries:
                self._cv.wait()
            if not self._running:
                return [], 0.0
            start = time.monotonic()
            deadline = start + max_s
            while self._running and len(self._entries) < self.max_items:
                seen = len(self._entries)
                timeout = min(idle, deadline - time.monotonic())
                if timeout <= 0:
                    break
                self._cv.wait(timeout)
                if len(self._entries) <= seen:
                    break  # idle window expired with no new arrivals
            now = time.monotonic()
            # gang gate: a partial gang never enters a window. Incomplete
            # groups hold; groups past the TTL (or larger than a window)
            # shed here through the band-aware requeue path.
            held = self._gang_gate_locked(now)
            ordered = sorted((e for e in self._entries if e.seq not in held),
                             key=lambda e: self._sort_key(e, now, AGING_STEP_SECONDS))
            take = ordered[:self.max_items]
            if len(take) < len(ordered):
                take = self._trim_split_gangs(take)
            self._note_gangs_released_locked(take, now)
            if len(take) < len(self._entries):
                taken_seqs = {e.seq for e in take}
                self._entries = [e for e in self._entries
                                 if e.seq not in taken_seqs]
            else:
                self._entries = []
            for e in take:
                if e.key is not None:
                    self._pending_keys.discard(e.key)
                    self._first_seen.pop(e.key, None)
            self.consumed_total += len(take)
            depth = len(self._entries)
        self._note_depth(monitor, depth)
        window = now - start
        monitor.note_window(window)
        # SLO intake stage: enqueue (first_seen, which persists across
        # sheds, so aging waits count) → this window close. The per-item
        # metadata rides the side channel so the worker can stamp the
        # later stages and e2e without re-deriving bands.
        meta = None
        if slo.enabled():
            meta = []
            for e in take:
                intake_s = now - e.first_seen
                slo.record(e.band, "intake", intake_s)
                meta.append((e.band, intake_s))
        self.last_window_meta = meta
        # an instant event only (the caller owns the window span and
        # records the intake child retroactively)
        trace.event("window-close", items=len(take), depth_left=depth,
                    window_s=round(window, 4), pressure_level=level)
        return [e.item for e in take], window
