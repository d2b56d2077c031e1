"""Startup recovery: replay the write-ahead intent journal before the
control plane serves.

A copy of the JAX package's ``controllers/recovery.py``. It runs once,
before any other controller starts (``recovering()`` stays true, and
``wait()`` blocks, until it completes). Every intent the
crashed process left open (runtime/journal.py) is re-derived against the
two sources of truth that survive a crash — kubecore objects and
``CloudProvider.list_instances()`` — and resolved one of three ways:

- **forward**: the mutation visibly succeeded past the point of no
  return — finish it (bind the member pods whose node exists, strip the
  finalizer whose instance is already gone, re-issue the drain delete).
- **rollback**: it did not — undo it exactly once (terminate the
  nonce-attributed instances no Node ever backed, unwind the partially
  created/bound gang). Every rollback trips the flight recorder
  (``recovery-rollback``) so a restart that lost work leaves a dump.
- **noop**: live state already converged (nothing launched, node
  already gone) — just close the intent.

Replay/rollback rules per kind:

fleet-launch  any open phase → every ``list_instances()`` record carrying
              the journaled nonce either backs a Node (forward: leave it,
              the bind intent owns the rest) or does not (rollback:
              ``delete_instance``). The GC controller skips journal-
              covered nonces, so this is the only terminator.
bind          node exists → roll forward: bind the journaled member pods
              that are still unbound, close. Node absent → noop (the
              fleet-launch intent owns the capacity).
gang-bind     phase ``bound`` → forward-close. ``unwound`` → close. Any
              other phase (including mid-``unwinding``) → re-run the full
              unwind idempotently: clear members bound to gang nodes,
              tear down every journaled created node (instance delete +
              finalizer strip + object delete), and delete any instance
              carrying one of the gang's journaled launch nonces that no
              Node ever backed.
drain         node exists without a deletionTimestamp → re-issue the
              delete (forward); else noop.
node-delete   node gone but its instance still listed → finish the
              instance delete (forward). Node present at phase
              ``instance-deleted`` → strip the finalizer (forward);
              at ``open`` → noop, the termination controller re-drives.
carve         replayed FIRST (before every other kind): node exists →
              re-commit the record into the occupancy ledger and leave
              the intent OPEN (an open carve IS the durable ledger
              entry); node gone → close (noop). Idempotent re-commit.
preempt       phase ``beneficiary-bound`` → pure close (forward).
              Phase ``open`` with every journaled member still bound to
              the journaled node → close, nothing happened (noop).
              Otherwise roll forward once: finish the unbind, pop the
              victim's rebuilt carve (closing its carve intents), and
              re-admit live unbound victims via the batcher hook.

Intents resolve in the order (carve, preempt, the rest), each group by
intent id, a ``uuid4`` draw: not the order they were appended in. After
all intents resolve the journal is compacted and ``recovering()`` flips
false. The controller also has the Manager protocol's time-driven no-op
shape (``kind()`` / ``seeds()`` / ``reconcile``), but correctness only
needs the explicit ``run()``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch import pressure
from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.gang import gang_of
from karpenter_tpu_torch.cloudprovider.spi import CloudProvider
from karpenter_tpu_torch.metrics.recovery import (
    LEDGER_RECOVERED_CARVES_TOTAL, LEDGER_RECOVERY_SECONDS,
    RECOVERY_INTENTS_TOTAL, RECOVERY_SECONDS)
from karpenter_tpu_torch.obs import flight
from karpenter_tpu_torch.ops import topology as topo_ops
from karpenter_tpu_torch.runtime.journal import Intent, IntentJournal
from karpenter_tpu_torch.runtime.kubecore import ApiError, KubeCore, NotFound

log = logging.getLogger("karpenter.recovery")


class _NoChange(Exception):
    pass


class RecoveryController:
    """One-shot journal replay; ``recovering()`` is true until it ends."""

    def __init__(self, kube: KubeCore, cloud_provider: CloudProvider,
                 journal: IntentJournal, requeue_displaced=None):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.journal = journal
        # optional batcher hook (Batcher.requeue_displaced-shaped): when
        # set, preempt roll-forward re-admits the victims directly; when
        # None (no batcher exists yet at recovery time) the unbound victims
        # are Pending and the selection controller re-enters them
        self.requeue_displaced = requeue_displaced
        self._done = threading.Event()
        self.stats: Dict[str, int] = {"forward": 0, "rollback": 0,
                                      "noop": 0, "errors": 0}

    # -- readiness gate ------------------------------------------------------
    def recovering(self) -> bool:
        return not self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    # -- manager protocol (visibility only) ----------------------------------
    def kind(self) -> Optional[str]:
        return None

    def seeds(self) -> List[Tuple[str, str]]:
        return []

    def reconcile(self, name: str, namespace: str = "") -> Optional[float]:
        return None

    # -- the replay ----------------------------------------------------------
    def run(self) -> Dict[str, int]:
        t0 = time.perf_counter()
        open_intents = self.journal.open_intents()
        try:
            records = self.cloud_provider.list_instances()
        except Exception:  # noqa: BLE001 — same fail-safe bias as GC
            log.exception("list_instances failed during recovery; capacity-"
                          "side rollback skipped this startup")
            records = []
        # carve intents replay FIRST so the occupancy ledger is whole
        # before any other rule consults or releases it (a preempt
        # roll-forward pops the victim's rebuilt carve; a gang-bind
        # unwind's node teardown drops the node's carves), then preempts,
        # then everything else, each group in intent-id order
        order = {"carve": 0, "preempt": 1}
        ledger_s = 0.0
        saw_carve = False
        try:
            for intent in sorted(open_intents.values(),
                                 key=lambda i: (order.get(i.kind, 2), i.id)):
                t_int = time.perf_counter()
                try:
                    action = self._resolve(intent, records)
                except Exception:  # noqa: BLE001 — one bad intent must not
                    # wedge startup; it stays open for the next restart
                    log.exception("resolving %s intent %s failed",
                                  intent.kind, intent.id)
                    self.stats["errors"] += 1
                    continue
                finally:
                    if intent.kind == "carve":
                        saw_carve = True
                        ledger_s += time.perf_counter() - t_int
                self.stats[action] += 1
                RECOVERY_INTENTS_TOTAL.inc(kind=intent.kind, action=action)
                log.info("recovered %s intent %s (phase=%s): %s",
                         intent.kind, intent.id, intent.phase, action)
            self.journal.compact()
        finally:
            if saw_carve:
                LEDGER_RECOVERY_SECONDS.observe(ledger_s)
            RECOVERY_SECONDS.observe(time.perf_counter() - t0)
            self._done.set()
        if self.stats["rollback"]:
            flight.trip("recovery-rollback",
                        rollbacks=self.stats["rollback"],
                        forward=self.stats["forward"],
                        noop=self.stats["noop"])
        log.info("recovery complete in %.3fs: %s",
                 time.perf_counter() - t0, self.stats)
        return dict(self.stats)

    def _resolve(self, intent: Intent, records) -> str:
        handler = {
            "fleet-launch": self._resolve_fleet_launch,
            "bind": self._resolve_bind,
            "gang-bind": self._resolve_gang_bind,
            "drain": self._resolve_drain,
            "node-delete": self._resolve_node_delete,
            "carve": self._resolve_carve,
            "preempt": self._resolve_preempt,
        }.get(intent.kind)
        if handler is None:
            self.journal.close(intent.id, outcome="unknown-kind")
            return "noop"
        return handler(intent, records)

    # -- per-kind rules ------------------------------------------------------
    def _backed_ids(self) -> set:
        """Every instance id appearing as a providerID path segment of
        some Node (the GC controller's ownership test)."""
        def extract(n):
            pid = getattr(n.spec, "provider_id", "") or ""
            return frozenset(s for s in pid.split("/") if s)
        backed: set = set()
        for segments in self.kube.scan("Node", extract):
            backed |= segments
        return backed

    def _node_by_instance(self) -> Dict[str, str]:
        """instance id (providerID path segment) → Node name."""
        def extract(n):
            pid = getattr(n.spec, "provider_id", "") or ""
            return (n.metadata.name,
                    frozenset(s for s in pid.split("/") if s))
        out: Dict[str, str] = {}
        for name, segments in self.kube.scan("Node", extract):
            for seg in segments:
                out[seg] = name
        return out

    def _resolve_fleet_launch(self, intent: Intent, records) -> str:
        nonce = intent.data.get("nonce")
        if not nonce:
            self.journal.close(intent.id, outcome="no-nonce")
            return "noop"
        mine = [r for r in records if r.launch_nonce == nonce]
        if not mine:
            # crash before (or instead of) the provider launch: nothing to
            # undo — the pods are still pending and re-provision normally
            self.journal.close(intent.id, outcome="nothing-launched")
            return "noop"
        backed = self._backed_ids()
        rolled_back = 0
        for r in mine:
            if r.instance_id in backed:
                continue  # a Node landed: the launch made it, keep it
            err = self.cloud_provider.delete_instance(r.instance_id)
            if err is not None:
                raise RuntimeError(
                    f"terminating orphan {r.instance_id}: {err}")
            rolled_back += 1
            log.info("recovery terminated orphan instance %s (nonce=%s)",
                     r.instance_id, nonce)
        self.journal.close(
            intent.id,
            outcome="rolled-back" if rolled_back else "converged")
        return "rollback" if rolled_back else "forward"

    def _resolve_bind(self, intent: Intent, records) -> str:
        node_name = str(intent.data.get("node") or "")
        if not node_name:
            self.journal.close(intent.id, outcome="no-node")
            return "noop"
        try:
            self.kube.get("Node", node_name, "")
        except NotFound:
            # node never landed; the capacity (if launched) is the fleet-
            # launch intent's to resolve
            self.journal.close(intent.id, outcome="node-missing")
            return "noop"
        # roll forward: bind the journaled members that are still unbound
        pending = []
        for ref in intent.data.get("pods") or []:
            ns, _, name = str(ref).partition("/")
            try:
                pod = self.kube.get("Pod", name, ns)
            except NotFound:
                continue
            if not getattr(pod.spec, "node_name", ""):
                pending.append(pod)
        if pending:
            try:
                errs = self.kube.bind_pods(pending, node_name)
            except ApiError as e:
                errs = [str(e)]
            errs = [e for e in errs
                    if e and "already bound" not in e
                    and "already exists" not in e]
            if errs:
                raise RuntimeError(
                    f"re-binding to {node_name}: " + "; ".join(errs))
        self.journal.close(intent.id, outcome="bound")
        return "forward" if pending else "noop"

    def _resolve_gang_bind(self, intent: Intent, records) -> str:
        if intent.phase == "bound":
            # the bind landed; the crash may have beaten the carve-intent
            # opens that follow it. The ``bound`` append carries the full
            # carve payload, so re-commit any carve that has no open
            # carve intent of its own yet (dedupe by (gang, node) — a
            # crash AFTER the opens must not double-journal the carve)
            self._recommit_carves(intent)
            self.journal.close(intent.id, outcome="bound")
            return "forward"
        if intent.phase == "unwound":
            self.journal.close(intent.id, outcome="unwound")
            return "noop"
        # every other phase — open (mid phase 1), nodes-created (mid
        # bind), unwinding (mid rollback) — resolves by the same
        # idempotent full unwind: a gang is atomic or absent
        created = [str(n) for n in intent.data.get("created") or []]
        nodes = set(str(n) for n in intent.data.get("nodes") or [])
        nodes.update(created)
        members = [str(m) for m in intent.data.get("members") or []]
        did = 0
        # the gang's launch nonces are durable BEFORE each provider
        # create, so a crash landing between the instance launch and the
        # created-set note still resolves: any instance carrying one of
        # them is this gang's — tear down its Node if one landed, delete
        # the bare instance if not
        nonces = {str(n) for n in intent.data.get("nonces") or []}
        if nonces:
            gang_records = [r for r in records if r.launch_nonce in nonces]
            if gang_records:
                by_instance = self._node_by_instance()
                for r in gang_records:
                    name = by_instance.get(r.instance_id)
                    if name is not None:
                        nodes.add(name)
                        if name not in created:
                            created.append(name)
                    else:
                        err = self.cloud_provider.delete_instance(
                            r.instance_id)
                        if err is not None:
                            raise RuntimeError(
                                f"deleting gang instance "
                                f"{r.instance_id}: {err}")
                        did += 1
                        log.info("recovery deleted unbacked gang "
                                 "instance %s", r.instance_id)
        for ref in members:
            ns, _, name = ref.partition("/")
            def clear(obj):
                if getattr(obj.spec, "node_name", "") in nodes:
                    obj.spec.node_name = ""
                else:
                    raise _NoChange
            try:
                self.kube.patch("Pod", name, ns, clear)
                did += 1
            except (_NoChange, NotFound):
                pass
        for name in created:
            if self._teardown_node(name):
                did += 1
        self.journal.close(intent.id, outcome="unwound")
        return "rollback" if did else "noop"

    def _recommit_carves(self, intent: Intent) -> None:
        """Re-open the carve intents a crashed gang bind journaled only
        inside its ``bound`` record. Idempotent: carves whose own intent
        already exists (the crash hit after the opens) are skipped, and
        ledger commits overwrite, so replaying twice yields the same
        state. Carves on nodes that did not survive are dropped — their
        cells are not capacity anymore."""
        carves = intent.data.get("carves") or []
        if not carves:
            return
        live = {(str(c.data.get("gang") or ""), str(c.data.get("node") or ""))
                for c in self.journal.open_of_kind("carve")}
        for rec in carves:
            if not isinstance(rec, dict):
                continue
            gang = str(rec.get("gang") or "")
            node = str(rec.get("node") or "")
            if not node or (gang, node) in live:
                continue
            try:
                self.kube.get("Node", node, "")
            except NotFound:
                continue
            dims = tuple(int(d) for d in rec.get("grid") or [])
            cells = [int(c) for c in rec.get("cells") or []]
            if not dims or not cells:
                continue
            sig = topo_ops.sig_from_json(rec.get("sig") or ((), ()))
            pods = []
            for ref in rec.get("pods") or []:
                ns, _, pname = str(ref).partition("/")
                pods.append((ns, pname))
            cid = self.journal.open_intent(
                "carve", gang=gang, node=node, grid=list(dims),
                type=str(rec.get("type") or ""), sig=sig, cells=cells,
                band=str(rec.get("band") or "default"),
                pods=[f"{ns}/{nm}" for ns, nm in pods])
            topo_ops.LEDGER.commit(
                node, dims, str(rec.get("type") or ""), sig, gang, cells,
                str(rec.get("band") or "default"), pods, intent_id=cid)
            LEDGER_RECOVERED_CARVES_TOTAL.inc()

    def _resolve_carve(self, intent: Intent, records) -> str:
        """Rebuild one occupancy-ledger entry from its durable carve
        intent. Carve intents are LONG-LIVED: open = the carve is live,
        so this handler re-commits the record and leaves the intent
        OPEN — compaction keeps it, and it closes only when the gang
        releases, is preempted, or its node is pruned/torn down.
        Re-commit is idempotent (ledger overwrite semantics), so a
        double replay yields the identical ledger."""
        node = str(intent.data.get("node") or "")
        if not node:
            self.journal.close(intent.id, outcome="no-node")
            return "noop"
        try:
            self.kube.get("Node", node, "")
        except NotFound:
            # the carved node did not survive the crash: the cells are
            # not capacity anymore, fold the intent
            self.journal.close(intent.id, outcome="node-gone")
            return "noop"
        dims = tuple(int(d) for d in intent.data.get("grid") or [])
        cells = [int(c) for c in intent.data.get("cells") or []]
        if not dims or not cells:
            self.journal.close(intent.id, outcome="malformed")
            return "noop"
        sig = topo_ops.sig_from_json(intent.data.get("sig") or ((), ()))
        pods = []
        for ref in intent.data.get("pods") or []:
            ns, _, pname = str(ref).partition("/")
            pods.append((ns, pname))
        topo_ops.LEDGER.commit(
            node, dims, str(intent.data.get("type") or ""), sig,
            str(intent.data.get("gang") or ""), cells,
            str(intent.data.get("band") or "default"), pods,
            intent_id=intent.id)
        LEDGER_RECOVERED_CARVES_TOTAL.inc()
        return "forward"

    def _resolve_preempt(self, intent: Intent, records) -> str:
        """Replay one crashed displacement:

        - phase ``beneficiary-bound`` — the displacement fully happened
          and the winner's members landed; the crash hit mid-close, so
          replay is a pure close (forward).
        - phase ``open`` with EVERY journaled member still bound to the
          journaled node — the crash beat the first unbind; nothing
          happened, the victims keep running (noop).
        - anything else (phase ``victims-unbound``, or ``open`` with a
          partial unbind) — roll the displacement forward exactly once:
          finish unbinding, release the victim's rebuilt carve cells
          (closing their carve intents), and re-admit every live
          unbound victim through the batcher hook.
        """
        gang = str(intent.data.get("gang") or "")
        node = str(intent.data.get("node") or "")
        if intent.phase == "beneficiary-bound":
            self.journal.close(intent.id, outcome="bound")
            return "forward"
        live = []
        bound_here = 0
        for ref in intent.data.get("pods") or []:
            ns, _, pname = str(ref).partition("/")
            try:
                pod = self.kube.get("Pod", pname, ns)
            except NotFound:
                continue
            live.append((ns, pname))
            if getattr(pod.spec, "node_name", "") == node:
                bound_here += 1
        if intent.phase == "open" and live and bound_here == len(live):
            # crash before the first unbind: the displacement never
            # started and the planner will re-price it (or not) fresh
            self.journal.close(intent.id, outcome="not-started")
            return "noop"

        def clear(obj):
            if getattr(obj.spec, "node_name", "") == node:
                obj.spec.node_name = ""
            else:
                raise _NoChange

        for ns, pname in live:
            try:
                self.kube.patch("Pod", pname, ns, clear)
            except (_NoChange, NotFound):
                pass
        for _n, rec in topo_ops.LEDGER.pop_gang(gang):
            if rec.intent_id:
                self.journal.close(rec.intent_id, outcome="preempted")
        if self.requeue_displaced is not None and live:
            entries = []
            for ns, pname in live:
                try:
                    p = self.kube.get("Pod", pname, ns)
                except NotFound:
                    continue
                if getattr(p.spec, "node_name", ""):
                    continue  # already re-bound elsewhere; not displaced
                band, priority = pressure.classify(p)
                gspec = gang_of(p)
                g = ((gspec.key, gspec.size)
                     if gspec is not None and not gspec.error else None)
                entries.append(((None, p), (ns, pname), band, priority, g))
            if entries:
                self.requeue_displaced(entries)
        self.journal.close(intent.id, outcome="victims-readmitted")
        return "forward"

    def _teardown_node(self, name: str) -> bool:
        """Direct teardown — instance delete, finalizer strip, object
        delete — because the termination controller is not running yet.
        Idempotent: every step tolerates already-done."""
        try:
            node = self.kube.get("Node", name, "")
        except NotFound:
            return False
        err = self.cloud_provider.delete(node)
        if err is not None and "not found" not in str(err).lower():
            raise RuntimeError(f"deleting instance of {name}: {err}")

        def strip(live):
            if wellknown.TERMINATION_FINALIZER in live.metadata.finalizers:
                live.metadata.finalizers = [
                    f for f in live.metadata.finalizers
                    if f != wellknown.TERMINATION_FINALIZER]
            else:
                raise _NoChange
        try:
            self.kube.patch("Node", name, "", strip)
        except (_NoChange, NotFound):
            pass
        try:
            self.kube.delete("Node", name, "")
        except (NotFound, ApiError):
            pass
        # the node's carves (rebuilt by the carve-first replay above) go
        # with it — release the cells and fold their durable intents
        for rec in topo_ops.LEDGER.pop_node(name):
            if rec.intent_id:
                self.journal.close(rec.intent_id, outcome="node-torn-down")
        log.info("recovery tore down gang node %s", name)
        return True

    def _resolve_drain(self, intent: Intent, records) -> str:
        name = str(intent.data.get("node") or "")
        ns = str(intent.data.get("namespace") or "")
        try:
            node = self.kube.get("Node", name, ns)
        except NotFound:
            self.journal.close(intent.id, outcome="gone")
            return "noop"
        if node.metadata.deletion_timestamp is not None:
            # the delete landed; termination finishes it
            self.journal.close(intent.id, outcome="deleting")
            return "noop"
        # the drain was decided (and journaled) but the delete never
        # landed: re-issue it so the consolidation plan is not lost
        try:
            self.kube.delete("Node", name, ns)
        except NotFound:
            pass
        self.journal.close(intent.id, outcome="re-drained")
        return "forward"

    def _resolve_node_delete(self, intent: Intent, records) -> str:
        name = str(intent.data.get("node") or "")
        provider_id = str(intent.data.get("provider_id") or "")
        segments = frozenset(s for s in provider_id.split("/") if s)
        try:
            node = self.kube.get("Node", name, "")
        except NotFound:
            node = None
        if node is not None:
            if intent.phase == "instance-deleted":
                # instance gone, finalizer strip crashed: finish it
                def strip(live):
                    if wellknown.TERMINATION_FINALIZER \
                            in live.metadata.finalizers:
                        live.metadata.finalizers = [
                            f for f in live.metadata.finalizers
                            if f != wellknown.TERMINATION_FINALIZER]
                    else:
                        raise _NoChange
                try:
                    self.kube.patch("Node", name, "", strip)
                except (_NoChange, NotFound):
                    pass
                self.journal.close(intent.id, outcome="finalizer-stripped")
                return "forward"
            # phase open with the Node still present: the termination
            # controller re-reconciles it from the deletionTimestamp
            self.journal.close(intent.id, outcome="termination-redrives")
            return "noop"
        # node object gone; make sure the instance went with it
        leftover = [r for r in records if r.instance_id in segments]
        for r in leftover:
            err = self.cloud_provider.delete_instance(r.instance_id)
            if err is not None:
                raise RuntimeError(
                    f"deleting leftover instance {r.instance_id}: {err}")
            log.info("recovery deleted leftover instance %s of node %s",
                     r.instance_id, name)
        self.journal.close(intent.id, outcome="done")
        return "forward" if leftover else "noop"
