"""Capacity garbage collection: reap what crashed provisioning left behind.

A copy of the JAX package's ``controllers/gc.py``. Upstream analog:
sigs.k8s.io/karpenter's instance garbage-collection controller
(pkg/controllers/nodeclaim/garbagecollection). This codebase has
no NodeClaim intermediary, so the crash window is wider: a controller that
dies between ``CloudProvider.create`` launching capacity and the Node write
landing leaks a running instance no Kubernetes object remembers. The
launch-nonce/provisioner tags stamped at CreateFleet time (before any Node
exists) make such capacity enumerable and attributable; this controller
closes the loop by cross-referencing ``list_instances()`` against Nodes in
BOTH directions:

- **Orphaned instance** — provider-side capacity older than the grace
  window whose instance id backs no Node: terminated via
  ``delete_instance``. The grace window covers the legitimate launch→bind
  latency (an instance seconds old is probably mid-bind, not leaked).

- **Ghost node** — a Node carrying this provider's providerID, older than
  the grace window, whose backing instance the provider no longer reports:
  deleted through the normal finalizer flow, so drain/evict/provider.delete
  all run (and provider deletion of already-gone capacity is NotFound →
  success by SPI contract).

Ownership test: a record backs a Node iff the instance id appears verbatim
as a path segment of the Node's providerID (``aws:///<zone>/<id>``,
``fake:///<id>/<zone>`` — segment containment sidesteps the per-provider
ordering). Only Nodes whose providerID starts with ``<provider>://`` are
considered at all; nodes from other provisioners/providers are invisible.

Fail-safe bias: if ``list_instances()`` raises, the sweep is skipped
entirely — an empty-looking provider must never read as "every node is a
ghost". Per-item delete failures are logged and retried next interval.

The controller is time-driven (``kind() -> None`` + one seeded key) and
self-perpetuates by returning its interval from ``reconcile``; main.py
registers it with the Manager (runtime/manager.py), which seeds the key.
Capacity whose launch nonce an open journal intent covers is skipped:
startup recovery owns it.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from karpenter_tpu_torch.cloudprovider.spi import CloudProvider
from karpenter_tpu_torch.metrics.registry import DEFAULT
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.utils import clock

log = logging.getLogger("karpenter.gc")

DEFAULT_INTERVAL_SECONDS = 120.0
# must comfortably exceed launch→bind latency (CreateFleet + 3×1 s describe
# retry + node create); upstream uses 10 min for the same reason
DEFAULT_GRACE_SECONDS = 600.0

_TERMINATED = DEFAULT.counter(
    "gc_instances_terminated_total",
    "Leaked provider instances terminated by the capacity GC")
_REMOVED = DEFAULT.counter(
    "gc_nodes_removed_total",
    "Ghost nodes (backing instance gone) deleted by the capacity GC")


class GarbageCollection:
    """Periodic two-way sweep of provider capacity vs Node objects."""

    def __init__(
        self,
        kube: KubeCore,
        cloud_provider: CloudProvider,
        interval_seconds: float = DEFAULT_INTERVAL_SECONDS,
        grace_seconds: float = DEFAULT_GRACE_SECONDS,
        journal=None,
    ):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.interval_seconds = interval_seconds
        self.grace_seconds = grace_seconds
        # ownership handoff with restart recovery: capacity whose launch
        # nonce is covered by an open journaled fleet-launch intent belongs
        # to recovery (which rolls it forward or terminates it exactly
        # once); GC must never race it — see controllers/recovery.py
        self.journal = journal

    # -- manager wiring ------------------------------------------------------
    def kind(self) -> Optional[str]:
        return None  # time-driven: no watch, one seeded key + self-requeue

    def seeds(self) -> List[Tuple[str, str]]:
        return [("capacity-gc", "")]

    # -- sweep ---------------------------------------------------------------
    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        try:
            records = self.cloud_provider.list_instances()
        except Exception:  # noqa: BLE001 — skip the sweep, never guess
            log.exception("listing provider instances failed; skipping sweep")
            return self.interval_seconds

        # one no-copy pass over Nodes: (name, providerID segments, age gate)
        prefix = f"{self.cloud_provider.name()}://"
        cutoff = clock.now() - self.grace_seconds

        def extract(n):
            pid = getattr(n.spec, "provider_id", "") or ""
            if not pid.startswith(prefix):
                return None
            return (n.metadata.name,
                    n.metadata.namespace,
                    frozenset(s for s in pid.split("/") if s),
                    (n.metadata.creation_timestamp or clock.now()) < cutoff,
                    n.metadata.deletion_timestamp is not None)
        nodes = [t for t in self.kube.scan("Node", extract) if t is not None]

        backed = set()
        for _, _, segments, _, _ in nodes:
            backed |= segments

        # direction 1: instances with no Node → terminate after grace
        covered = (self.journal.covered_nonces()
                   if self.journal is not None else frozenset())
        live_ids = set()
        for record in records:
            if not record.instance_id:
                continue  # malformed: never act on an empty id
            live_ids.add(record.instance_id)
            if record.instance_id in backed:
                continue
            if record.launch_nonce and record.launch_nonce in covered:
                # journal-owned: an open fleet-launch intent covers this
                # nonce, so recovery is (or will be) resolving it — acting
                # here would double-terminate or kill a roll-forward
                log.debug("instance %s owned by open journal intent "
                          "(nonce=%s); skipping", record.instance_id,
                          record.launch_nonce)
                continue
            if record.created_unix <= 0.0:
                # unknown launch time: fail-safe — age cannot be proven
                log.debug("instance %s has no launch time; skipping",
                          record.instance_id)
                continue
            if record.created_unix > cutoff:
                continue  # younger than grace: probably mid-bind
            err = self.cloud_provider.delete_instance(record.instance_id)
            if err is not None:
                log.error("terminating leaked instance %s: %s",
                          record.instance_id, err)
                continue
            _TERMINATED.inc(provisioner=record.provisioner_name or "unknown")
            log.info(
                "terminated leaked instance %s (provisioner=%s nonce=%s "
                "age=%.0fs type=%s zone=%s)",
                record.instance_id, record.provisioner_name,
                record.launch_nonce, clock.now() - record.created_unix,
                record.instance_type, record.zone)

        # direction 2: Nodes whose instance is gone → delete after grace.
        # Routed through kube.delete so the termination finalizer runs the
        # full drain path; provider deletion of absent capacity is NotFound
        # → success, so the finalizer always clears.
        for node_name, node_ns, segments, old_enough, deleting in nodes:
            if deleting or not old_enough:
                continue
            if segments & live_ids:
                continue
            try:
                self.kube.delete("Node", node_name, node_ns)
            except NotFound:
                continue  # already gone: someone else won the race
            except Exception:  # noqa: BLE001 — retried next sweep
                log.exception("deleting ghost node %s failed", node_name)
                continue
            _REMOVED.inc()
            log.info("deleting ghost node %s (backing instance gone)",
                     node_name)

        return self.interval_seconds
