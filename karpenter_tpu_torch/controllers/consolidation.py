"""Consolidation controller: one batched what-if solve per window.

A copy of the JAX package's ``controllers/consolidation.py`` on the port's
kernel. Per Provisioner with ``consolidation_enabled``, each reconcile runs
ONE window:

1. Gather settled capacity (ready, not deleting) into bins and filter the
   candidates that may actually drain: a ``karpenter.sh/do-not-evict`` pod
   pins its node, and a node whose movable pods would breach a
   PodDisruptionBudget's headroom (or whose PDBs are misconfigured — >1
   selecting a pod, or both minAvailable and maxUnavailable set — which
   the eviction subresource 500s) never enters the batch.
2. Encode "cluster minus node i" for every candidate i as one program
   (ops/whatif.py) and solve the whole window in a single launch of the
   what-if kernel (solver/whatif.py) on the controller's device.
3. Score feasible drains in $/h (models/consolidate.fleet_prices) and
   execute the cheapest feasible multi-node plan, each drain re-verified
   exactly on host before its delete (zero unverified drains). Deletion
   rides the termination finalizer flow (controllers/termination.py).

Nodes whose instance type has left the catalog price at $0 but REMAIN
candidates; they are logged once per window.

The device is resolved when the controller is made, so a missing card
raises there. Each window is one ``consolidate`` window span (``gather``,
``encode``, the what-if ``dispatch`` and ``fetch``, ``plan``) and feeds the
JAX package's ``karpenter_consolidation_*`` series. Given ``journal=``,
each drain is a ``drain`` intent (open → deleting → closed), so a crash
between the decision and the delete is re-driven by startup recovery. The
window's time split and counts are kept in ``last_window``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import Node, Pod
from karpenter_tpu_torch.parallel.mesh import MeshLike, resolve_mesh
from karpenter_tpu_torch.metrics.consolidation import (
    CONSOLIDATION_CANDIDATES_TOTAL, CONSOLIDATION_DRAINS_TOTAL, CONSOLIDATION_FILTERED_TOTAL,
    CONSOLIDATION_RECLAIMED_TOTAL, CONSOLIDATION_SOLVE_SECONDS, CONSOLIDATION_UNKNOWN_TYPE_TOTAL,
    CONSOLIDATION_WINDOW_CANDIDATES, CONSOLIDATION_WINDOW_RECLAIMED,
)
from karpenter_tpu_torch.metrics.policy import SOFT_AFFINITY_BLOCKED_DRAINS_TOTAL
from karpenter_tpu_torch.models.consolidate import (
    fleet_prices, node_bin, reschedulable_pods)
from karpenter_tpu_torch.obs import trace as obtrace
from karpenter_tpu_torch.ops.whatif import encode_window, soft_affinity_loss
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound, _scaled_int_or_percent
from karpenter_tpu_torch.solver.whatif import dispatch_window, plan_window
from karpenter_tpu_torch.utils import node as nodeutil

log = logging.getLogger("karpenter.consolidation")

WINDOW_SIZE = 512  # candidates a window takes at most
# a drain that scatters a preferred co-located set pays the scheduler's
# soft-affinity price back out of its savings
SOFT_AFFINITY_COST_PER_WEIGHT = 0.001


class _PdbHeadroom:
    """Read-only mirror of the eviction subresource's PDB math
    (runtime/kubecore.py evict_pod), evaluated once per window: per-PDB
    (healthy, desired) over the namespace's pods, so candidate filtering
    costs one pass instead of one dry-run eviction per pod."""

    def __init__(self, kube: KubeCore):
        self.kube = kube
        self._by_ns: Dict[str, list] = {}

    def _pdbs(self, namespace: str) -> list:
        cached = self._by_ns.get(namespace)
        if cached is not None:
            return cached
        entries = []
        pods = self.kube.list("Pod", namespace=namespace)
        for pdb in self.kube.list("PodDisruptionBudget", namespace=namespace):
            if pdb.selector is None:
                continue
            expected = healthy = 0
            for p in pods:
                if not pdb.selector.matches(p.metadata.labels):
                    continue
                expected += 1
                if getattr(p.spec, "node_name", None) \
                        and p.metadata.deletion_timestamp is None:
                    healthy += 1
            both = pdb.min_available is not None \
                and pdb.max_unavailable is not None
            desired: Optional[int] = None
            if not both:
                try:
                    if pdb.min_available is not None:
                        desired = _scaled_int_or_percent(
                            pdb.min_available, expected, pdb.metadata.name)
                    elif pdb.max_unavailable is not None:
                        desired = expected - _scaled_int_or_percent(
                            pdb.max_unavailable, expected, pdb.metadata.name)
                except Exception:
                    both = True  # malformed IntOrString → conservative block
            entries.append((pdb, desired, healthy, both))
        self._by_ns[namespace] = entries
        return entries

    def blocks_drain(self, movable: Sequence[Pod]) -> bool:
        """Would draining ALL these pods at once breach any PDB? Mirrors
        evict_pod: >1 matching PDB or both fields set blocks outright;
        else the node's total healthy loss per PDB must fit its headroom
        (healthy − desired)."""
        loss: Dict[int, int] = {}
        by_id: Dict[int, tuple] = {}
        for pod in movable:
            matched = []
            for entry in self._pdbs(pod.metadata.namespace):
                if entry[0].selector.matches(pod.metadata.labels):
                    matched.append(entry)
            if not matched:
                continue
            if len(matched) > 1:
                return True  # eviction would 500: misconfigured
            pdb, desired, healthy, both = matched[0]
            if both or desired is None and (
                    pdb.min_available is not None
                    or pdb.max_unavailable is not None):
                return True
            if desired is None:
                continue  # selector-only PDB: no budget expressed
            if getattr(pod.spec, "node_name", None) \
                    and pod.metadata.deletion_timestamp is None:
                key = id(pdb)
                by_id[key] = matched[0]
                loss[key] = loss.get(key, 0) + 1
        for key, n in loss.items():
            _, desired, healthy, _ = by_id[key]
            if healthy - n < desired:
                return True
        return False


class ConsolidationController:
    """Watches Provisioners; one batched what-if window per reconcile over
    the mesh ``device`` resolves to (parallel/mesh.resolve_mesh; default:
    the solver mesh of every CUDA device; ``"cpu"`` runs the plain
    version)."""

    REQUEUE_SECONDS = 30.0

    def __init__(self, kube: KubeCore, provider=None,
                 max_actions_per_pass: int = 8,
                 repack_cost_per_hour: float = 0.0,
                 device: MeshLike = None, journal=None):
        self.kube = kube
        self.journal = journal
        self.provider = provider
        self.mesh = resolve_mesh(device)
        self.device = self.mesh[0]
        self.max_actions_per_pass = max_actions_per_pass
        # interruption-priced handoff: spot nodes' keep-cost carries their
        # reclaim tax, so savings rank risk as well as discount
        self.repack_cost_per_hour = repack_cost_per_hour
        # the last window: its time split (host seconds; the kernel's
        # CUDA-event ms), its counts and the $/h it reclaimed; and what it
        # solved: (encoding, feasible, slots, plan), for checks
        self.last_window: Optional[dict] = None
        self.last_solve: Optional[tuple] = None

    def kind(self) -> str:
        return "Provisioner"

    def reconcile(self, name: str, namespace: str = "default") -> Optional[float]:
        try:
            provisioner = self.kube.get("Provisioner", name, namespace)
        except NotFound:
            return None
        if not provisioner.spec.consolidation_enabled:
            return None
        if provisioner.metadata.deletion_timestamp is not None:
            return None
        wid = obtrace.new_window_id()
        with obtrace.window_span("consolidate", window_id=wid, provisioner=name):
            return self._window(provisioner, name, wid)

    def _window(self, provisioner, name: str, wid: str) -> Optional[float]:
        """One consolidation window (the traced reconcile body)."""
        t_gather = time.perf_counter()
        fleet: List[Node] = []
        pods_by_node: Dict[str, List[Pod]] = {}
        for node in self.kube.list("Node"):
            if node.metadata.labels.get(wellknown.PROVISIONER_NAME_LABEL) != name:
                continue
            # only consolidate settled capacity: ready, not being deleted
            if node.metadata.deletion_timestamp is not None:
                continue
            if not nodeutil.is_ready(node):
                continue
            fleet.append(node)
            pods_by_node[node.metadata.name] = self.kube.pods_on_node(
                node.metadata.name)

        catalog = self.provider.get_instance_types(
            provisioner.spec.constraints) if self.provider is not None else []
        prices, unknown = fleet_prices(fleet, catalog,
                                       repack_cost_per_hour=self.repack_cost_per_hour)
        if unknown and catalog:
            # once per window, not per node: the counter carries cardinality
            CONSOLIDATION_UNKNOWN_TYPE_TOTAL.inc(len(unknown))
            log.warning(
                "consolidation window: %d node(s) have instance types absent "
                "from the catalog (e.g. %s=%r on %s); priced at $0/h but "
                "still consolidation candidates", len(unknown),
                wellknown.LABEL_INSTANCE_TYPE,
                unknown[0].metadata.labels.get(wellknown.LABEL_INSTANCE_TYPE),
                unknown[0].metadata.name)

        # every settled node is a receiver bin; only filtered nodes drain
        bins = [node_bin(n, pods_by_node[n.metadata.name]) for n in fleet]
        pdb = _PdbHeadroom(self.kube)
        cand_idx: List[int] = []
        cand_movable: List[List[Pod]] = []
        savings: List[float] = []
        filtered: Dict[str, int] = {}
        # the incremental removable_nodes pass's receiver set (drainable or
        # empty unpinned nodes, fewest movable pods first) — plan_window's
        # at-least-as-cheap-as-incremental emulation leg scans exactly it
        inc_targets: List[Tuple[int, int]] = []
        for i, node in enumerate(fleet):
            movable, ok = reschedulable_pods(pods_by_node[node.metadata.name])
            if not ok:
                CONSOLIDATION_FILTERED_TOTAL.inc(reason="do-not-evict")
                filtered["do-not-evict"] = filtered.get("do-not-evict", 0) + 1
                continue
            inc_targets.append((len(movable), i))
            if not movable:
                continue  # empty nodes are the emptiness controller's job
            if pdb.blocks_drain(movable):
                CONSOLIDATION_FILTERED_TOTAL.inc(reason="pdb")
                filtered["pdb"] = filtered.get("pdb", 0) + 1
                continue
            if len(cand_idx) >= WINDOW_SIZE:
                break
            price = prices.get(node.metadata.name, 0.0)
            loss = soft_affinity_loss(node, movable, fleet, pods_by_node,
                                      SOFT_AFFINITY_COST_PER_WEIGHT)
            if loss > 0.0 and loss >= price:
                # scattering the co-located set costs more than the node
                CONSOLIDATION_FILTERED_TOTAL.inc(reason="soft-affinity")
                SOFT_AFFINITY_BLOCKED_DRAINS_TOTAL.inc()
                filtered["soft-affinity"] = filtered.get("soft-affinity", 0) + 1
                continue
            cand_idx.append(i)
            cand_movable.append(movable)
            savings.append(price - loss)

        record = {"fleet": len(fleet), "candidates": len(cand_idx),
                  "filtered": filtered, "unknown_types": len(unknown),
                  "gather_s": time.perf_counter() - t_gather,
                  "encode_s": 0.0, "dispatch_s": 0.0, "kernel_ms": None,
                  "fetch_s": 0.0, "plan_s": 0.0, "drain_s": 0.0,
                  "executor": None, "feasible": 0, "drained": [],
                  "reclaimed_per_hour": 0.0}
        self.last_window, self.last_solve = record, None
        CONSOLIDATION_WINDOW_CANDIDATES.set(float(len(cand_idx)))
        obtrace.add_span("gather", t_gather, time.perf_counter(),
                         fleet=len(fleet), candidates=len(cand_idx))
        if len(cand_idx) == 0 or len(bins) < 2:
            CONSOLIDATION_WINDOW_RECLAIMED.set(0.0)
            return self.REQUEUE_SECONDS

        t0 = time.perf_counter()
        with obtrace.span("encode", candidates=len(cand_idx), bins=len(bins)):
            enc = encode_window(bins, cand_idx, cand_movable)
        t1 = time.perf_counter()
        handle = dispatch_window(enc, self.mesh)
        t2 = time.perf_counter()
        feasible, slots, executor = handle.fetch()
        t3 = time.perf_counter()
        CONSOLIDATION_SOLVE_SECONDS.observe(t3 - t0)
        CONSOLIDATION_CANDIDATES_TOTAL.inc(float(len(cand_idx)))
        with obtrace.span("plan"):
            plan = plan_window(enc, feasible, savings,
                               max_drains=self.max_actions_per_pass,
                               incremental_targets=[i for _, i in sorted(inc_targets)])
        t4 = time.perf_counter()
        CONSOLIDATION_WINDOW_RECLAIMED.set(plan.reclaimed_per_hour)
        self.last_solve = (enc, feasible, slots, plan)
        record.update(encode_s=t1 - t0, dispatch_s=t2 - t1, fetch_s=t3 - t2,
                      plan_s=t4 - t3, kernel_ms=handle.kernel_ms, executor=executor,
                      feasible=plan.feasible, reclaimed_per_hour=plan.reclaimed_per_hour)
        if plan.actions:
            log.info(
                "consolidation window: %d candidates → %d feasible → "
                "%d drains reclaiming $%.4f/h (%s, %.3fs) window_id=%s",
                plan.evaluated, plan.feasible, len(plan.actions),
                plan.reclaimed_per_hour, executor, t3 - t0, wid)
        for action in plan.actions:
            node = fleet[action.bin]
            log.info("consolidating node %s (%d pods fit on surviving "
                     "capacity; reclaims $%.4f/h) window_id=%s", node.metadata.name,
                     len(enc.cand_pods[action.cand]), action.saving, wid)
            if self._drain_node(node, action.saving):
                record["drained"].append(node.metadata.name)
        record["drain_s"] = time.perf_counter() - t4
        return self.REQUEUE_SECONDS

    def _drain_node(self, node: Node, saving: float) -> bool:
        """Execute one planned drain: delete the Node, whose termination
        finalizer hands it to the termination controller. Journaled as a
        ``drain`` intent."""
        journal = self.journal
        iid = None
        if journal is not None:
            iid = journal.open_intent("drain", node=node.metadata.name,
                                      namespace=node.metadata.namespace, saving=saving)
        try:
            self.kube.delete("Node", node.metadata.name, node.metadata.namespace)
        except NotFound:
            if iid is not None:
                journal.close(iid, outcome="gone")
            return False
        if iid is not None:
            journal.advance(iid, "deleting")
            journal.close(iid)
        CONSOLIDATION_DRAINS_TOTAL.inc()
        CONSOLIDATION_RECLAIMED_TOTAL.inc(saving)
        return True
