"""The crash-restart soak: one scenario that reaches every journal kill point.

The port's copy of the JAX package's crash-recovery scenario (the harness
of its crash-recovery tests), so the CPU tests and ``chip_smoke.py`` drive
the same steps. :func:`run_scenario` exercises the original five intent
machines against the in-memory API server and the fake provider with a live
:class:`~karpenter_tpu_torch.runtime.journal.IntentJournal`:

1. two plain pods through the worker's real hot loop (``fleet-launch`` and
   ``bind`` intents, the pack kernel on the worker's device);
2. a gang that binds (``gang-bind``, success leg);
3. a gang with a member the API server never saw (``gang-bind``, unwind
   leg);
4. a consolidation drain of a dedicated empty node (``drain``);
5. the termination finalizer over every deleting node (``node-delete``).

:func:`run_carve_scenario` exercises the ``carve`` and ``preempt``
machines: a low-band gang carves a whole 4x4 torus, then a high-band gang
displaces it and carves a corner of the same node.

Both scenarios are idempotent: after a simulated crash (a ``crash-point``
fault of :mod:`karpenter_tpu_torch.chaos.inject`), a restart (a fresh
journal over the same directory and :class:`RecoveryController.run`) and a
re-drive of the scenario converge to the uncrashed run's state.
:func:`soak_once` runs one kill point that way and returns what it saw.
"""

from __future__ import annotations

import time
import uuid
from types import SimpleNamespace
from typing import Dict, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import (
    Container, NodeSelectorRequirement, ObjectMeta, Pod, PodCondition, PodSpec, PodStatus,
    ResourceRequirements,
)
from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.chaos import inject
from karpenter_tpu_torch.cloudprovider.fake.provider import (
    FakeCloudProvider, instance_types, tpu_catalog,
)
from karpenter_tpu_torch.controllers.consolidation import ConsolidationController
from karpenter_tpu_torch.controllers.provisioning import ProvisionerWorker
from karpenter_tpu_torch.controllers.recovery import RecoveryController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.ops import topology as topo_ops
from karpenter_tpu_torch.runtime.journal import KILL_POINTS, IntentJournal
from karpenter_tpu_torch.runtime.kubecore import KubeCore, NotFound
from karpenter_tpu_torch.scheduling.batcher import Batcher
from karpenter_tpu_torch.solver.gang import PreemptCandidate
from karpenter_tpu_torch.solver.solve import global_requirements

PLAIN_PODS = ["plain-0", "plain-1"]
GANG_OK = ["gang-ok-0", "gang-ok-1"]
GANG_BAD_REAL = "gang-bad-0"
GANG_BAD_GHOST = "gang-bad-ghost"  # never created: forces the unwind leg
DRAIN_LABEL = "test.karpenter.sh/drain-target"

CARVE_VICTIM = ["carve-lo-0", "carve-lo-1"]
CARVE_WINNER = ["carve-hi-0", "carve-hi-1"]
VICTIM_CELLS = list(range(16))   # the resident holds the whole torus
WINNER_CELLS = [0, 1, 4, 5]      # the winner needs one 2x2 corner

# the carve and preempt machines run in the carve scenario; the other five
# machines' points in the plain one
CARVE_KILL_POINTS = [p for p in KILL_POINTS if p.split(":")[-2] in ("carve", "preempt")]
LEGACY_KILL_POINTS = [p for p in KILL_POINTS if p not in CARVE_KILL_POINTS]


def require(cond: bool, what: str) -> None:
    """The scenario's own checks (kept when Python runs with -O)."""
    if not cond:
        raise AssertionError(what)


def make_constraints(provisioner: str = "crash") -> Constraints:
    return Constraints(
        labels={wellknown.PROVISIONER_NAME_LABEL: provisioner},
        requirements=Requirements([
            NodeSelectorRequirement(key=wellknown.LABEL_TOPOLOGY_ZONE, operator="In",
                                    values=["test-zone-1"]),
            NodeSelectorRequirement(key=wellknown.LABEL_CAPACITY_TYPE, operator="In",
                                    values=["on-demand"]),
        ]),
    )


def unschedulable_pod(name: str, requests: Optional[Dict[str, str]] = None) -> Pod:
    """A pending pod with the Unschedulable condition; its uid is one
    ``uuid4`` draw, as the reference's fixture makes it."""
    return Pod(
        metadata=ObjectMeta(name=name, namespace="default", uid=uuid.uuid4().hex),
        spec=PodSpec(containers=[Container(resources=ResourceRequirements.make(
            requests=requests or {"cpu": "1", "memory": "512Mi"}))]),
        status=PodStatus(phase="Pending", conditions=[
            PodCondition(type="PodScheduled", status="False", reason="Unschedulable")]))


class Cluster:
    """What survives a simulated process death: the API server, the fake
    provider's capacity ledger and the journal directory. Workers and
    controllers belong to a "process" and are made anew on every drive."""

    def __init__(self, journal_dir: str, catalog=None, device="cuda", fsync: bool = False):
        self.journal_dir = journal_dir
        self.device = device
        self.fsync = fsync
        self.kube = KubeCore()
        self.provider = FakeCloudProvider(catalog=catalog or instance_types(4))
        self.constraints = make_constraints()
        self.prov = Provisioner(metadata=ObjectMeta(name="crash", namespace="default"),
                                spec=ProvisionerSpec(constraints=make_constraints()))
        self.prov.spec.constraints.requirements = self.prov.spec.constraints.requirements.add(
            *global_requirements(self.provider.get_instance_types(
                self.prov.spec.constraints)).items)
        self.kube.create(self.prov)

    def open_journal(self, **kw) -> IntentJournal:
        kw.setdefault("fsync", self.fsync)
        return IntentJournal(self.journal_dir, **kw)


def ensure_pod(kube, name, cpu="500m"):
    try:
        return kube.get("Pod", name)
    except NotFound:
        p = unschedulable_pod(name, requests={"cpu": cpu, "memory": "256Mi"})
        kube.create(p)
        return p


def bound_node(kube, pod_name) -> Optional[str]:
    try:
        return kube.get("Pod", pod_name).spec.node_name or None
    except NotFound:
        return None


def make_worker(cluster: Cluster, journal) -> ProvisionerWorker:
    return ProvisionerWorker(cluster.prov, cluster.kube, cluster.provider,
                             batcher=Batcher(idle_seconds=0.02, max_seconds=0.2),
                             device=cluster.device, journal=journal)


def launch_gang(worker, cluster, pods, key):
    """Drive ``_launch_gang`` through planner structures made by hand: the
    planner upstream of it is pure, the crash windows live here."""
    itype = cluster.provider.catalog[-1]
    enc = SimpleNamespace(bins=[SimpleNamespace(type_index=0, name=f"{key}-bin-0")])
    prep = SimpleNamespace(gang_enc=enc, gang_nodes={}, gang_types=[(itype.name, itype)])
    gang = SimpleNamespace(key=key, pods=pods,
                           context=SimpleNamespace(constraints=cluster.constraints))
    placement = SimpleNamespace(gang=gang, node_sets=[(0, pods)])
    return worker._launch_gang(prep, placement)


def settle_terminations(cluster, journal, rounds=25):
    """Finish every node the scenario put into deletion: the termination
    finalizer's reconcile loop."""
    term = TerminationController(cluster.kube, cluster.provider, journal=journal)
    try:
        for _ in range(rounds):
            deleting = [n for n in cluster.kube.list("Node")
                        if n.metadata.deletion_timestamp is not None]
            if not deleting:
                return
            for n in deleting:
                term.reconcile(n.metadata.name, "")
            time.sleep(0.01)
        raise AssertionError(f"nodes stuck terminating: {[n.metadata.name for n in deleting]}")
    finally:
        term.stop_all()


def drain_target(cluster):
    """The dedicated empty node the drain leg works on, labeled so a
    re-drive finds it whatever its name."""
    for n in cluster.kube.list("Node"):
        if n.metadata.labels.get(DRAIN_LABEL):
            return n
    made = []

    def bind(node):
        node.metadata.labels[DRAIN_LABEL] = "true"
        node.metadata.labels.update(cluster.constraints.labels)
        node.metadata.finalizers.append(wellknown.TERMINATION_FINALIZER)
        cluster.kube.create(node)
        made.append(node)
        return None

    errs = cluster.provider.create(cluster.constraints, [cluster.provider.catalog[0]], 1, bind)
    require(errs == [None], f"drain target launch failed: {errs}")
    return made[0]


def run_scenario(cluster, journal):
    """One full control-plane pass; idempotent, so a re-drive after a crash
    and recovery converges to the reference."""
    kube = cluster.kube
    worker = make_worker(cluster, journal)

    # 1. plain pods: fleet-launch + bind intents through the real hot loop
    pods = [ensure_pod(kube, n, cpu="1500m") for n in PLAIN_PODS]
    pending = [p for p in pods if not bound_node(kube, p.metadata.name)]
    if pending:
        for p in pending:
            worker.add(p, key=(p.metadata.namespace, p.metadata.name))
        worker.provision()

    # 2. gang success leg: the all-or-nothing two-phase bind
    gang_pods = [ensure_pod(kube, n) for n in GANG_OK]
    if not all(bound_node(kube, n) for n in GANG_OK):
        err = launch_gang(worker, cluster, gang_pods, key="gang-ok")
        require(err is None, f"gang-ok failed to bind: {err}")

    # 3. gang failure leg: a ghost member forces a bind failure → unwind
    bad = ensure_pod(kube, GANG_BAD_REAL)
    ghost = unschedulable_pod(GANG_BAD_GHOST)  # never in the API server
    err = launch_gang(worker, cluster, [bad, ghost], key="gang-bad")
    require(err is not None, "ghost-member gang unexpectedly bound")

    # 4. consolidation drain of the dedicated target
    target = drain_target(cluster)
    consolidation = ConsolidationController(kube, provider=cluster.provider,
                                            device=cluster.device, journal=journal)
    consolidation._drain_node(target, 0.25)

    # 5. the termination finalizer finishes every deleting node
    settle_terminations(cluster, journal)


def restart(cluster, requeue_displaced=None):
    """A process restart: a fresh journal handle over the same directory,
    then the startup replay. Returns (journal, stats)."""
    journal = cluster.open_journal()
    recovery = RecoveryController(cluster.kube, cluster.provider, journal,
                                  requeue_displaced=requeue_displaced)
    require(recovery.recovering(), "recovery finished before it ran")
    stats = recovery.run()
    require(not recovery.recovering(), "recovery still recovering after run()")
    return journal, stats


def canonical_state(cluster) -> dict:
    """Node-name-free snapshot (the fake provider's name counter makes
    names depend on how many launches ever ran)."""
    node_shape = {}
    for n in cluster.kube.list("Node"):
        labels = n.metadata.labels
        node_shape[n.metadata.name] = (labels.get(wellknown.LABEL_INSTANCE_TYPE, ""),
                                       labels.get(wellknown.LABEL_TOPOLOGY_ZONE, ""),
                                       labels.get(wellknown.LABEL_CAPACITY_TYPE, ""))
    pods = []
    for p in cluster.kube.list("Pod"):
        nn = p.spec.node_name
        pods.append((p.metadata.namespace, p.metadata.name, bool(nn),
                     node_shape.get(nn) if nn else None))
    return {"pods": sorted(pods), "node_types": sorted(node_shape.values())}


def leaks(cluster) -> dict:
    """Leaked instances (a ledger entry no Node backs) and ghost Nodes (a
    Node whose instance the ledger no longer holds)."""
    records = cluster.provider.list_instances()
    backed = set()
    segs_of = {}
    for n in cluster.kube.list("Node"):
        segs = {s for s in (n.spec.provider_id or "").split("/") if s}
        segs_of[n.metadata.name] = segs
        backed |= segs
    ledger = {r.instance_id for r in records}
    return {"leaked": sorted(r.instance_id for r in records if r.instance_id not in backed),
            "ghosts": sorted(name for name, segs in segs_of.items() if not segs & ledger)}


def assert_invariants(cluster) -> None:
    kube = cluster.kube
    found = leaks(cluster)
    require(not found["leaked"], f"leaked instances (no Node): {found['leaked']}")
    require(not found["ghosts"], f"ghost nodes: {found['ghosts']}")
    # every bound pod points at a live node, and the node-name index agrees
    for p in kube.list("Pod"):
        if p.spec.node_name:
            kube.get("Node", p.spec.node_name, "")  # raises if dangling
            on_node = {q.metadata.name for q in kube.pods_on_node(p.spec.node_name)}
            require(p.metadata.name in on_node, f"index lost bound pod {p.metadata.name}")
    ok_bound = [bound_node(kube, n) for n in GANG_OK]
    require(all(ok_bound) or not any(ok_bound),
            f"partially bound gang: {dict(zip(GANG_OK, ok_bound))}")
    require(bound_node(kube, GANG_BAD_REAL) is None, "member of the failed gang stayed bound")


# -- the carve / preempt scenario ----------------------------------------------

def carve_cluster(journal_dir, device="cuda", fsync: bool = False) -> Cluster:
    return Cluster(journal_dir, catalog=tpu_catalog(), device=device, fsync=fsync)


def tpu_node(cluster) -> Optional[str]:
    for n in cluster.kube.list("Node"):
        it = n.metadata.labels.get(wellknown.LABEL_INSTANCE_TYPE, "")
        if it.startswith("tpu-") and n.metadata.deletion_timestamp is None:
            return n.metadata.name
    return None


def ledger_rec(gang):
    for ng in topo_ops.LEDGER.snapshot():
        for key, rec in ng.carves.items():
            if str(key) == gang:
                return ng.node, rec
    return None


def carve_prep(cluster, key, node=None):
    itype = next(t for t in cluster.provider.catalog if t.name == "tpu-v5e-4x4")
    enc = SimpleNamespace(bins=[SimpleNamespace(type_index=0, name=f"{key}-bin-0", grid=(4, 4),
                                                node_name=node)])
    return SimpleNamespace(gang_enc=enc, gang_nodes=dict({0: node} if node else {}),
                           gang_types=[(itype.name, itype)])


def carve_placement(cluster, pods, key, band, cells):
    gang = SimpleNamespace(key=key, pods=pods, band=band,
                           context=SimpleNamespace(constraints=cluster.constraints))
    return SimpleNamespace(gang=gang, node_sets=[(0, pods)], carves={0: list(cells)})


def run_carve_scenario(cluster, journal):
    """Victim carve → priced displacement → winner carve, idempotent across
    crash and recovery re-drives: every branch keys off durable state (the
    bindings and the recovered ledger)."""
    kube = cluster.kube
    worker = make_worker(cluster, journal)
    lo = [ensure_pod(kube, n) for n in CARVE_VICTIM]
    hi = [ensure_pod(kube, n) for n in CARVE_WINNER]

    if all(bound_node(kube, n) for n in CARVE_WINNER):
        # the displacement happened before the crash; at most the winner's
        # carve record is missing (re-commit is idempotent)
        node = bound_node(kube, CARVE_WINNER[0])
        if ledger_rec("carve-hi") is None:
            worker._commit_carves(carve_prep(cluster, "carve-hi", node=node),
                                  carve_placement(cluster, hi, "carve-hi", "high", WINNER_CELLS))
        return

    if all(bound_node(kube, n) for n in CARVE_VICTIM):
        node = bound_node(kube, CARVE_VICTIM[0])
        if ledger_rec("carve-lo") is None:
            # bound, but the carve never became durable: re-commit
            worker._commit_carves(carve_prep(cluster, "carve-lo", node=node),
                                  carve_placement(cluster, lo, "carve-lo", "low", VICTIM_CELLS))
    elif tpu_node(cluster) is None:
        # leg 1: the resident low-band gang carves the whole torus
        prep = carve_prep(cluster, "carve-lo")
        placement = carve_placement(cluster, lo, "carve-lo", "low", VICTIM_CELLS)
        err = worker._launch_gang(prep, placement)
        require(err is None, f"victim gang failed to bind: {err}")
        worker._commit_carves(prep, placement)
    # else: the victim was displaced already (the node exists, nobody is
    # bound, carve-lo popped by the preempt roll-forward): straight to leg 2

    # leg 2: the high-band winner displaces the resident (when one is still
    # carved) and binds and carves onto the SAME node
    node = tpu_node(cluster)
    require(node is not None, "no torus node to carve")
    victims = []
    found = ledger_rec("carve-lo")
    if found is not None:
        vnode, rec = found
        victims.append(PreemptCandidate(
            gang_key=rec.gang_key, bin_index=0, node=vnode, band=rec.band, pods=list(rec.pods),
            cells=rec.cells.copy(), refund=[0], displacement_cost=0.1))
    prep = carve_prep(cluster, "carve-hi", node=node)
    placement = carve_placement(cluster, hi, "carve-hi", "high", WINNER_CELLS)
    err = worker._launch_gang(prep, placement, victims)
    require(err is None, f"winner gang failed to bind: {err}")
    worker._commit_carves(prep, placement)


def canonical_ledger() -> list:
    """Node-name-free, intent-id-free canonical form of the process
    occupancy ledger."""
    out = []
    for ng in topo_ops.LEDGER.snapshot():
        for key, rec in ng.carves.items():
            out.append((ng.type_name, tuple(ng.dims), tuple(int(c) for c in sorted(rec.cells)),
                        rec.band, str(key), tuple(sorted(f"{a}/{b}" for a, b in rec.pods))))
    return sorted(out)


def assert_carve_invariants(cluster, journal) -> None:
    """No cell carved twice, every ledger node live, the open intents
    exactly the live carves, the winner bound and the victim unbound."""
    live_ids = set()
    for ng in topo_ops.LEDGER.snapshot():
        cells = []
        for rec in ng.carves.values():
            cells.extend(int(c) for c in rec.cells)
            require(bool(rec.intent_id), "live carve lost its durable intent")
            live_ids.add(rec.intent_id)
        require(len(cells) == len(set(cells)), f"double-carved cells on {ng.node}")
        require(int(ng.occ.sum()) == len(cells), f"occupancy of {ng.node} != its carves")
        cluster.kube.get("Node", ng.node, "")  # raises if dangling
    open_intents = journal.open_intents()
    require({i.kind for i in open_intents.values()} <= {"carve"},
            f"non-carve intents left open: "
            f"{[(i.kind, i.phase) for i in open_intents.values()]}")
    require(set(open_intents) == live_ids, "open carve intents diverge from the live ledger")
    require(all(bound_node(cluster.kube, n) for n in CARVE_WINNER), "winner not bound")
    require(not any(bound_node(cluster.kube, n) for n in CARVE_VICTIM), "victim still bound")


# -- one soak cell ---------------------------------------------------------------

def soak_once(root: str, kill_point: str, seed: int = 1, window: int = 1, device="cuda",
              reference: Optional[dict] = None, fsync: bool = False) -> dict:
    """One kill point: an uncrashed reference run (unless ``reference``, an
    earlier call's ``"reference"``, is given), then a run that crashes at
    ``kill_point``, a restart and a re-drive. The carve and preempt points
    run the carve scenario (and compare the recovered ledger too). Returns
    whether it crashed, the recovery stats, the leaks after the re-drive,
    and both canonical states; checks the invariants on the way."""
    carve = kill_point in CARVE_KILL_POINTS
    make = carve_cluster if carve else Cluster
    scenario = run_carve_scenario if carve else run_scenario
    if reference is None:
        topo_ops.LEDGER.reset()
        ref = make(f"{root}/ref", device=device, fsync=fsync)
        ref_journal = ref.open_journal()
        scenario(ref, ref_journal)
        if carve:
            assert_carve_invariants(ref, ref_journal)
        else:
            require(ref_journal.open_intents() == {}, "the reference run left intents open")
        reference = {"state": canonical_state(ref), "ledger": canonical_ledger()}
        ref_journal.close_journal()

    topo_ops.LEDGER.reset()
    c = make(f"{root}/crash", device=device, fsync=fsync)
    journal = c.open_journal()
    inject.install(inject.FaultPlan(seed, [inject.FaultSpec("journal", kill_point,
                                                            "crash-point", 1)], window=window))
    crashed = False
    try:
        scenario(c, journal)
    except inject.SimulatedCrash as e:
        crashed = True
        require(e.point == kill_point, f"crashed at {e.point}, armed {kill_point}")
    finally:
        inject.uninstall()
        journal.close_journal()  # drop the dead process's handle

    topo_ops.LEDGER.reset()  # the in-memory ledger dies with the process
    t0 = time.perf_counter()
    journal2, stats = restart(c)
    recovery_s = time.perf_counter() - t0
    require(stats["errors"] == 0, f"{kill_point}: recovery errored: {stats}")
    t0 = time.perf_counter()
    scenario(c, journal2)  # re-drive to convergence
    redrive_s = time.perf_counter() - t0
    if carve:
        assert_carve_invariants(c, journal2)
    else:
        require(journal2.open_intents() == {}, f"{kill_point}: intents left open")
        assert_invariants(c)
    out = {"kill_point": kill_point, "crashed": crashed, "stats": stats,
           "leaks": leaks(c), "recovery_s": recovery_s, "redrive_s": redrive_s,
           "state": canonical_state(c), "ledger": canonical_ledger(), "reference": reference}
    require(out["state"] == reference["state"],
            f"{kill_point} seed {seed} diverged (crashed={crashed}):\n"
            f" got: {out['state']}\n ref: {reference['state']}")
    require(out["ledger"] == reference["ledger"],
            f"{kill_point} seed {seed}: recovered ledger diverged")
    journal2.close_journal()
    return out
