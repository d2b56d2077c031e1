"""Scheduler: constraint solve — group pods into isomorphic schedules.

Reference: pkg/controllers/provisioning/scheduling/scheduler.go. Topology is
injected first (as JIT node selectors), then pod-(anti-)affinity
(scheduling/affinity.py, its match matrix on the scheduler's device), then
pods group by hash(tightened constraints + GPU requests + soft-affinity
votes); each group bin-packs independently, which is what makes the batch
axis of the window's device solve embarrassingly parallel.

A copy of the JAX package's scheduler. The columnar engine
(``ops/feasibility.compile_constraints``) validates each pod and memoizes
``tighten()`` and the group key per pod signature; where it gives None the
scalar ``validate_pod`` and ``tighten`` run per pod. A pod the affinity
injection proved unsatisfiable (``_affinity_unsat``) fails validation and
is counted as ``reason=affinity`` in the window's log line.
A complete gang is one schedule with ``gang`` set, which the controller
peels off into its co-pack window; a gang that lost members to validation
is dropped whole with ``reason=gang`` (``_gang_unsat``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.api.gang import GangSpec, gang_of
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.backend import DeviceLike
from karpenter_tpu_torch.ops import feasibility
from karpenter_tpu_torch.runtime.kubecore import KubeCore
from karpenter_tpu_torch.scheduling.affinity import AffinityGroups
from karpenter_tpu_torch.scheduling.topology import Topology
from karpenter_tpu_torch.solver import adapter
from karpenter_tpu_torch.utils import resources as res

log = logging.getLogger("karpenter.scheduler")


@dataclass
class Schedule:
    """Equivalently-schedulable pods + their tightened constraints
    (scheduler.go:53-57). ``gang`` is the gang spec when the group is an
    all-or-nothing pod group (the controller's co-pack window solves it)."""

    constraints: Constraints
    pods: List[Pod] = field(default_factory=list)
    gang: Optional[GangSpec] = None
    # preferred-affinity votes shared by every member ({(key, value):
    # signed weight}); the soft signature is folded into the group key so
    # all pods of one schedule carry the SAME votes. None = no preference.
    soft_affinity: Optional[Dict] = None


def _constraints_key(c: Constraints, gpu_requests) -> tuple:
    """Structural hash of tightened constraints + GPU requests
    (scheduler.go:100-110). SlicesAsSets semantics: order-insensitive. The
    (requirements, taints, labels) parts are
    ``feasibility.constraints_key_parts``, so the engine's memoized group
    keys are this function by construction."""
    gpus = tuple(sorted((k, q.nano) for k, q in gpu_requests.items()))
    return feasibility.constraints_key_parts(c) + (gpus,)


class Scheduler:
    """``device`` (default: the CUDA device; ``"cpu"`` runs the same torch
    ops on the CPU) runs the affinity match matrix."""

    def __init__(self, kube: KubeCore, device: DeviceLike = None):
        self.kube = kube
        self.topology = Topology(kube)
        self.affinity = AffinityGroups(device)

    def solve(self, provisioner: Provisioner, pods: List[Pod]) -> List[Schedule]:
        """scheduler.go:66-82. Affinity injects after topology so a pod
        carrying both a hostname spread and a pod-(anti-)affinity term gets
        the affinity verdict."""
        constraints = provisioner.spec.constraints.deepcopy()
        self.topology.inject(constraints, pods)
        self.affinity.inject(constraints, pods)
        return self._get_schedules(constraints, pods)

    def _get_schedules(self, constraints: Constraints, pods: List[Pod]) -> List[Schedule]:
        """scheduler.go:87-125, columnar: one tighten per distinct pod
        signature. Unschedulable pods aggregate to one summary log line per
        window (counts by reason + up to 5 sample reasons). Verdicts and
        error strings are the scalar path's."""
        engine = feasibility.compile_constraints(constraints)
        schedules: Dict[tuple, Schedule] = {}
        skipped = topo_skipped = aff_skipped = gang_skipped = 0
        samples: List[str] = []

        def note(pod: Pod, why: str) -> None:
            if len(samples) < 5:
                samples.append(f"{pod.metadata.namespace}/{pod.metadata.name}: {why}")

        for pod in pods:
            gspec = gang_of(pod)
            if gspec is not None and gspec.error:
                # malformed gang labels never enter a solve window
                skipped += 1
                gang_skipped += 1
                pod.__dict__["_gang_unsat"] = gspec.error
                note(pod, gspec.error)
                continue
            if engine is not None:
                err, tightened, key = engine.schedule_entry(pod)
            else:
                err = constraints.validate_pod(pod)
                if err is None:
                    tightened = constraints.tighten(pod)
                    key = _constraints_key(tightened, res.gpu_limits_for(pod))
            if err is not None:
                skipped += 1
                if pod.__dict__.get("_topology_unsat"):
                    # topology.inject found no satisfiable spread domain
                    topo_skipped += 1
                elif pod.__dict__.get("_affinity_unsat"):
                    # affinity.inject proved the pod's required pod-pod
                    # constraints unsatisfiable within the window
                    aff_skipped += 1
                note(pod, err)
                continue
            if gspec is not None:
                # fold the gang identity into the group key: a gang
                # schedule holds exactly its members
                key = key + (gspec.group_part,)
            soft = pod.__dict__.get("_soft_affinity")
            if soft:
                # fold the soft-vote signature in too: scoring prices a
                # schedule's preference row once, so members must agree
                key = key + (tuple(sorted(soft.items())),)
            schedule = schedules.get(key)
            if schedule is None:
                schedule = schedules[key] = Schedule(
                    constraints=tightened, pods=[], gang=gspec,
                    soft_affinity=dict(soft) if soft else None)
                # warm the allowed-sets memo at window assembly: the solver
                # reads these five sets per schedule, and the tighten memo
                # hands back the same constraints object window after window
                adapter.allowed_sets_cached(tightened)
            schedule.pods.append(pod)
        # a gang schedule that lost members to validation above is partial:
        # all-or-nothing means the survivors shed with the group rather
        # than entering a solve window alone
        for key in [k for k, s in schedules.items()
                    if s.gang is not None and len(s.pods) != s.gang.size]:
            s = schedules.pop(key)
            skipped += len(s.pods)
            gang_skipped += len(s.pods)
            for pod in s.pods:
                pod.__dict__["_gang_unsat"] = (
                    f"gang {s.gang.namespace}/{s.gang.name} incomplete in "
                    f"window ({len(s.pods)}/{s.gang.size} members)")
            if len(samples) < 5:
                samples.append(f"gang {s.gang.namespace}/{s.gang.name}: "
                               f"{len(s.pods)}/{s.gang.size} members")
        if skipped:
            log.info("unable to schedule %d/%d pod(s) in window "
                     "(reason=topology: %d, reason=affinity: %d, reason=gang: %d, "
                     "other: %d): %s",
                     skipped, len(pods), topo_skipped, aff_skipped, gang_skipped,
                     skipped - topo_skipped - aff_skipped - gang_skipped,
                     "; ".join(samples))
        return list(schedules.values())
