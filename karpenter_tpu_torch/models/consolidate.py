"""Consolidation: re-pack running capacity into a smaller/cheaper node set.

A copy of the JAX package's ``models/consolidate.py``. Two granularities:

- ``repack_plan``: whole-fleet minimal-set re-pack — all reschedulable pods
  re-solved against the catalog with the same pack kernel the forward path
  uses (``solve``, ``solve_batch``; ``backend="relax"`` rides
  ``solver/relax.relax_solve``), scored in $/h.
- ``removable_nodes``: the incremental form — nodes whose pods fit into the
  *free* capacity of the surviving nodes, found by first-fit-decreasing
  into fixed bins (``place_onto``). It is the exact host oracle the what-if
  window (ops/whatif.py, solver/whatif.py) is held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints, Taints
from karpenter_tpu_torch.api.core import Node, Pod
from karpenter_tpu_torch.api.requirements import pod_requirements
from karpenter_tpu_torch.backend import DeviceLike
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.models.cost import node_price, plan_cost
from karpenter_tpu_torch.solver.adapter import pod_vector, resource_list_vector
from karpenter_tpu_torch.solver.host_ffd import NUM_RESOURCES, R_PODS
from karpenter_tpu_torch.solver.solve import SolveResult, SolverConfig, solve
from karpenter_tpu_torch.utils import pod as podutil

NANO = 10**9


def node_instance_type(node: Node, catalog: Sequence[InstanceType]) -> Optional[InstanceType]:
    """Resolve a running node back to its catalog entry via the
    instance-type label stamped at launch (instance.go:245-285)."""
    name = node.metadata.labels.get(wellknown.LABEL_INSTANCE_TYPE)
    for it in catalog:
        if it.name == name:
            return it
    return None


def spot_interruption_rate(it: InstanceType, zone: str) -> float:
    """Published reclaims/hour of this type's spot offering in ``zone``
    (the rate stamped on Offering.interruption_rate by the provider); a
    node whose zone label is stale falls back to the type's lowest spot
    rate: under-charging, never over-charging, the reclaim premium."""
    exact = None
    best = None
    for o in it.offerings:
        if o.capacity_type != wellknown.CAPACITY_TYPE_SPOT:
            continue
        if o.zone == zone:
            exact = o.interruption_rate
        if best is None or o.interruption_rate < best:
            best = o.interruption_rate
    if exact is not None:
        return exact
    return best if best is not None else 0.0


def fleet_prices(
    nodes: Sequence[Node],
    catalog: Sequence[InstanceType],
    repack_cost_per_hour: float = 0.0,
) -> Tuple[Dict[str, float], List[Node]]:
    """$/h per node name at its actual capacity type, plus the nodes whose
    instance-type label is absent from the catalog (stale label, or the
    type left the offering set). Unknown nodes price at $0 — they stay
    consolidatable (draining them reclaims SOMETHING; skipping them, the
    old callers' behavior, meant they were never consolidated and never
    priced). Callers log the unknowns once per window with the
    consolidation_unknown_instance_type_total counter.

    With ``repack_cost_per_hour`` > 0 (the interruption-priced policy's
    what-if handoff, solver/policy.py), a spot node's keep-cost includes
    its expected reclaim tax, ``interruption_rate × repack_cost``, so the
    consolidation ranking sees the spot discount AND the reclaim risk."""
    by_name = {it.name: it for it in catalog}
    prices: Dict[str, float] = {}
    unknown: List[Node] = []
    for node in nodes:
        it = by_name.get(node.metadata.labels.get(wellknown.LABEL_INSTANCE_TYPE))
        if it is None:
            prices[node.metadata.name] = 0.0
            unknown.append(node)
            continue
        capacity_type = node.metadata.labels.get(
            wellknown.LABEL_CAPACITY_TYPE, wellknown.CAPACITY_TYPE_ON_DEMAND)
        price = node_price(it, capacity_type)
        if repack_cost_per_hour > 0.0 and capacity_type == wellknown.CAPACITY_TYPE_SPOT:
            zone = node.metadata.labels.get(wellknown.LABEL_TOPOLOGY_ZONE, "")
            price += spot_interruption_rate(it, zone) * repack_cost_per_hour
        prices[node.metadata.name] = price
    return prices, unknown


def current_cost(nodes: Sequence[Node], catalog: Sequence[InstanceType]) -> float:
    """$/h of the running fleet, priced at each node's actual capacity type.
    Nodes the catalog can't price contribute $0 (see fleet_prices)."""
    prices, _ = fleet_prices(nodes, catalog)
    return sum(prices.values())


def reschedulable_pods(pods: Sequence[Pod]) -> Tuple[List[Pod], bool]:
    """(pods to re-pack, node is a candidate). Daemonset/static pods stay
    with the node; a do-not-evict annotation pins the whole node
    (termination/terminate.go do-not-evict check)."""
    movable: List[Pod] = []
    for p in pods:
        if p.metadata.annotations.get(wellknown.DO_NOT_EVICT_ANNOTATION) == "true":
            return [], False
        if podutil.is_owned_by_daemonset(p) or podutil.is_owned_by_node(p):
            continue
        movable.append(p)
    return movable, True


@dataclass
class ConsolidationPlan:
    """A whole-fleet re-pack proposal."""

    nodes_to_remove: List[Node]
    replacement: SolveResult
    current_nodes: int
    current_cost_per_hour: float
    planned_cost_per_hour: float
    relax: Optional[object] = None  # solver.relax.RelaxInfo when backend="relax"

    @property
    def planned_nodes(self) -> int:
        return self.replacement.node_count

    @property
    def saves(self) -> bool:
        if self.replacement.unschedulable:
            return False  # never trade running pods for savings
        if self.planned_nodes < self.current_nodes:
            return True
        return self.planned_cost_per_hour < self.current_cost_per_hour - 1e-9


@dataclass
class Fleet:
    """One provisioner's consolidation scope: its running nodes, their pods,
    and the constraints/catalog its replacement capacity must come from."""

    nodes: Sequence[Node]
    pods_by_node: Dict[str, List[Pod]]
    constraints: Constraints
    catalog: Sequence[InstanceType]
    daemons: Sequence[Pod] = ()


def repack_plan(
    nodes: Sequence[Node],
    pods_by_node: Dict[str, List[Pod]],
    constraints: Constraints,
    catalog: Sequence[InstanceType],
    daemons: Sequence[Pod] = (),
    solver_config: Optional[SolverConfig] = None,
    backend: str = "ffd",
    device: DeviceLike = None,
) -> ConsolidationPlan:
    """Minimal-set re-pack of every candidate node's reschedulable pods —
    one solve on the same pack kernel as provisioning, on ``device``
    (default: the CUDA device; ``"cpu"`` runs the plain versions).

    ``backend="relax"`` routes the replacement solve through the relaxation
    (solver/relax.py): its rounded plan is used only when strictly cheaper
    AND fully feasible, else the exact FFD plan."""
    return repack_plan_multi(
        [Fleet(nodes, pods_by_node, constraints, catalog, daemons)],
        solver_config=solver_config, backend=backend, device=device)[0]


def repack_plan_multi(
    fleets: Sequence[Fleet],
    solver_config: Optional[SolverConfig] = None,
    backend: str = "ffd",
    device: DeviceLike = None,
) -> List[ConsolidationPlan]:
    """Whole-fleet re-packs for MANY provisioners in one batched launch:
    the per-fleet forward solves ride solver/batch_solve.solve_batch, as
    the provisioning window does."""
    from karpenter_tpu_torch.solver.batch_solve import Problem, solve_batch

    prepared = []
    for fleet in fleets:
        candidates: List[Node] = []
        movable: List[Pod] = []
        for node in fleet.nodes:
            pods, ok = reschedulable_pods(
                fleet.pods_by_node.get(node.metadata.name, []))
            if not ok:
                continue
            candidates.append(node)
            movable.extend(pods)
        prepared.append((fleet, candidates, movable))

    relax_infos: List[Optional[object]] = [None] * len(prepared)
    if backend == "relax":
        from karpenter_tpu_torch.solver.relax import relax_solve

        replacements = []
        for idx, (fleet, _, movable) in enumerate(prepared):
            replacement, info = relax_solve(
                fleet.constraints, movable, fleet.catalog,
                daemons=fleet.daemons, config=solver_config, device=device)
            replacements.append(replacement)
            relax_infos[idx] = info
    elif len(prepared) == 1:  # solo fleet: no batch machinery
        fleet, candidates, movable = prepared[0]
        replacements = [solve(fleet.constraints, movable, fleet.catalog,
                              daemons=fleet.daemons, config=solver_config,
                              device=device)]
    else:
        replacements = solve_batch(
            [Problem(constraints=fleet.constraints, pods=movable,
                     instance_types=fleet.catalog, daemons=fleet.daemons)
             for fleet, _, movable in prepared],
            config=solver_config, device=device)

    return [
        ConsolidationPlan(
            nodes_to_remove=candidates,
            replacement=replacement,
            current_nodes=len(candidates),
            current_cost_per_hour=current_cost(candidates, fleet.catalog),
            planned_cost_per_hour=plan_cost(replacement.packings,
                                            fleet.constraints.requirements),
            relax=info,
        )
        for (fleet, candidates, _), replacement, info
        in zip(prepared, replacements, relax_infos)
    ]


# ---------------------------------------------------------------------------
# Incremental consolidation: fit one node's pods into surviving free space.
# ---------------------------------------------------------------------------


def free_capacity_vector(node: Node, pods: Sequence[Pod]) -> List[int]:
    """allocatable − Σ pod requests, in solver nano-units. The "pods"
    allocatable lands on R_PODS via the well-known resource mapping; each
    running pod additionally consumes one slot there."""
    free = list(resource_list_vector(node.status.allocatable))
    for p in pods:
        v = pod_vector(p)
        for r in range(NUM_RESOURCES):
            free[r] -= v[r]
        free[R_PODS] -= NANO  # one pod slot each
    return free


@dataclass
class _Bin:
    """A surviving node's free capacity + the scheduling surface a moved pod
    must clear (labels for selector/affinity, taints for toleration)."""

    name: str
    free: List[int]
    labels: Dict[str, str]
    taints: Taints


def _bin_for(node: Node, pods: Sequence[Pod]) -> _Bin:
    return _Bin(
        name=node.metadata.name,
        free=free_capacity_vector(node, pods),
        labels=node.metadata.labels,
        taints=Taints(node.spec.taints),
    )


def node_bin(node: Node, pods: Sequence[Pod]) -> _Bin:
    """Public form of _bin_for: the what-if window encoder
    (ops/whatif.encode_window) consumes these as its bin set."""
    return _bin_for(node, pods)


def _compatible(pod: Pod, b: _Bin) -> bool:
    """Would the kube scheduler place this pod on this node? nodeSelector/
    affinity requirements against node labels + taint toleration — the
    checks the resource-only fit can't see. A NotIn-only requirement
    evaluates to the empty set (the Go quirk, requirements.go:189-194),
    which is conservatively incompatible everywhere."""
    reqs = pod_requirements(pod)
    for key in reqs.keys():
        allowed = reqs.requirement(key)
        if allowed is None:
            continue
        if b.labels.get(key) not in allowed:
            return False
    return not b.taints.tolerates(pod)


def place_onto(
    pods: Sequence[Pod],
    bins: Sequence[_Bin],
    commit: bool = False,
) -> Optional[List[str]]:
    """First-fit-decreasing into FIXED bins, honoring scheduling
    compatibility: bin names each pod landed on, or None if any pod cannot
    be placed. With ``commit``, the placement is charged against the bins'
    free vectors (used exactly once per removal so the feasibility check
    and the accounting can never diverge). No new nodes — that is
    repack_plan's job."""
    trial = [list(b.free) for b in bins]
    placed_names: List[str] = []
    ordered = sorted(((pod_vector(p), p) for p in pods),
                     key=lambda t: (-t[0][0], -t[0][1]))
    for vec, pod in ordered:
        placed = None
        for i, b in enumerate(bins):
            f = trial[i]
            if not all(f[r] >= vec[r] for r in range(NUM_RESOURCES)):
                continue
            if f[R_PODS] < NANO:
                continue
            if not _compatible(pod, b):
                continue
            for r in range(NUM_RESOURCES):
                f[r] -= vec[r]
            f[R_PODS] -= NANO
            placed = i
            break
        if placed is None:
            return None
        placed_names.append(bins[placed].name)
    if commit:
        for i, b in enumerate(bins):
            b.free[:] = trial[i]
    return placed_names


def fits_on_existing(pod_vecs: Sequence[Sequence[int]],
                     free_vecs: Sequence[List[int]]) -> bool:
    """Resource-only convenience form of place_onto (no labels/taints) for
    callers that already hold raw vectors."""
    bins = [_Bin(name=str(i), free=list(f), labels={}, taints=Taints())
            for i, f in enumerate(free_vecs)]
    trial = [list(b.free) for b in bins]
    for v in sorted(pod_vecs, key=lambda v: (-v[0], -v[1])):
        placed = False
        for f in trial:
            if all(f[r] >= v[r] for r in range(NUM_RESOURCES)) and f[R_PODS] >= NANO:
                for r in range(NUM_RESOURCES):
                    f[r] -= v[r]
                f[R_PODS] -= NANO
                placed = True
                break
        if not placed:
            return False
    return True


def removable_nodes(
    nodes: Sequence[Node],
    pods_by_node: Dict[str, List[Pod]],
    max_actions: int = 1,
) -> List[Node]:
    """Nodes (least-loaded first) whose reschedulable pods all fit — by
    resources AND scheduling constraints — on the other candidates' free
    capacity. Conservative, one safe step at a time: at most ``max_actions``
    per pass, and a node that RECEIVED another removal's pods this pass is
    never itself removed (its free vector now backs that placement)."""
    infos = []
    for node in nodes:
        if node.metadata.deletion_timestamp is not None:
            continue
        pods = pods_by_node.get(node.metadata.name, [])
        movable, ok = reschedulable_pods(pods)
        if not ok:
            continue
        infos.append((node, pods, movable))

    # least pods first: cheapest to move
    infos.sort(key=lambda t: len(t[2]))
    bins = {n.metadata.name: _bin_for(n, pods) for n, pods, _ in infos}
    removed: List[Node] = []
    removed_names: set = set()
    receivers: set = set()
    for node, _, movable in infos:
        if len(removed) >= max_actions:
            break
        name = node.metadata.name
        if not movable:
            continue  # empty nodes are the emptiness controller's job
        if name in receivers:
            continue  # its capacity already backs an earlier removal
        targets = [b for other, b in bins.items()
                   if other != name and other not in removed_names]
        landed = place_onto(movable, targets, commit=True)
        if landed is not None:
            removed.append(node)
            removed_names.add(name)
            receivers.update(landed)
    return removed
