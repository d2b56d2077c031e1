"""Public solver entry: constraints + pods + catalog → node packings.

A problem of ``SolverConfig.device_min_pods`` pods or more goes to the
device path (models/ffd.py, the CUDA pack kernel); a smaller one goes to
the native host ring (solver/native_ffd.py, native/ffd.cc), as in the JAX
package, where a device round trip costs more than the solve. A problem
past the largest shape bucket goes to the ring too; one with no exact
encoding (exotic quantities), or that overflows the ring's record buffer,
goes to the host oracle (host_ffd.py). The ring is never a failure
fallback: an exception from the device, or from building the ring,
propagates to the caller. A window of many problems goes through
solver/batch_solve.py.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import NodeSelectorRequirement, Pod
from karpenter_tpu_torch.api.requirements import Requirements
from karpenter_tpu_torch.backend import DeviceLike, resolve_device
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.metrics.policy import POLICY_SPOT_SELECTED_TOTAL
from karpenter_tpu_torch.models.cost import CostConfig
from karpenter_tpu_torch.models.ffd import solve_ffd_device
from karpenter_tpu_torch.ops.encode import encode
from karpenter_tpu_torch.solver import host_ffd
from karpenter_tpu_torch.solver.adapter import (
    build_packables_versioned, marshal_pods_interned,
)
from karpenter_tpu_torch.solver import policy as policy_registry
from karpenter_tpu_torch.solver.native_ffd import solve_ffd_native_auto
from karpenter_tpu_torch.solver.policy import PolicyContext
from karpenter_tpu_torch.utils.gcguard import gc_deferred
from karpenter_tpu_torch.utils.profiling import trace

# -- solver health: which executor answered, and how often -------------------
_HEALTH_LOCK = threading.Lock()
_LAST_EXECUTOR: Optional[str] = None   # "device" | "device-batch" | "native" | "host"
_EXECUTOR_COUNTS: Dict[str, int] = {}


def record_executor(executor: str, count: int = 1) -> None:
    """Note which executor answered ``count`` problems: a batched launch
    answers many at once and counts each."""
    global _LAST_EXECUTOR
    with _HEALTH_LOCK:
        _LAST_EXECUTOR = executor
        _EXECUTOR_COUNTS[executor] = _EXECUTOR_COUNTS.get(executor, 0) + count


def solver_health() -> dict:
    """Snapshot: the last executor and the per-executor counts."""
    with _HEALTH_LOCK:
        return {"last_executor": _LAST_EXECUTOR,
                "executor_counts": dict(_EXECUTOR_COUNTS)}


def reset_executor_counts() -> None:
    with _HEALTH_LOCK:
        _EXECUTOR_COUNTS.clear()


@dataclass
class SolverConfig:
    # a batched window computes its feasibility mask on the device and feeds
    # it to the pack kernel (ops/device_filter.py); False, or the
    # KARPENTER_DEVICE_FILTER=0 kill switch, filters each problem on the host
    device_filter: bool = True
    # node decisions per kernel launch (one device→host copy per chunk)
    chunk_iters: int = 64
    # prices each node's options cheapest-first when the catalog carries
    # prices (models/cost.py); capacity order otherwise
    cost_config: CostConfig = field(default_factory=CostConfig)
    # in-kernel cost tie-break: among types achieving max pods for a node,
    # pick the cheapest instead of Go's first-smallest. Changes which node
    # set is produced, so it is off by default (parity mode).
    cost_tiebreak: bool = False
    # packing policy (solver/policy.py registry): which score orders each
    # node's type options and feeds the in-kernel tie-break. "cheapest"
    # (the default) delegates to models/cost.py; non-default policies imply
    # the tie-break (always_tiebreak), since a policy that never scored
    # would silently be cheapest
    packing_policy: str = "cheapest"
    # pricing context for non-default policies: the what-if engine's repack
    # cost (interruption-priced), the throughput table
    # (throughput-per-dollar) and the soft-affinity weight price
    policy_context: PolicyContext = field(default_factory=PolicyContext)
    # the provisioning controller's window backend: "global" solves each
    # window's relaxation beside dispatch_batch and takes a schedule's
    # rounded plan only where it is strictly cheaper in exact int micro-$
    # (solver/global_solve.py); "ffd" keeps the batch's plans
    window_backend: str = "global"
    # the device-resident hot loop (solver/pipeline.DeviceRing): a solve's
    # tensors come from a ring slot, refilled in place by a later solve of
    # the same buckets (B13), and tensors whose content token matches copy
    # nothing; False copies every solve's inputs to fresh tensors
    device_donate: bool = True
    # below this many pods a device launch costs more than it saves: the
    # solo solve answers on the native host ring, and a window joins the
    # device batch only when its problems hold this many pods together
    # (0 sends everything to the device)
    device_min_pods: int = 512


@dataclass
class Packing:
    """Mirror of binpacking.Packing (packer.go:73-77), with resolved objects."""

    pods: List[List[Pod]]
    instance_type_options: List[InstanceType]
    node_quantity: int = 1


@dataclass
class SolveResult:
    packings: List[Packing] = field(default_factory=list)
    unschedulable: List[Pod] = field(default_factory=list)

    @property
    def node_count(self) -> int:
        return sum(p.node_quantity for p in self.packings)


def global_requirements(instance_types: Sequence[InstanceType]) -> Requirements:
    """Supported zones/types/arch/OS/capacity-types as requirements
    (controller.go:141-162): the 'universe' that makes unconstrained keys
    concrete before they reach the solver."""
    zones, names, archs, oss, cts = set(), set(), set(), set(), set()
    for it in instance_types:
        names.add(it.name)
        archs.add(it.architecture)
        oss |= set(it.operating_systems)
        for o in it.offerings:
            zones.add(o.zone)
            cts.add(o.capacity_type)
    req = NodeSelectorRequirement
    return Requirements().add(
        req(key=wellknown.LABEL_TOPOLOGY_ZONE, operator="In", values=sorted(zones)),
        req(key=wellknown.LABEL_INSTANCE_TYPE, operator="In", values=sorted(names)),
        req(key=wellknown.LABEL_ARCH, operator="In", values=sorted(archs)),
        req(key=wellknown.LABEL_OS, operator="In", values=sorted(oss)),
        req(key=wellknown.LABEL_CAPACITY_TYPE, operator="In", values=sorted(cts)),
    )


def universe_constraints(catalog: Sequence[InstanceType]) -> Constraints:
    """Constraints admitting everything the catalog offers — the universe
    injection the provisioning controller performs before solving."""
    return Constraints(requirements=global_requirements(catalog))


def solve(
    constraints: Constraints,
    pods: Sequence[Pod],
    instance_types: Sequence[InstanceType],
    daemons: Sequence[Pod] = (),
    config: Optional[SolverConfig] = None,
    device: DeviceLike = None,
) -> SolveResult:
    """Pods + catalog → node set, on ``device`` (default: the CUDA device;
    raises ``RuntimeError`` without one; ``"cpu"`` runs the plain
    versions)."""
    config = config or SolverConfig()
    dev = resolve_device(device)
    # collection deferred across the public path: a generational collection
    # landing mid-solve adds to the tail (utils/gcguard.py)
    with gc_deferred():
        pod_vecs, required, sids = marshal_pods_interned(pods)
        packables, sorted_types, catalog_version = build_packables_versioned(
            instance_types, constraints, pods, daemons, required=required)
        return solve_with_packables(constraints, pods, packables, sorted_types,
                                    pod_vecs, config, device=dev, sids=sids,
                                    catalog_version=catalog_version)


def solve_with_packables(
    constraints: Constraints,
    pods: Sequence[Pod],
    packables,
    sorted_types,
    pod_vecs,
    config: SolverConfig,
    device: DeviceLike = None,
    enc=None,
    sids=None,
    catalog_version: Optional[int] = None,
) -> SolveResult:
    """solve() after problem preparation; ``enc`` is the exact-size
    encoding when the caller (solver/batch_solve.py) already made it.
    ``sids`` (``adapter.marshal_pods_interned``) and ``catalog_version``
    (``adapter.build_packables_versioned``) go to the encoder: the
    vectorized dedupe and the versioned catalog arrays, whose token lets
    the device ring skip their copy."""
    if not packables:
        # same contract as host_ffd.pack: no viable types → every pod is
        # reported unschedulable
        return SolveResult(packings=[], unschedulable=list(pods))

    pod_ids = list(range(len(pods)))
    # per-packable policy score ($/h-shaped, lower wins) for the in-kernel
    # cost tie-break; the default policy's score IS effective_price
    policy = policy_registry.get(config.packing_policy)
    prices = None
    if (config.cost_tiebreak or policy.always_tiebreak) and \
            any(it.price for it in sorted_types):
        prices = [
            policy.score(sorted_types[p.index], constraints.requirements,
                         config.cost_config, config.policy_context)[0]
            for p in packables
        ]

    # one exact encoding feeds every executor: the device path pads it to
    # the buckets, the native ring takes it as it is; None (not
    # representable) → host oracle
    if enc is None:
        enc = encode(pod_vecs, pod_ids, packables, pad=False, sids=sids,
                     catalog_version=catalog_version)
    result = None
    executor = None
    if enc is not None and len(pods) >= config.device_min_pods:
        with trace("karpenter.solve.device"):
            result = solve_ffd_device(
                pod_vecs, pod_ids, packables, chunk_iters=config.chunk_iters,
                prices=prices, cost_tiebreak=prices is not None, enc=enc,
                device=device, donate=config.device_donate)
        executor = "device"
    if result is None and enc is not None:
        # under the gate, or past the device's largest shape bucket
        result = solve_ffd_native_auto(pod_vecs, pod_ids, packables, prices=prices,
                                       cost_tiebreak=prices is not None, enc=enc)
        executor = "native"
    if result is None:
        result = host_ffd.pack(pod_vecs, pod_ids, packables, prices=prices,
                               cost_tiebreak=prices is not None)
        executor = "host"
    record_executor(executor)
    return materialize(result, pods, sorted_types, constraints, config)


def materialize(result, pods, sorted_types, constraints: Constraints,
                config: SolverConfig) -> SolveResult:
    """HostSolveResult (ids/indices) → SolveResult (objects), with the
    cost-aware option ordering applied; a packing whose first option is
    spot counts its nodes in ``karpenter_policy_spot_selected_total``."""
    packings = [
        Packing(
            pods=[[pods[i] for i in node] for node in hp.pod_ids],
            instance_type_options=[sorted_types[j] for j in hp.instance_type_indices],
            node_quantity=hp.node_quantity,
        )
        for hp in result.packings
    ]
    if any(it.price for it in sorted_types):
        policy = policy_registry.get(config.packing_policy)
        for p in packings:
            p.instance_type_options = policy.order_options(
                p.instance_type_options, constraints.requirements,
                config.cost_config, config.policy_context)
            if p.instance_type_options:
                _, ct = policy.score(
                    p.instance_type_options[0], constraints.requirements,
                    config.cost_config, config.policy_context)
                if ct == wellknown.CAPACITY_TYPE_SPOT:
                    POLICY_SPOT_SELECTED_TOTAL.inc(
                        amount=float(p.node_quantity), policy=policy.name)
    return SolveResult(
        packings=packings,
        unschedulable=[pods[i] for i in result.unschedulable],
    )
