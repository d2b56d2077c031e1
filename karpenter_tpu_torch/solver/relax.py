"""Relaxation repack: the cost-minimizing global repack of one problem.

FFD minimizes node count; with a priced catalog the cheapest fleet is not
always the smallest. This module solves the relaxation

    minimize    Σ_t price_t · n_t
    subject to  Σ_t x_st = c_s                      (every shape assigned)
                Σ_s x_st · shape_sr ≤ n_t · cap_tr  (type capacity)
                x ≥ 0, n ≥ 0

by projected gradient on the penalty objective: the window program of
solver/global_solve.py (:func:`relax_node_counts`) with one row, unpadded.
Its only output is a support (which types the optimum uses); the rounding
is the exact host FFD restricted to that support, and the rounded plan
replaces the exact FFD plan only when it is fully feasible and strictly
cheaper in exact int micro-$ (ops/global_solve.price_micro). A device error
raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.backend import DeviceLike, resolve_device
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.models.cost import CostConfig, effective_price
from karpenter_tpu_torch.ops.encode import encode
from karpenter_tpu_torch.ops.global_solve import (
    SAT_MICRO, objective_prices, one_problem_window, plan_cost_micro, price_micro,
)
from karpenter_tpu_torch.solver import host_ffd
from karpenter_tpu_torch.solver.adapter import build_packables_cached, marshal_pods_interned
from karpenter_tpu_torch.solver.global_solve import ITERS, program_inputs, run_program
from karpenter_tpu_torch.solver.host_ffd import HostSolveResult
from karpenter_tpu_torch.solver.solve import SolveResult, SolverConfig, materialize, solve


@dataclass
class RelaxInfo:
    """What the relaxation did. The cost fields are $/h derived from the
    exact int micro-$ comparison; the decision is never made in float."""

    used: bool
    reason: str            # "relaxation" or "fallback-<why>"
    relax_cost: float = float("inf")
    ffd_cost: float = float("inf")
    support: int = 0       # instance types the relaxation selected
    iters: int = 0
    seconds: float = 0.0


def _relax_support(enc, prices_by_packable: Sequence[float], device) -> Optional[List[int]]:
    """Run the relaxation on ``device``; returns the packable positions in
    the optimum's support, or None when a node count is not finite."""
    win = one_problem_window(enc, prices_by_packable)
    n = run_program(program_inputs(win, device), win.tb)[0].cpu().numpy()
    if not np.all(np.isfinite(n)):
        return None
    # a type carries the support when the optimum provisions a meaningful
    # fraction of a node there (0.4 absorbs rounding noise; n is in nodes)
    return [t for t in range(win.tb) if n[t] >= max(0.4, 0.02 * float(n.max()))]


def relax_pack(
    pod_vecs: Sequence[Sequence[int]],
    pod_ids: Sequence[int],
    packables,
    prices_sorted_types: Sequence[float],
    device: DeviceLike = None,
) -> Tuple[HostSolveResult, RelaxInfo]:
    """Exact FFD baseline and relaxation-restricted FFD rounding on
    ``device`` (default: the CUDA device); the cheapest feasible wins.
    ``pod_vecs`` must be sorted descending (host_ffd.pack's contract);
    ``prices_sorted_types`` is $/h per sorted_types position."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ffd = host_ffd.pack(pod_vecs, pod_ids, packables)
    # all cost accounting in exact int micro-$: a float objective can
    # mis-rank near-tied fleets
    micro = [price_micro(p) for p in prices_sorted_types]
    ffd_micro = plan_cost_micro(ffd, micro) if ffd.packings else 0

    def fallback(reason: str, relax_micro: Optional[int] = None,
                 ) -> Tuple[HostSolveResult, RelaxInfo]:
        return ffd, RelaxInfo(
            used=False, reason=f"fallback-{reason}",
            relax_cost=relax_micro / 1e6 if relax_micro is not None else float("inf"),
            ffd_cost=ffd_micro / 1e6, iters=ITERS, seconds=time.perf_counter() - t0)

    if not packables or not pod_vecs:
        return fallback("empty")
    by_pos = [micro[p.index] for p in packables]
    if not any(0 < m < SAT_MICRO for m in by_pos):
        return fallback("unpriced")  # the objective is degenerate without prices
    enc = encode(pod_vecs, pod_ids, packables, pad=False)
    if enc is None:
        return fallback("unencodable")
    keep = _relax_support(enc, objective_prices(by_pos), dev)
    if not keep:
        return fallback("no-support" if keep == [] else "non-finite")
    restricted = [packables[t].copy() for t in keep]
    rounded = host_ffd.pack(pod_vecs, pod_ids, restricted)
    if rounded.unschedulable:
        return fallback("infeasible")
    relax_micro = plan_cost_micro(rounded, micro)
    if ffd.unschedulable == [] and relax_micro >= ffd_micro:
        return fallback("costlier", relax_micro)
    return rounded, RelaxInfo(
        used=True, reason="relaxation", relax_cost=relax_micro / 1e6,
        ffd_cost=ffd_micro / 1e6, support=len(keep), iters=ITERS,
        seconds=time.perf_counter() - t0)


def relax_solve(
    constraints: Constraints,
    pods: Sequence[Pod],
    instance_types: Sequence[InstanceType],
    daemons: Sequence[Pod] = (),
    config: Optional[SolverConfig] = None,
    device: DeviceLike = None,
) -> Tuple[SolveResult, RelaxInfo]:
    """solve() with the relaxation backend on ``device`` (default: the CUDA
    device): the exact path (the port's solve()) always runs; the rounded
    plan replaces it only when strictly cheaper and fully feasible."""
    config = config or SolverConfig()
    dev = resolve_device(device)
    exact = solve(constraints, pods, instance_types, daemons=daemons, config=config,
                  device=dev)
    pod_vecs, required, _ = marshal_pods_interned(pods)
    packables, sorted_types = build_packables_cached(instance_types, constraints, pods,
                                                     daemons, required=required)
    if not packables:
        return exact, RelaxInfo(used=False, reason="fallback-no-packables")
    order = sorted(range(len(pods)), key=lambda i: (-pod_vecs[i][0], -pod_vecs[i][1]))
    prices = [effective_price(it, constraints.requirements, CostConfig())[0]
              for it in sorted_types]
    prices = [0.0 if p == float("inf") else p for p in prices]
    rounded, info = relax_pack([pod_vecs[i] for i in order], order, packables, prices,
                               device=dev)
    if not info.used:
        return exact, info
    return materialize(rounded, list(pods), sorted_types, constraints, config), info
