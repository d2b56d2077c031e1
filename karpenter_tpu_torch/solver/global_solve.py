"""Whole-window global solve: the relaxation as the window backend.

All schedules × priced instance types of a provisioning window solve
jointly as one batched projected-gradient program on the device
(:func:`relax_node_counts`), and first-fit-decreasing keeps two exact roles:

1. the rounding oracle: each schedule's accepted plan is the exact host FFD
   restricted to the relaxation's support (the types the optimum uses),
   never the relaxation's fractional answer;
2. the parity fallback: when the relaxation declines a schedule, or its
   rounded plan is not strictly cheaper in exact int micro-$, the caller
   keeps its FFD result object untouched.

:func:`dispatch_global_window` encodes the window, copies its float32
inputs to the device in one host→device copy, enqueues the program on the
current stream and records an event; ``GlobalHandle.fetch()`` waits on the
event, copies the node counts back once and rounds every schedule on the
host (:func:`_round_window`). The device answer is only a filter: every
accepted plan is re-verified on host nano ints
(ops/global_solve.verify_plan). A device error raises out of dispatch or
fetch; no path answers the window another way.

The program replaces the JAX package's jitted XLA program
(``solver/global_solve._global_jit``, a vmap of 300 projected-gradient
steps). It is torch code, not a hand kernel: per step the two products
over the tiny resource axis, written as a multiply and a sum per resource
some shape uses (no cuBLAS, so the process's TF32 setting cannot reach
them), and a dozen elementwise passes (PERF.md has the measured launches,
time and bound). The gradient is written out rather than taken by
autograd; it is the derivative of the penalty objective ``prices·n + ρ/2·Σ
over² + μ/2·Σ short²`` (the factor 2·over of ``over²`` is 0 wherever the
relu clips).
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.backend import DeviceLike, resolve_device, to_device_float32
from karpenter_tpu_torch.ops.global_solve import (
    SUPPORT, GlobalWindowEncoding, encode_window, plan_cost_micro, support_positions,
    verify_plan, widened_support_positions,
)
from karpenter_tpu_torch.solver import host_ffd
from karpenter_tpu_torch.solver.solve import (
    SolveResult, SolverConfig, materialize, record_executor,
)

# the penalty weights, the step size and the steps of the projected-gradient
# program
RHO, MU, LR = 8.0, 8.0, 0.05
ITERS = 300

# calls of the program (relax_node_counts), on any device: a run can show
# that its windows went through it
RUNS = 0


def enabled() -> bool:
    """The kill switch: KARPENTER_GLOBAL_SOLVE=0/false/off makes the
    provisioning controller take the FFD window backend whatever
    ``SolverConfig.window_backend`` says; default on."""
    return os.environ.get("KARPENTER_GLOBAL_SOLVE", "").strip().lower() not in ("0", "false", "off")


def warm_start(counts: torch.Tensor, num_types: torch.Tensor, tb: int) -> torch.Tensor:
    """The assignment's warm start, built where ``counts`` lies: each
    shape's count spread evenly over its row's first T types,
    ``counts / max(T, 1)`` (correctly rounded float32 division, as numpy's),
    0 past T. ``counts`` (B, SB), ``num_types`` (B,) float32 → (B, SB, TB)."""
    per = counts / num_types.clamp(min=1.0).unsqueeze(1)
    live = torch.arange(tb, device=counts.device, dtype=torch.float32) < num_types.unsqueeze(1)
    return (per.unsqueeze(2) * live.unsqueeze(1)).contiguous()


def used_resources(win: GlobalWindowEncoding) -> np.ndarray:
    """The resource columns the program walks: those some shape uses, and
    any with a negative capacity. Every other column adds exact zeros: its
    over term relu(0 − n·cap) is 0 for cap ≥ 0 and n ≥ 0 (the relu keeps
    n ≥ 0; a negative n0 keeps every column)."""
    if (win.d_n0 < 0).any():
        return np.arange(win.d_shapes.shape[2])
    return np.flatnonzero(win.d_shapes.any(axis=(0, 1)) | (win.d_caps < 0).any(axis=(0, 1)))


def program_inputs(win: GlobalWindowEncoding, device: torch.device) -> List[torch.Tensor]:
    """A window's program inputs on ``device`` in one host→device copy:
    (shapes, counts, caps, prices, tmask, n0, types per row), shapes and
    caps cut to :func:`used_resources`."""
    used = used_resources(win)
    return to_device_float32([win.d_shapes[:, :, used], win.d_counts, win.d_caps[:, :, used],
                              win.d_prices, win.d_tmask, win.d_n0, win.d_types], device)


def run_program(inputs: Sequence[torch.Tensor], tb: int) -> torch.Tensor:
    """The warm start and the program on :func:`program_inputs`' tensors."""
    shapes, counts, caps, prices, tmask, n0, types = inputs
    return relax_node_counts(shapes, counts, caps, prices, tmask,
                             warm_start(counts, types, tb), n0, ITERS)


def relax_node_counts(shapes: torch.Tensor, counts: torch.Tensor, caps: torch.Tensor,
                      prices: torch.Tensor, tmask: torch.Tensor, x0: torch.Tensor,
                      n0: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` projected-gradient steps per window row; returns the node
    counts n (B, TB). Inputs are float32 on one device: shapes (B, SB, R),
    counts (B, SB), caps (B, TB, R), prices (B, TB), tmask (B, TB), x0
    (B, SB, TB), n0 (B, TB). Per step, from the same (x, n)::

        over  = relu(xᵀ·shapes − n·caps)             (B, TB, R)
        short = Σ_t x − counts                       (B, SB)
        gx    = ρ·over·shapesᵀ + μ·short             (B, SB, TB)
        gn    = prices − ρ·Σ_r over·caps             (B, TB)
        x, n  = relu(x − lr·gx)·tmask, relu(n − lr·gn)·tmask

    Both products contract only R, so each is a multiply and a sum per
    resource in float32 on the vector units, never a matmul: TF32 cannot
    touch them, and no process-wide flag is read or set. R may be cut to
    the columns some shape uses (:func:`used_resources`).

    ``x0`` is updated in place (it ends as the final assignment): at the
    largest buckets it is hundreds of MB, and a copy would double that. One
    scratch tensor of x's size holds each product's terms and then gx.
    ``n0`` is not touched."""
    global RUNS
    RUNS += 1
    x, n = x0, n0.clone()
    xmask = tmask.unsqueeze(1)
    shape_cols = [shapes[:, :, r:r + 1] for r in range(shapes.shape[2])]   # (B, SB, 1)
    cap_cols = caps.permute(2, 0, 1).contiguous()                          # (R, B, TB)
    # ρ = 8 is a power of two, so folding it into the caps is exact
    cap_cols_rho = cap_cols * -RHO
    over = torch.empty_like(cap_cols)
    buf = torch.empty_like(x)
    for _ in range(iters):
        for r, col in enumerate(shape_cols):
            torch.sum(torch.mul(x, col, out=buf), dim=1, out=over[r])     # Σ_s x·shape_r
        over.addcmul_(n, cap_cols, value=-1.0).clamp_(min=0.0)
        short = x.sum(dim=2).sub_(counts)
        gx = torch.mul(short.unsqueeze(2).expand_as(x), MU, out=buf)
        for r, col in enumerate(shape_cols):
            gx.addcmul_(col, over[r].unsqueeze(1), value=RHO)
        gn = (over * cap_cols_rho).sum(dim=0).add_(prices)
        x.sub_(gx, alpha=LR).clamp_(min=0.0).mul_(xmask)
        n.sub_(gn, alpha=LR).clamp_(min=0.0).mul_(tmask)
    return n


@dataclass
class GlobalInfo:
    """What the global solve did for one schedule."""

    used: bool
    reason: str                 # "global" or "fallback-<why>"
    relax_cost_micro: int = 0   # exact int micro-$/h of the rounded plan
    ffd_cost_micro: int = 0     # exact int micro-$/h of the FFD baseline
    support: int = 0
    iters: int = 0
    widened: bool = False       # accepted through the widened-support retry


@dataclass
class GlobalPlan:
    """The window's verdict: per problem the accepted SolveResult (None
    keeps the FFD result untouched) and its info, and the executor that
    answered ("device-global", or "none" when no schedule reached the
    program)."""

    results: List[Optional[SolveResult]] = field(default_factory=list)
    infos: List[GlobalInfo] = field(default_factory=list)
    executor: str = "none"
    seconds: float = 0.0

    @property
    def accepted(self) -> int:
        return sum(1 for r in self.results if r is not None)


class GlobalHandle:
    """One dispatched window, possibly still in flight. ``fetch()`` is
    idempotent: the plan is computed once and kept; if it raises, every
    later call raises too."""

    def __init__(self, win: GlobalWindowEncoding, solver_config: SolverConfig, t0: float):
        self.win = win
        self.solver_config = solver_config
        self.n_device: Optional[torch.Tensor] = None   # (B, TB) node counts
        self.start_event = None                        # CUDA events around the program
        self.event = None
        self.encode_seconds = 0.0
        self.dispatch_seconds = 0.0                    # encode + copy + enqueue
        self.fetch_seconds = 0.0                       # wait + copy back
        self.round_seconds = 0.0                       # host rounding
        self._t0 = t0
        self._result: Optional[GlobalPlan] = None
        self._error: Optional[BaseException] = None

    @property
    def program_ms(self) -> Optional[float]:
        """The program's device time (CUDA events: warm start and steps),
        once fetched; None on the CPU."""
        if self._result is None or self.start_event is None:
            return None
        return self.start_event.elapsed_time(self.event)

    def fetch(self) -> GlobalPlan:
        if self._result is not None:
            return self._result
        if self._error is not None:
            raise RuntimeError("an earlier fetch of this window failed") from self._error
        try:
            self._result = self._fetch()
        except BaseException as e:
            self._error = e
            raise
        return self._result

    def _fetch(self) -> GlobalPlan:
        t0 = time.perf_counter()
        n_rows, executor = None, "none"
        if self.n_device is not None:
            if self.event is not None:
                self.event.synchronize()
            n_rows = self.n_device.cpu().numpy()
            executor = "device-global"
        t1 = time.perf_counter()
        plan = _round_window(self.win, n_rows, self.solver_config, executor)
        t2 = time.perf_counter()
        if n_rows is not None:
            record_executor(executor, count=len(self.win.live))
        self.fetch_seconds, self.round_seconds = t1 - t0, t2 - t1
        plan.seconds = t2 - self._t0
        return plan


def _round_window(win: GlobalWindowEncoding, n_rows: Optional[np.ndarray],
                  solver_config: SolverConfig, executor: str) -> GlobalPlan:
    """Per schedule: support → exact restricted host FFD rounding →
    strictly-cheaper test in exact int micro-$ → independent host
    re-verification. Anything short of all four keeps the FFD plan
    (results[pos] = None)."""
    plan = GlobalPlan(executor=executor)
    for s in win.scheds:
        info = GlobalInfo(used=False, reason="fallback-error", iters=ITERS)
        accepted: Optional[SolveResult] = None
        if s.reason is not None:
            info.reason = f"fallback-{s.reason}"
        elif s.row < 0 or n_rows is None:
            info.reason = "fallback-error"
        else:
            # adaptive keep rule: the acceptance EWMA slides the thresholds
            # between the strict and widened corners
            abs_thr, frac_thr = SUPPORT.thresholds()
            keep = support_positions(n_rows[s.row], s.num_types, abs_thr, frac_thr)
            info.support = len(keep)
            ffd = host_ffd.pack(s.pod_vecs, s.pod_ids, s.packables)
            info.ffd_cost_micro = plan_cost_micro(ffd, s.prices_micro) \
                if ffd.packings else 0

            def attempt(positions):
                """One restricted rounding pass through the whole gate chain
                (infeasible → costlier → unverified): (reason, plan or None)."""
                restricted = [s.packables[t].copy() for t in positions]
                rounded = host_ffd.pack(s.pod_vecs, s.pod_ids, restricted)
                if rounded.unschedulable:
                    return "fallback-infeasible", None
                rmicro = plan_cost_micro(rounded, s.prices_micro)
                info.relax_cost_micro = rmicro
                if ffd.unschedulable == [] and rmicro >= info.ffd_cost_micro:
                    return "fallback-costlier", None
                if not verify_plan({pid: vec for pid, vec in zip(s.pod_ids, s.pod_vecs)},
                                   {p.index: p for p in s.packables}, rounded):
                    return "fallback-unverified", None
                return "global", materialize(rounded, s.pods, s.sorted_types,
                                             s.constraints, solver_config)

            if not keep:
                # no support under the strict rule: retry the rounding once
                # on a widened support; an accept still passes every gate
                # above, a decline keeps the no-support verdict
                widened = widened_support_positions(n_rows[s.row], s.num_types)
                if widened:
                    _, accepted = attempt(widened)
                if accepted is not None:
                    info.used = True
                    info.reason = "global"
                    info.widened = True
                    info.support = len(widened)
                else:
                    info.reason = "fallback-no-support"
            else:
                reason, accepted = attempt(keep)
                info.reason = reason
                info.used = accepted is not None
            # the controller learns from the adaptive pass only: a widened
            # rescue counts as a miss, a strict accept as a hit
            SUPPORT.note(info.used and not info.widened)
        plan.results.append(accepted)
        plan.infos.append(info)
    return plan


def dispatch_global_window(problems: Sequence, solver_config: Optional[SolverConfig] = None,
                           device: DeviceLike = None) -> GlobalHandle:
    """Encode the window, copy its inputs to ``device`` (default: the CUDA
    device; ``"cpu"`` runs the program on the CPU) in one copy, and enqueue
    the program; on a CUDA device nothing here waits for the device."""
    solver_config = solver_config or SolverConfig()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    win = encode_window(problems, solver_config.cost_config)
    handle = GlobalHandle(win, solver_config, t0)
    handle.encode_seconds = time.perf_counter() - t0
    if win.device_ready:
        cuda = dev.type == "cuda"
        with torch.cuda.device(dev) if cuda else nullcontext():
            inputs = program_inputs(win, dev)
            if cuda:
                handle.start_event = torch.cuda.Event(enable_timing=True)
                handle.event = torch.cuda.Event(enable_timing=True)
                handle.start_event.record()
            handle.n_device = run_program(inputs, win.tb)
            if cuda:
                handle.event.record()
    handle.dispatch_seconds = time.perf_counter() - t0
    return handle


def solve_window_global(problems: Sequence, solver_config: Optional[SolverConfig] = None,
                        device: DeviceLike = None) -> GlobalPlan:
    """dispatch + fetch in one call."""
    return dispatch_global_window(problems, solver_config, device).fetch()
