"""Batch solve: the schedules of a provisioning window in one device launch
per chunk, split into a dispatch half and a fetch half.

The scheduler emits one independent packing problem per isomorphic
constraint group; the reference packs them one after the other. This
module packs every problem that can join the batch in ONE launch of the
pack kernel per chunk, a cluster of CTAs per problem
(parallel/batched_pack.py), with the window's feasibility mask computed on
the device (ops/device_filter.py) and fed to the kernel as its ``valid``
input. Each chunk costs one device→host copy. Pods are marshaled through
the delta-marshal arena (``adapter.marshal_pods_interned``), packables are
versioned (``adapter.build_packables_versioned``), and with
``SolverConfig.device_donate`` (the default) the batch's tensors come from
a slot of the process ``DeviceRing`` (solver/pipeline.py): a window whose
catalog, constraints and pods repeat copies only its counts rows. The JAX
package's host mirrors for its hedged fetch are left out: the port has no
hedge.

:func:`dispatch_batch` marshals, encodes, computes the mask and enqueues the
first chunk on the current CUDA stream without synchronising, and returns a
:class:`BatchHandle`; ``fetch()`` copies each chunk to the host, resumes
the chunks that outlive ``chunk_iters`` (compacting the shapes of the whole
batch to a smaller bucket when they allow it) and decodes.
:func:`solve_batch` is the two back to back. Results are those of solving
each problem alone, problem for problem.

Problems that cannot join the batch are solved alone
(``solve_with_packables``) at fetch: a lone problem, an unencodable
problem (more distinct shapes than the largest bucket included), an empty
allowed set, and a fused member whose scalar re-verification disagrees
with the device mask (counted by ``ops.device_filter.fallback_counts``).
The JAX package also solves a window of few pods problem by problem
(``device_min_pods``), since its native host ring answers small problems
faster than a device round trip; the port has no such ring, so every
window of two or more problems joins the batch. An error from the mask,
the launch or the copy is not caught: it propagates out of
``dispatch_batch`` or ``fetch()``.

Tracing follows the JAX package: the launch runs inside the
``karpenter.solve.batch_dispatch`` profiler range, and the handle carries
the dispatching window's span context and SLO marks, so ``fetch()`` (a
``fetch`` span, its device wait and decode inside the
``karpenter.solve.batch_device`` range) joins the window's trace on
whichever thread it runs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence

from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.backend import DeviceLike, resolve_device
from karpenter_tpu_torch.cloudprovider.spi import InstanceType
from karpenter_tpu_torch.metrics.policy import POLICY_SCORE_SECONDS
from karpenter_tpu_torch.models.ffd import DeviceRun, _decode
from karpenter_tpu_torch.obs import slo as obslo
from karpenter_tpu_torch.obs import trace as obtrace
from karpenter_tpu_torch.ops import device_filter
from karpenter_tpu_torch.ops.encode import encode, pad_encoding
from karpenter_tpu_torch.solver.adapter import (
    build_packables_versioned, marshal_pods_interned,
)
from karpenter_tpu_torch.ops import policy as ops_policy
from karpenter_tpu_torch.solver import policy as policy_registry
from karpenter_tpu_torch.solver.policy import soft_zone_adjust, soft_zone_votes
from karpenter_tpu_torch.solver.solve import (
    SolveResult, SolverConfig, materialize, record_executor, solve_with_packables,
)
from karpenter_tpu_torch.utils.profiling import trace


@dataclass
class Problem:
    constraints: Constraints
    pods: Sequence[Pod]
    instance_types: Sequence[InstanceType]
    daemons: Sequence[Pod] = ()
    # preferred-affinity votes shared by the schedule's pods
    # ({(topology_key, value): signed weight}); the scoring program prices
    # the zone-keyed entries (ops/policy.py), everything else is inert here
    soft_affinity: Optional[Mapping] = None


def solve_batch(problems: Sequence[Problem], config: Optional[SolverConfig] = None,
                device: DeviceLike = None) -> List[SolveResult]:
    """Solve each problem on ``device`` (default: the CUDA device; ``"cpu"``
    runs the plain versions), the eligible ones in one batch."""
    return dispatch_batch(problems, config, device).fetch()


def dispatch_batch(problems: Sequence[Problem], config: Optional[SolverConfig] = None,
                   device: DeviceLike = None) -> "BatchHandle":
    """Prepare and encode every problem, compute the window's mask and
    enqueue the first chunk of the batch; on a CUDA device nothing here
    waits for the device. Problems that cannot join the batch are carried
    on the handle and solved alone at fetch, so ``dispatch_batch(p).fetch()``
    is ``solve_batch(p)``."""
    config = config or SolverConfig()
    dev = resolve_device(device)
    marshaled = [marshal_pods_interned(prob.pods) for prob in problems]
    device_gate = len(problems) >= 2

    # the fused filter replaces the host filter and per-constraint packables
    # of every problem it admits: they encode against the shared universe
    # type axis, and their valid/last_valid rows stay on the device
    fused = None
    if device_gate and config.device_filter:
        fused = device_filter.prepare_fused(problems, marshaled, dev)
    fused_set = frozenset(fused.batch_idx) if fused is not None else frozenset()

    prepared: List[Optional[tuple]] = [None] * len(problems)
    for i, prob in enumerate(problems):
        if i in fused_set:
            continue  # a fused member that falls back builds these at fetch
        prepared[i] = _prepare(prob, marshaled[i])

    policy = policy_registry.get(config.packing_policy)
    # non-default policies imply the in-kernel tie-break: a policy that
    # never scored would silently behave as cheapest
    tiebreak = config.cost_tiebreak or policy.always_tiebreak

    def problem_prices(i: int) -> Optional[list]:
        """Problem i's per-packable policy scores for the in-kernel cost
        tie-break, with its soft-affinity adjustment: the per-cell host
        loop, which a window the scoring program cannot take runs. Fused
        members price the whole universe axis; the kernel only compares
        prices of mask-valid types."""
        packables, sorted_types = ((fused.packables, fused.uni_types) if i in fused_set
                                   else prepared[i][:2])
        if not (packables and any(it.price for it in sorted_types)):
            return None
        votes = soft_zone_votes(problems[i].soft_affinity)
        reqs = problems[i].constraints.requirements
        ctx = config.policy_context
        return [policy.score(sorted_types[p.index], reqs, config.cost_config, ctx)[0]
                + soft_zone_adjust(sorted_types[p.index], reqs, votes, ctx)
                for p in packables]

    batch_idx: List[int] = []
    encs = []
    raw_encs: List[Optional[object]] = [None] * len(problems)
    if fused is not None:
        batch_idx, encs = list(fused.batch_idx), list(fused.encs)
    elif device_gate:
        for i, prob in enumerate(problems):
            packables, _, vecs, sids, cat_version = prepared[i]
            # exact-size encode once: a problem left out of the batch hands
            # it to the solo path, a member pads it to the buckets
            enc = encode(vecs, list(range(len(prob.pods))), packables, pad=False,
                         sids=sids, catalog_version=cat_version) if packables else None
            raw_encs[i] = enc
            if enc is not None:
                penc = pad_encoding(enc)
                if penc is not None:
                    batch_idx.append(i)
                    encs.append(penc)

    run = None
    if len(batch_idx) >= 2:
        with trace("karpenter.solve.batch_dispatch"):
            prices_list = [None] * len(batch_idx)
            if tiebreak:
                # a fused window over a priced catalog is scored in one
                # program (ops/policy.py) and rides the prices seam as
                # pre-encoded int32 rows; any other window pays the
                # per-cell host loop
                scored = None
                if fused is not None and any(it.price for it in fused.uni_types):
                    scored = ops_policy.score_fused_window(
                        fused, policy, config.cost_config, config.policy_context)
                if scored is not None:
                    prices_list = scored[0]
                else:
                    t_score = time.perf_counter()
                    prices_list = [problem_prices(i) for i in batch_idx]
                    if any(p is not None for p in prices_list):
                        POLICY_SCORE_SECONDS.observe(
                            time.perf_counter() - t_score, stage="host")
            mask = (fused.mask_d, fused.last_valid_d) if fused is not None else None
            run = DeviceRun(encs, prices_list, config.chunk_iters, dev, mask=mask,
                            donate=config.device_donate)
            run.launch()
    return BatchHandle(problems, config, dev, prepared, raw_encs, marshaled,
                       batch_idx, run, fused if run is not None else None)


def _prepare(prob: Problem, marshaled) -> tuple:
    """A problem's host-filtered ``(packables, sorted_types, vecs, sids,
    catalog version)`` from its ``marshal_pods_interned`` triple."""
    vecs, required, sids = marshaled
    packables, sorted_types, cat_version = build_packables_versioned(
        prob.instance_types, prob.constraints, prob.pods, prob.daemons, required=required)
    return packables, sorted_types, vecs, sids, cat_version


class BatchHandle:
    """One dispatched batched solve, possibly still in flight.

    ``fetch()`` is idempotent: the results are computed once and kept. It
    waits for the batch's chunks, decodes the device answers and solves
    every other problem alone. If it raises, every later call raises too:
    a failed batch is never answered by another path. The batch's ring slot
    is released once its last chunk is on the host; ``device_run``'s
    device tensors raise ``RuntimeError`` after that (its counts, such as
    ``launches`` and ``buckets``, stay readable)."""

    def __init__(self, problems, config, device, prepared, raw_encs, marshaled,
                 batch_idx, run, fused):
        self._problems = list(problems)
        self._config = config
        self._device = device
        self._prepared = prepared
        self._raw_encs = raw_encs
        self._marshaled = marshaled
        self._batch_idx = batch_idx
        # the device batch (None when no problem joined one); it keeps its
        # launch and bucket counts after the fetch
        self.device_run = run
        # the fused mask's members and verification (None: host-filtered)
        self.fused = fused
        self._results: Optional[List[SolveResult]] = None
        self._error: Optional[BaseException] = None
        # the dispatching window's span context and SLO marks: the fetch
        # half re-enters them on whichever thread it runs
        self._trace_ctx = obtrace.current_context()
        self._slo_marks = obslo.current_marks()

    @property
    def in_flight(self) -> bool:
        """True while a device batch is launched but not yet fetched."""
        return self._results is None and self._error is None and self.device_run is not None

    def fetch(self) -> List[SolveResult]:
        if self._results is not None:
            return self._results
        if self._error is not None:
            raise RuntimeError("an earlier fetch of this batch failed") from self._error
        try:
            with obtrace.use_context(self._trace_ctx), \
                    obslo.use_marks(self._slo_marks), \
                    obtrace.span("fetch", batched=len(self._batch_idx)):
                self._results = self._fetch()
        except BaseException as e:
            self._error = e
            raise
        return self._results

    def _fetch(self) -> List[SolveResult]:
        problems, config, prepared = self._problems, self._config, self._prepared
        results: List[Optional[SolveResult]] = [None] * len(problems)
        run, fused = self.device_run, self.fused
        if run is not None:
            with trace("karpenter.solve.batch_device"):
                records, dropped = run.finish()
                if fused is not None:
                    host_results = fused.decode_all(_decode, records, dropped)
                else:
                    host_results = [
                        _decode(enc, records[j], dropped[j], prepared[i][0])
                        for j, (i, enc) in enumerate(zip(self._batch_idx, run.encs))]
            answered = 0
            for j, i in enumerate(self._batch_idx):
                if host_results[j] is None:
                    continue  # the device mask disagreed: solved alone below
                sorted_types = fused.uni_types if fused is not None else prepared[i][1]
                results[i] = materialize(host_results[j], problems[i].pods, sorted_types,
                                         problems[i].constraints, config)
                answered += 1
            if answered:
                record_executor("device-batch", count=answered)

        for i, prob in enumerate(problems):
            if results[i] is not None:
                continue
            if prepared[i] is None:
                # a fused member falling back: the host-filtered packables
                # it skipped at dispatch
                prepared[i] = _prepare(prob, self._marshaled[i])
            packables, sorted_types, vecs, sids, cat_version = prepared[i]
            results[i] = solve_with_packables(
                prob.constraints, prob.pods, packables, sorted_types, vecs, config,
                device=self._device, enc=self._raw_encs[i], sids=sids,
                catalog_version=cat_version)
        return results
