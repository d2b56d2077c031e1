"""Packing-policy scoring of a fused window on the device (B6).

The host cost tie-break prices one (packable, constraints) cell at a time:
``policy.score()`` per packable per problem, a Python loop over offerings
inside each call. A fused window (ops/device_filter.py) already holds the
catalog's offering structure on the device as bit-planes; this module
scores EVERY (schedule × type × capacity type) cell of the window in one
torch program and hands the per-problem int32 micro-$ rows straight to the
pack kernel's ``prices`` seam (the JAX package's ``ops/policy.py``).

Table algebra (host-built, cached per (planes, policy, cost config, ctx)):

- ``price_ct (TB, C) int32``: the policy's base score of type t at capacity
  type c, in micro-$, encoded with models/ffd.encode_prices' exact float64
  truncation (``min(int(p * 1e6), INT32_MAX)``). Encoding is monotone, so
  min-over-offerings commutes with it: for penalty-free policies the
  device row is bit-for-bit ``encode_prices([policy.score(...)])``.
- ``rate_tz (TB, Z) float32``: spot interruption rate per (type, zone),
  +inf where the type has no spot offering in the zone. Only built for the
  interruption-priced policy.
- ``soft_bz (B, Z) int32`` (per window): a schedule's preferred-affinity
  votes as fixed-point micro-$ adjustments, ``clamp(-weight x
  round(soft_cost x 1e6))`` to ±(2³⁰−1) per voted zone, 0 elsewhere.

The program per window: the offering viability product ``zc & ct_allowed``
(the algebra of device_filter._mask_expr); for interruption-priced, the
reclaim tax ``round(float32(min allowed-zone rate) × float32(repack
micro-$))`` added to the spot column as ``min(spot + min(pen, 2³¹),
INT32_MAX)``; with votes, the best case over a cell's viable zones added as
``clamp(cell + adj, 0, INT32_MAX)`` where ``cell != INT32_MAX``. The JAX
package writes both saturations as uint32 adds; torch on the CPU has no
uint32 ``+`` or ``minimum``, so the program computes them in int64 with
explicit clamps, which give the same integers. ``best(b, t)`` is the min
over capacity types, INT32_MAX where none is viable.

The device verdict stays a FILTER: every member's row is checked at the
window's probe columns against :func:`_host_best`, a numpy mirror of the
same cells written separately (the JAX package's uint32 algebra); a member
that diverges gets its whole row from the mirror, counted in the JAX
package's ``karpenter_policy_fallback_total`` (``score-mismatch``, or
``soft-affinity-mismatch`` for a member with soft votes) and in
:data:`MISMATCHES`. A policy whose algebra does not factor into these
tables keeps the per-cell host loop (solver/batch_solve.py), counted as
``unfactorable-policy``. The program and the verification are timed in
``karpenter_policy_score_seconds`` and the viable cells counted in
``karpenter_policy_cells_scored_total``; :data:`RUNS` counts programs.
Left out: the ``KARPENTER_POLICY_DEVICE`` kill switch. A device error
raises.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.backend import to_device_float32, to_device_int32
from karpenter_tpu_torch.metrics.policy import (
    POLICY_CELLS_SCORED_TOTAL, POLICY_FALLBACK_TOTAL, POLICY_SCORE_SECONDS,
)
from karpenter_tpu_torch.ops.device_filter import planes_for, resident_planes, schedule_row
from karpenter_tpu_torch.scheduling.affinity import soft_enabled
from karpenter_tpu_torch.solver.policy import (
    CheapestFeasible, InterruptionPriced, ThroughputPerDollar, soft_zone_votes,
)

_INT32_MAX = np.int32(np.iinfo(np.int32).max)
# soft adjustments clamp to ±(2^30 - 1), the range the JAX package's
# offset-uint32 add needs
_SOFT_CLAMP = (1 << 30) - 1
_SOFT_OFF = np.uint32(1 << 30)

_LOCK = threading.Lock()
_TABLE_CACHE: dict = {}
_TABLE_CACHE_CAP = 16
_TCZ_CACHE: dict = {}
RUNS = 0            # scoring programs run since import
MISMATCHES = 0      # members whose row diverged at a probe column


def _encode_micro(p: float) -> np.int32:
    """EXACTLY models/ffd.encode_prices' per-entry truncation, so the
    device row and the host loop's encode_prices output agree bit-for-bit
    for penalty-free policies."""
    if p != float("inf"):
        return np.int32(min(int(p * 1e6), int(_INT32_MAX)))
    return _INT32_MAX


class _Tables:
    __slots__ = ("price_ct", "rate_tz", "spot_idx", "use_pen", "repack_micro")


def _build_tables(planes, policy, cost_config, ctx) -> Optional[_Tables]:
    """Host-side score tables over the planes' type axis. None when the
    policy's algebra doesn't factor into (type, ct) base + spot penalty:
    such policies keep the host loop."""
    if not isinstance(policy, (CheapestFeasible, InterruptionPriced,
                               ThroughputPerDollar)):
        return None
    C = max(1, len(planes.ct_vocab))
    Z = max(1, len(planes.zone_vocab))
    t = _Tables()
    t.spot_idx = planes.ct_vocab.get(wellknown.CAPACITY_TYPE_SPOT, -1)
    t.use_pen = (isinstance(policy, InterruptionPriced) and t.spot_idx >= 0
                 and ctx.repack_cost_per_hour > 0.0)
    t.repack_micro = np.float32(ctx.repack_cost_per_hour * 1e6)
    t.price_ct = np.full((planes.TB, C), _INT32_MAX, np.int32)
    t.rate_tz = np.full((planes.TB, Z), np.inf, np.float32) if t.use_pen else None
    return t


def _fill_tables(t: _Tables, planes, uni_types, policy, cost_config, ctx) -> None:
    factor = cost_config.spot_price_factor
    tput = isinstance(policy, ThroughputPerDollar)
    for i, it in enumerate(uni_types):
        div = 1.0
        if tput:
            div = float(ctx.throughput.get(it.name, 1.0))
            if div <= 0.0:
                continue  # zero-throughput types never win: stay INT32_MAX
        for c, ci in planes.ct_vocab.items():
            base = it.price * factor if c == wellknown.CAPACITY_TYPE_SPOT else it.price
            # the scalar scorers' float path: multiply/divide in float64,
            # encode once at the end
            t.price_ct[i, ci] = _encode_micro(base / div)
        if t.rate_tz is not None:
            for o in it.offerings:
                if o.capacity_type != wellknown.CAPACITY_TYPE_SPOT:
                    continue
                z = planes.zone_vocab.get(o.zone)
                if z is not None:
                    t.rate_tz[i, z] = min(t.rate_tz[i, z], np.float32(o.interruption_rate))


def tables_for(planes, uni_types, policy, cost_config, ctx) -> Optional[_Tables]:
    """The score tables of (planes, policy, cost config, ctx), cached; None
    for a policy that does not factor into them."""
    key = (planes.key, policy.name, cost_config, ctx.token())
    with _LOCK:
        hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit if hit is not False else None
    t = _build_tables(planes, policy, cost_config, ctx)
    if t is not None:
        _fill_tables(t, planes, uni_types, policy, cost_config, ctx)
        t.price_ct.flags.writeable = False
        if t.rate_tz is not None:
            t.rate_tz.flags.writeable = False
    with _LOCK:
        if len(_TABLE_CACHE) >= _TABLE_CACHE_CAP:
            _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
        _TABLE_CACHE[key] = t if t is not None else False
    return t


def _offer_tcz(planes) -> np.ndarray:
    """(TB, C, Z) bool unpack of the offer plane's zone words, cached per
    planes identity: the soft-affinity term's per-zone viability view."""
    with _LOCK:
        hit = _TCZ_CACHE.get(planes.key)
    if hit is not None:
        return hit
    Z = max(1, len(planes.zone_vocab))
    z = np.arange(Z)
    tcz = ((planes.offer_plane[:, :, z // 32] >> (z % 32).astype(np.uint32))
           & np.uint32(1)).astype(bool)
    tcz.flags.writeable = False
    with _LOCK:
        if len(_TCZ_CACHE) >= _TABLE_CACHE_CAP:
            _TCZ_CACHE.pop(next(iter(_TCZ_CACHE)))
        _TCZ_CACHE[planes.key] = tcz
    return tcz


def _soft_rows(planes, soft_list, ctx) -> Optional[np.ndarray]:
    """(B, Z) int32 fixed-point soft-affinity rows, or None when no member
    carries a usable zone vote (the program then runs without the term).
    Votes for zones outside the planes vocabulary can never launch here
    and are dropped."""
    if soft_list is None or not soft_enabled():
        return None
    scale = int(round(ctx.soft_affinity_cost_per_weight * 1e6))
    if scale <= 0:
        return None
    Z = max(1, len(planes.zone_vocab))
    rows = np.zeros((len(soft_list), Z), np.int32)
    any_vote = False
    for b, soft in enumerate(soft_list):
        for zone, w in soft_zone_votes(soft).items():
            z = planes.zone_vocab.get(zone)
            if z is None:
                continue
            rows[b, z] = np.int32(max(-_SOFT_CLAMP, min(-w * scale, _SOFT_CLAMP)))
            any_vote = any_vote or rows[b, z] != 0
    return rows if any_vote else None


def _cells_expr(offer_p, price_ct, zone_words, ct_allowed, rate_tz, zone_allowed,
                repack, spot_idx: int, use_pen: bool, soft_bz=None, offer_tcz=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (B, TB, C) cell algebra as torch ops on the device: ``(best (B,
    TB) int32, viable cells (0-d int64))``. Bit planes are int32 patterns
    (``&`` and ``!= 0`` are exact on them); the saturating adds run in
    int64."""
    imax = int(_INT32_MAX)
    zc = ((offer_p[None, :, :, :] & zone_words[:, None, None, :]) != 0).any(-1)
    viable = zc & ct_allowed[:, None, :]
    cells = torch.where(viable, price_ct[None, :, :].to(torch.int64), imax)   # (B, TB, C)
    if use_pen:
        rmask = zone_allowed[:, None, :] & torch.isfinite(rate_tz)[None, :, :]
        minrate = torch.where(rmask, rate_tz[None, :, :], float("inf")).amin(-1)  # (B, TB)
        # the reclaim tax in float32 (a float64 promotion would fork the
        # mirror), rounded half to even as jnp.round and np.round
        penf = torch.where(torch.isfinite(minrate), torch.round(minrate * repack), 0.0)
        pen = penf.clamp(max=2147483648.0).to(torch.int64)
        cells[:, :, spot_idx] = torch.clamp(cells[:, :, spot_idx] + pen, max=imax)
    if soft_bz is not None:
        # preferred-affinity term: per (schedule, type, ct) the BEST case
        # over viable zones; a bonus never revives a cell feasibility
        # rejected or a saturated one
        zmask = offer_tcz[None, :, :, :] & zone_allowed[:, None, None, :]
        adj = torch.where(zmask, soft_bz[:, None, None, :].to(torch.int64), imax).amin(-1)
        adj = torch.where(adj == imax, 0, adj)
        soft_cells = torch.clamp(cells + adj, min=0, max=imax)
        cells = torch.where(cells != imax, soft_cells, cells)
    best = cells.amin(-1).to(torch.int32)
    return best, viable.sum()


def _cells_numpy(offer_p, price_ct, zone_words, ct_allowed, rate_tz, zone_allowed,
                 repack, spot_idx, use_pen, soft_bz=None, offer_tcz=None) -> np.ndarray:
    """The same cells in numpy, with the JAX package's uint32 saturating
    adds: the mirror the device rows are held against."""
    zc = ((offer_p[None, :, :, :] & zone_words[:, None, None, :]) != 0).any(-1)
    viable = zc & ct_allowed[:, None, :]
    cells = np.where(viable, price_ct[None, :, :], _INT32_MAX).astype(np.int32)
    if use_pen:
        rmask = zone_allowed[:, None, :] & np.isfinite(rate_tz)[None, :, :]
        minrate = np.min(np.where(rmask, rate_tz[None, :, :], np.float32(np.inf)), axis=-1)
        penf = np.where(np.isfinite(minrate),
                        np.round(minrate.astype(np.float32) * repack), np.float32(0.0))
        pen_u = np.minimum(penf, np.float32(2147483648.0)).astype(np.uint32)
        spot_u = cells[:, :, spot_idx].astype(np.uint32)
        cells[:, :, spot_idx] = np.minimum(spot_u + pen_u,
                                           np.uint32(_INT32_MAX)).astype(np.int32)
    if soft_bz is not None:
        zmask = offer_tcz[None, :, :, :] & zone_allowed[:, None, None, :]
        adj = np.min(np.where(zmask, soft_bz[:, None, None, :], _INT32_MAX), axis=-1)
        adj = np.where(adj == _INT32_MAX, np.int32(0), adj)
        cell_u = cells.astype(np.uint32) + (adj + np.int32(1 << 30)).astype(np.uint32)
        soft_cells = np.minimum(np.maximum(cell_u, _SOFT_OFF) - _SOFT_OFF,
                                np.uint32(_INT32_MAX)).astype(np.int32)
        cells = np.where(cells != _INT32_MAX, soft_cells, cells)
    return np.min(cells, axis=-1).astype(np.int32)


def _rows_host(planes, verify) -> tuple:
    """Per-schedule allowed zone words and boolean capacity-type / zone
    rows for the scoring program (host numpy; B and vocab sizes are
    small)."""
    B = len(verify)
    C = max(1, len(planes.ct_vocab))
    Z = max(1, len(planes.zone_vocab))
    Wz = planes.offer_plane.shape[2]
    zone_words = np.zeros((B, Wz), np.uint32)
    ct_allowed = np.zeros((B, C), bool)
    zone_allowed = np.zeros((B, Z), bool)
    for b, (allowed, required) in enumerate(verify):
        _, _, _, zr, ct_bits, _ = schedule_row(planes, allowed, required)
        zone_words[b] = zr
        ct_allowed[b] = [(int(ct_bits) >> c) & 1 for c in range(C)]
        zone_allowed[b] = [(int(zr[z // 32]) >> (z % 32)) & 1 for z in range(Z)]
    return zone_words, ct_allowed, zone_allowed


def _host_best(t: _Tables, planes, zone_words, ct_allowed, zone_allowed,
               cols: Optional[np.ndarray] = None,
               soft_bz: Optional[np.ndarray] = None) -> np.ndarray:
    """The numpy mirror of the program (optionally restricted to the probe
    type columns): the oracle leg of the filter contract."""
    offer_p = planes.offer_plane
    price_ct = t.price_ct
    rate_tz = t.rate_tz
    offer_tcz = _offer_tcz(planes) if soft_bz is not None else None
    if cols is not None:
        offer_p = offer_p[cols]
        price_ct = price_ct[cols]
        rate_tz = rate_tz[cols] if rate_tz is not None else None
        offer_tcz = offer_tcz[cols] if offer_tcz is not None else None
    if rate_tz is None:
        rate_tz = np.zeros((price_ct.shape[0], zone_allowed.shape[1]), np.float32)
    return _cells_numpy(offer_p, price_ct, zone_words, ct_allowed, rate_tz.copy(),
                        zone_allowed, t.repack_micro, t.spot_idx, t.use_pen,
                        soft_bz=soft_bz, offer_tcz=offer_tcz)


def device_inputs(planes, tables: _Tables, zone_words, ct_allowed, zone_allowed,
                  soft_bz: Optional[np.ndarray], dev: torch.device) -> dict:
    """The program's operands on ``dev`` as :func:`_cells_expr` keywords:
    the integer tables and rows in one host→device copy, the rates and the
    repack price in another, the offer plane resident per catalog."""
    rate_tz = tables.rate_tz if tables.rate_tz is not None else \
        np.zeros((planes.TB, zone_allowed.shape[1]), np.float32)
    ints = [tables.price_ct, zone_words, ct_allowed, zone_allowed]
    if soft_bz is not None:
        ints += [soft_bz, _offer_tcz(planes)]
    ints_d = to_device_int32(ints, dev)
    rate_d, repack_d = to_device_float32([rate_tz, np.asarray(tables.repack_micro)], dev)
    return {"offer_p": resident_planes(planes, dev)[3], "price_ct": ints_d[0],
            "zone_words": ints_d[1], "ct_allowed": ints_d[2] != 0, "rate_tz": rate_d,
            "zone_allowed": ints_d[3] != 0, "repack": repack_d, "spot_idx": tables.spot_idx,
            "use_pen": tables.use_pen,
            "soft_bz": ints_d[4] if soft_bz is not None else None,
            "offer_tcz": ints_d[5] != 0 if soft_bz is not None else None}


def score_fused_window(fused, policy, cost_config, ctx
                       ) -> Optional[Tuple[List[np.ndarray], int]]:
    """Score every member of a fused batch in one program on the first
    device of the window's mesh, probe-verified per member. Returns
    ``(rows, viable cells)``: one pre-encoded (TB,) int32 micro-$ row per
    member (aligned with ``fused.batch_idx``, gathered to the member's
    packable order), or None when the policy does not factor into tables
    (the caller runs the per-cell host loop). The rows come back to the
    host for their verification; the batched run copies each to its
    shard's device with the shard's other rows (models/ffd.DeviceRun)."""
    global RUNS, MISMATCHES
    planes = planes_for(fused.uni_types)
    if planes is None:
        return None
    tables = tables_for(planes, fused.uni_types, policy, cost_config, ctx)
    if tables is None:
        POLICY_FALLBACK_TOTAL.inc(reason="unfactorable-policy")
        return None
    t0 = time.perf_counter()
    zone_words, ct_allowed, zone_allowed = _rows_host(planes, fused.verify)
    soft_bz = _soft_rows(planes, fused.soft, ctx)
    inputs = device_inputs(planes, tables, zone_words, ct_allowed, zone_allowed, soft_bz,
                           fused.device)
    best_d, ncells_d = _cells_expr(**inputs)
    best = best_d.cpu().numpy()
    ncells = int(ncells_d)
    POLICY_CELLS_SCORED_TOTAL.inc(amount=float(ncells))
    with _LOCK:
        RUNS += 1
    POLICY_SCORE_SECONDS.observe(time.perf_counter() - t0, stage="device")

    # probe verification: the window's sampled type columns, device vs the
    # numpy mirror; a diverging member's row is re-derived on the host
    t1 = time.perf_counter()
    cols = np.unique(fused.probe_idx[fused.probe_idx < planes.n])
    ref = _host_best(tables, planes, zone_words, ct_allowed, zone_allowed,
                     cols=cols, soft_bz=soft_bz)
    got = best[:, cols]
    for b in range(len(fused.verify)):
        if not np.array_equal(got[b], ref[b]):
            soft_member = soft_bz is not None and bool(soft_bz[b].any())
            POLICY_FALLBACK_TOTAL.inc(
                reason="soft-affinity-mismatch" if soft_member else "score-mismatch")
            with _LOCK:
                MISMATCHES += 1
            best[b] = _host_best(
                tables, planes, zone_words[b:b + 1], ct_allowed[b:b + 1],
                zone_allowed[b:b + 1],
                soft_bz=soft_bz[b:b + 1] if soft_bz is not None else None)[0]
    POLICY_SCORE_SECONDS.observe(time.perf_counter() - t1, stage="verify")

    # gather the planes axis to each member's packable order, padded to TB
    idx = np.fromiter((p.index for p in fused.packables), np.int64, len(fused.packables))
    out: List[np.ndarray] = []
    for b in range(len(fused.batch_idx)):
        row = np.full((planes.TB,), _INT32_MAX, np.int32)
        row[:len(idx)] = best[b, idx]
        out.append(row)
    return out, ncells


def steer_zone(instance_types, requirements, cost_config, ctx, soft) -> Optional[str]:
    """Launch-time zone steering, the scalar half of the soft contract: the
    scoring program priced the best-case zone into the row; this picks that
    zone so the fleet launch actually lands there. Exact int micro-$ over
    every allowed offering of the packed node's type options:
    ``base_micro(offering) + clamp(-weight x scale)`` (the fixed point of
    the device term), argmin with (higher vote, zone name) as the
    deterministic tiebreak: the floor at 0 can erase the vote discount on
    cheap offerings, and a tie must still land on the preferred zone.
    Returns None (launch unchanged) when there are no usable votes, the
    kill switch is off, the zone is already pinned, or no offering is
    viable; a zone it returns always keeps an offering viable."""
    votes = soft_zone_votes(soft)
    if not votes or not soft_enabled():
        return None
    scale = int(round(ctx.soft_affinity_cost_per_weight * 1e6))
    if scale <= 0:
        return None
    zones = requirements.zones()
    if zones is not None and len(zones) <= 1:
        return None  # already pinned: nothing to steer
    cts = requirements.capacity_types()
    factor = cost_config.spot_price_factor
    best: Optional[tuple] = None
    for it in instance_types:
        for o in it.offerings:
            if zones is not None and o.zone not in zones:
                continue
            if cts is not None and o.capacity_type not in cts:
                continue
            base = it.price * factor if o.capacity_type == wellknown.CAPACITY_TYPE_SPOT \
                else it.price
            adj = max(-_SOFT_CLAMP, min(-votes.get(o.zone, 0) * scale, _SOFT_CLAMP))
            total = max(0, min(int(_encode_micro(base)) + adj, int(_INT32_MAX)))
            cand = (total, -votes.get(o.zone, 0), o.zone)
            if best is None or cand < best:
                best = cand
    if best is None:
        return None
    # no vote touches a viable zone: every total is the plain price, so
    # don't narrow (the unsteered lowest-price launch is already optimal)
    if all(votes.get(z, 0) == 0 for z in
           {o.zone for it in instance_types for o in it.offerings
            if (zones is None or o.zone in zones)
            and (cts is None or o.capacity_type in cts)}):
        return None
    return best[2]


def clear_caches() -> None:
    """Tests only."""
    with _LOCK:
        _TABLE_CACHE.clear()
        _TCZ_CACHE.clear()
