"""Columnar constraint filter: the interned-bitset twin of the scalar
requirement algebra (api/requirements.py, api/constraints.py), with the
gang feasibility column and the pod-pod affinity match matrix.

A port of the JAX package's ``ops/feasibility.py``. Label values are
interned into dense bit positions per key, each key's ``(∩ In) ∖ (∪ NotIn)``
set becomes a packed bitmask (a Python int, one bit per interned value), and
the per-pod hot loops evaluate as mask algebra:

- pod × provisioner validation (:func:`validate_pod_fast`,
  :meth:`CompiledConstraints.validate`): Scheduler._get_schedules and
  SelectionController._select_provisioner;
- constraint tightening (:meth:`CompiledConstraints.schedule_entry`):
  ``tighten()`` runs once per pod signature instead of once per pod, and
  the group key is exactly the scheduler's ``_constraints_key`` of the
  tightened result;
- the topology spread's allowed domains (:func:`topology_allowed`), once
  per pod signature;
- pod-set × instance-type feasibility (:func:`catalog_feasibility_mask`):
  the whole catalog validated as numpy boolean columns on the host,
  memoized by catalog identity, allowed sets and required resources.

Every quirk of the scalar algebra is kept: NotIn without In collapses to
the empty set (``has_notin``), alias keys are normalized on the pod side
and matched literally on the constraint side, Exists/DoesNotExist assert
presence only, Gt/Lt send the pod to the scalar path, and Go's
``sets.Has(nil)`` is false. When the engine says "fail" it re-runs the
scalar validator for the exact error string; if the scalar path passes,
the scalar answer wins. Every such self-heal and every fallback is counted
in the JAX package's ``karpenter_filter_fallback_total`` series, and in
:data:`HEALS`, under its reasons: ``verdict-mismatch``,
``unsupported-operator``, ``compile-error``, ``intern-reset``,
``os-vocab-overflow``, ``topology-mismatch``, ``gang-mismatch``,
``gang-unindexable`` and ``affinity-mismatch``. The engine's words stay
numpy ``uint64`` and Python ints on the host, as in the JAX package.

A gang's allowed-type column (:func:`gang_feasibility_mask`) is the AND of
its members' per-type feasibility, computed on the device from the catalog
bit-planes (``ops/device_filter.gang_member_column``, the JAX package's
``_rows_jit``); where the device leg declines it is the AND of the members'
host catalog masks, and where the catalog cannot be indexed the scalar
per-member oracle (``gang-unindexable``). An all-False column is re-derived
from the oracle and the oracle wins when it finds a type
(``gang-mismatch``). Columns are cached per gang signature.

Required pod-(anti-)affinity compiles to a selectors × peers boolean match
matrix computed by the device program (``ops.device_filter.
affinity_matrix``, B5). Sampled cells are re-checked against the scalar
``LabelSelector.matches`` oracle, and any divergence recomputes the whole
matrix scalar (``affinity-mismatch``). A selector with an operator outside
{In, NotIn, Exists, DoesNotExist} sends the whole matrix to the scalar
oracle (``unsupported-operator``).

Each catalog mask, gang column and affinity matrix built is timed in
``karpenter_filter_batch_seconds`` (``stage`` catalog, gang, affinity),
and the live intern table size is ``karpenter_filter_intern_table_size``.
:data:`HEALS` keeps the fallback counts as an attribute (held equal to
the series by the tests). Left out: the kill switches
``KARPENTER_POLICY_COLUMNAR`` and ``KARPENTER_TOPOLOGY_COLUMNAR``. A
device error raises.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.constraints import Constraints
from karpenter_tpu_torch.api.core import Pod
from karpenter_tpu_torch.api.gang import instance_slice_shape, slice_fits
from karpenter_tpu_torch.api.requirements import IN, NOT_IN
from karpenter_tpu_torch.backend import DeviceLike
from karpenter_tpu_torch.metrics.filter import (
    FILTER_BATCH_SECONDS, FILTER_FALLBACK_TOTAL, FILTER_INTERN_TABLE_SIZE,
)
from karpenter_tpu_torch.utils import resources as res

log = logging.getLogger("karpenter.feasibility")

_AFFINITY_OPS = frozenset({"In", "NotIn", "Exists", "DoesNotExist"})
_AFFINITY_PROBE_K = 32
_PRESENCE_OPS = ("Exists", "DoesNotExist")

_LOCK = threading.Lock()
# self-heals and fallbacks since the last reset, by reason (see above)
HEALS: Dict[str, int] = {}


def _count(reason: str) -> None:
    FILTER_FALLBACK_TOTAL.inc(reason=reason)
    with _LOCK:
        HEALS[reason] = HEALS.get(reason, 0) + 1


def heal_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(HEALS)


def reset_heals() -> None:
    with _LOCK:
        HEALS.clear()


# -- global value intern table ----------------------------------------------
#
# {key: {value: single-bit mask}}. Bit positions are dense per key and
# append-only within a dict's lifetime. On overflow the TOP-LEVEL dict is
# rebound (never cleared): compiled constraints keep references to the
# per-key dicts they interned against, so their masks stay valid across
# generations; only sharing with future compiles is lost.


def _intern_max_from_env() -> int:
    raw = os.environ.get("KARPENTER_FEASIBILITY_INTERN_MAX", "")
    if not raw.strip():
        return 1 << 16
    try:
        return max(1, int(raw.strip()))
    except ValueError:
        log.warning("KARPENTER_FEASIBILITY_INTERN_MAX=%r is not an integer; "
                    "using default %d", raw, 1 << 16)
        return 1 << 16


_INTERN_MAX = _intern_max_from_env()
_INTERN_LOCK = threading.Lock()
_VOCAB: Dict[str, Dict[str, int]] = {}
_VOCAB_SIZE = 0
_VOCAB_GEN = 0


def _intern_value(vocab: Dict[str, int], value: str) -> int:
    """Single-bit mask for ``value`` in this key's vocab; the caller holds
    _INTERN_LOCK. A dict handed out before a generation reset keeps growing
    privately: correct, just unshared."""
    global _VOCAB, _VOCAB_SIZE, _VOCAB_GEN
    m = vocab.get(value)
    if m is None:
        if _VOCAB_SIZE >= _INTERN_MAX:
            _VOCAB = {}
            _VOCAB_SIZE = 0
            _VOCAB_GEN += 1
            _count("intern-reset")
        m = 1 << len(vocab)
        vocab[value] = m
        _VOCAB_SIZE += 1
    return m


def intern_table_stats() -> Tuple[int, int]:
    """(live size, generation)."""
    with _INTERN_LOCK:
        return _VOCAB_SIZE, _VOCAB_GEN


def reset_intern_table() -> None:
    """Force a generation reset."""
    global _VOCAB, _VOCAB_SIZE, _VOCAB_GEN
    with _INTERN_LOCK:
        _VOCAB = {}
        _VOCAB_SIZE = 0
        _VOCAB_GEN += 1
    FILTER_INTERN_TABLE_SIZE.set(0)


# -- compiled constraints ----------------------------------------------------


class _KeyFilter:
    """One key's constraint-side state: vocab ref + In/NotIn masks + the
    precomputed own-requirement result (None=unconstrained, int=mask)."""

    __slots__ = ("vocab", "in_mask", "notin_mask", "has_notin", "own")

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.in_mask: Optional[int] = None
        self.notin_mask = 0
        self.has_notin = False
        self.own: Optional[int] = None


_MISSING = object()
_CACHE_CAP = 16384


class CompiledConstraints:
    """Bitset form of one Constraints object. Attached to the object's
    ``__dict__`` and shared, never copied: ``__deepcopy__`` returns self,
    and the identity fingerprint mismatches on the copy, forcing a fresh
    compile there."""

    __slots__ = ("fingerprint", "cref", "filters", "taints",
                 "_val_cache", "_sched_cache")

    def __init__(self, fingerprint, cref: Constraints,
                 filters: Dict[str, _KeyFilter], taints: tuple):
        self.fingerprint = fingerprint
        self.cref = cref
        self.filters = filters
        self.taints = taints
        self._val_cache: dict = {}
        self._sched_cache: dict = {}

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self

    # -- raw bitset verdict (the fuzz-tested core) --------------------------
    def _raw_ok(self, sig) -> bool:
        """True iff the pod signature passes: the mask-algebra mirror of
        Constraints.validate_pod's stages. Boolean only; error strings
        always come from the scalar path."""
        rows, tols, _gpus = sig
        for taint in self.taints:
            tolerated = False
            for tk, top, tv, te in tols:
                if te and te != taint.effect:
                    continue
                if tk and tk != taint.key:
                    continue
                if top == "Exists":
                    if tv == "":
                        tolerated = True
                        break
                elif top == "" or top == "Equal":
                    if tv == taint.value:
                        tolerated = True
                        break
            if not tolerated:
                return False
        if not rows:
            return True
        filters = self.filters
        order: List[str] = []
        grouped: Dict[str, list] = {}
        for key, op, vals in rows:
            g = grouped.get(key)
            if g is None:
                g = grouped[key] = []
                order.append(key)
            g.append((op, vals))
        for key in order:
            kf = filters.get(key)
            if kf is None or not kf.own:
                # own requirement None (unconstrained) or empty: the first
                # loop of validate_pod rejects either way
                return False
            r = kf.in_mask
            notin = kf.notin_mask
            has_notin = kf.has_notin
            vocab = kf.vocab
            for op, vals in grouped[key]:
                if op == IN:
                    m = 0
                    for v in vals:
                        b = vocab.get(v)
                        if b is not None:
                            # a value the constraint never interned cannot
                            # be in any constraint set: dropping it from the
                            # In mask is exact
                            m |= b
                    r = m if r is None else (r & m)
                elif op == NOT_IN:
                    for v in vals:
                        b = vocab.get(v)
                        if b is not None:  # subtracting unknown is a no-op
                            notin |= b
                    has_notin = True
                # Exists/DoesNotExist assert key presence only:
                # requirement() never reads them (requirements.go:176-195)
            if has_notin:
                r = (r if r is not None else 0) & ~notin
            if not r:
                return False
        return True

    # -- validation with exact scalar error strings -------------------------
    def validate(self, pod: Pod) -> Optional[str]:
        """Drop-in for ``constraints.validate_pod(pod)``: same verdict, same
        error strings, memoized per pod signature."""
        sig = pod_signature(pod)
        if sig is None:
            return self.cref.validate_pod(pod)
        hit = self._val_cache.get(sig, _MISSING)
        if hit is not _MISSING:
            return hit
        if self._raw_ok(sig):
            out = None
        else:
            out = self.cref.validate_pod(pod)
            if out is None:
                _count("verdict-mismatch")
        if len(self._val_cache) >= _CACHE_CAP:
            self._val_cache.clear()
        self._val_cache[sig] = out
        return out

    # -- scheduler entry: validate + memoized tighten + group key -----------
    def schedule_entry(self, pod: Pod):
        """(err, tightened, group_key) for one pod. ``tighten()`` runs once
        per signature; the key equals
        ``_constraints_key(cref.tighten(pod), res.gpu_limits_for(pod))``
        because the GPU-request axis is part of the signature and the rest
        is a pure function of it."""
        sig = pod_signature(pod)
        if sig is None:
            c = self.cref
            err = c.validate_pod(pod)
            if err is not None:
                return err, None, None
            tightened = c.tighten(pod)
            gpus = tuple(sorted(
                (k, q.nano) for k, q in res.gpu_limits_for(pod).items()))
            return None, tightened, constraints_key_parts(tightened) + (gpus,)
        hit = self._sched_cache.get(sig)
        if hit is None:
            if self._raw_ok(sig):
                err = None
            else:
                err = self.cref.validate_pod(pod)
                if err is None:
                    _count("verdict-mismatch")
            if err is not None:
                hit = (err, None, None)
            else:
                tightened = self.cref.tighten(pod)
                hit = (None, tightened, constraints_key_parts(tightened))
            if len(self._sched_cache) >= _CACHE_CAP:
                self._sched_cache.clear()
            self._sched_cache[sig] = hit
        err, tightened, parts = hit
        if err is not None:
            return err, None, None
        return None, tightened, parts + (sig[2],)


class _CompileFailed:
    """Negative-cache marker so a constraints object that failed to compile
    is not re-attempted per pod."""

    __slots__ = ("fingerprint",)

    def __deepcopy__(self, memo):
        return self


def _fingerprint(c: Constraints) -> tuple:
    # identity + length: every in-repo mutation of a live constraints object
    # (topology.inject appending hostname rows) changes a length; wholesale
    # replacement changes an id. Copies always get fresh ids, so a shared
    # CompiledConstraints can never serve a copy stale.
    return (id(c.requirements), len(c.requirements.items),
            id(c.taints), len(c.taints))


def compile_constraints(c: Constraints) -> Optional[CompiledConstraints]:
    """Compile (or fetch the cached compile of) a Constraints object.
    None means the scalar path must be used for every decision."""
    fp = _fingerprint(c)
    cached = c.__dict__.get("_feas_compiled")
    if cached is not None and cached.fingerprint == fp:
        return cached if type(cached) is CompiledConstraints else None
    try:
        cc = _compile(c, fp)
    except Exception:
        log.warning("feasibility compile failed; using scalar path", exc_info=True)
        _count("compile-error")
        failed = _CompileFailed()
        failed.fingerprint = fp
        c.__dict__["_feas_compiled"] = failed
        return None
    c.__dict__["_feas_compiled"] = cc
    return cc


def _compile(c: Constraints, fp: tuple) -> CompiledConstraints:
    filters: Dict[str, _KeyFilter] = {}
    with _INTERN_LOCK:
        for r in c.requirements.items:
            op = r.operator
            if op != IN and op != NOT_IN:
                # requirement() ignores these rows entirely
                continue
            kf = filters.get(r.key)
            if kf is None:
                vocab = _VOCAB.get(r.key)
                if vocab is None:
                    vocab = _VOCAB[r.key] = {}
                kf = filters[r.key] = _KeyFilter(vocab)
            m = 0
            for v in r.values:
                m |= _intern_value(kf.vocab, v)
            if op == IN:
                kf.in_mask = m if kf.in_mask is None else (kf.in_mask & m)
            else:
                kf.notin_mask |= m
                kf.has_notin = True
        size = _VOCAB_SIZE
    FILTER_INTERN_TABLE_SIZE.set(size)
    for kf in filters.values():
        own = kf.in_mask
        if kf.has_notin:
            own = (own if own is not None else 0) & ~kf.notin_mask
        kf.own = own
    return CompiledConstraints(fp, c, filters, tuple(c.taints))


# -- pod signatures ----------------------------------------------------------


def pod_signature(pod: Pod):
    """(filter rows, tolerations, gpu requests): the pod's entire input to
    validation and grouping, as a hashable value. Rows mirror
    pod_requirements' extraction exactly: nodeSelector (normalized, In),
    then the heaviest preferred term, then required[0]. None means an
    operator outside {In, NotIn, Exists, DoesNotExist} appeared (scalar
    fallback). Never cached on the Pod: topology injection and preference
    relaxation mutate pod specs between calls."""
    normalized = wellknown.NORMALIZED_LABELS
    rows = []
    for key, value in pod.spec.node_selector.items():
        rows.append((normalized.get(key, key), IN, (value,)))
    affinity = pod.spec.affinity
    if affinity is not None and affinity.node_affinity is not None:
        na = affinity.node_affinity
        exprs = []
        if na.preferred:
            heaviest = max(na.preferred, key=lambda t: t.weight)
            exprs.extend(heaviest.preference.match_expressions)
        if na.required:
            exprs.extend(na.required[0].match_expressions)
        for r in exprs:
            op = r.operator
            if op != IN and op != NOT_IN and op not in _PRESENCE_OPS:
                _count("unsupported-operator")
                return None
            rows.append((normalized.get(r.key, r.key), op, tuple(r.values)))
    tols = tuple((t.key, t.operator, t.value, t.effect)
                 for t in pod.spec.tolerations)
    gpus = tuple(sorted(
        (k, q.nano) for k, q in res.gpu_limits_for(pod).items()))
    return (tuple(rows), tols, gpus)


def constraints_key_parts(c: Constraints) -> tuple:
    """The (requirements, taints, labels) parts of the schedule group key,
    scheduler.go:100-110 SlicesAsSets semantics (order-insensitive). The
    scheduler's ``_constraints_key`` is these parts + the GPU-request axis."""
    reqs = tuple(sorted(
        (r.key, r.operator, tuple(sorted(r.values)))
        for r in c.requirements.items))
    taints = tuple(sorted((t.key, t.value, t.effect) for t in c.taints))
    labels = tuple(sorted(c.labels.items()))
    return (reqs, taints, labels)


def topology_allowed(cc: CompiledConstraints, sig, key: str):
    """Columnar twin of the topology spread's allowed-domain query
    (scheduling/topology.py)::

        constraints.requirements.add(*pod_requirements(pod).items)
                   .requirement(key)

    for any pod whose ``pod_signature`` is ``sig``. Returns the same
    ``Optional[frozenset]``: None = unconstrained, a set = allowed domains.
    ``requirement()`` evaluates all In rows first, then all NotIn rows, so
    the constraint rows (``cc.filters``) and the pod rows compose as set
    algebra:

    - the constraint has an In row for the key: the result is a subset of
      its fully interned In set, so the algebra runs in mask space and the
      surviving bits decode back to strings through the key's vocab (under
      the intern lock: the dict may be growing concurrently);
    - it has only NotIn rows, or none: pod In values the constraint never
      interned are legitimate members, so the pod side runs in string
      space and the constraint's NotIn mask is decoded before subtraction.
      The Go quirk carries over: any NotIn row with no In row anywhere
      collapses to the empty set, never to "unconstrained"
      (requirements.go:189-194)."""
    rows, _tols, _gpus = sig
    pod_in: List[tuple] = []
    pod_notin: List[tuple] = []
    for k, op, vals in rows:
        if k != key:
            continue
        if op == IN:
            pod_in.append(vals)
        elif op == NOT_IN:
            pod_notin.append(vals)
        # presence ops assert key existence only; requirement() skips them
    kf = cc.filters.get(key)
    if kf is not None and kf.in_mask is not None:
        r = kf.in_mask
        notin = kf.notin_mask
        vocab = kf.vocab
        for vals in pod_in:
            m = 0
            for v in vals:
                b = vocab.get(v)
                if b is not None:
                    m |= b
            r &= m
        for vals in pod_notin:
            for v in vals:
                b = vocab.get(v)
                if b is not None:
                    notin |= b
        r &= ~notin
        with _INTERN_LOCK:
            return frozenset(v for v, b in vocab.items() if r & b)
    # string space: the constraint contributes at most a NotIn mask
    result: Optional[set] = None
    for vals in pod_in:
        s = set(vals)
        result = s if result is None else (result & s)
    if kf is not None and kf.has_notin:
        with _INTERN_LOCK:
            notin_vals = {v for v, b in kf.vocab.items() if kf.notin_mask & b}
        result = (result or set()) - notin_vals
    for vals in pod_notin:
        result = (result or set()) - set(vals)
    return frozenset(result) if result is not None else None


def validate_pod_fast(constraints: Constraints, pod: Pod) -> Optional[str]:
    """Engine-accelerated ``constraints.validate_pod(pod)``: identical
    verdicts and error strings, scalar on any fallback condition."""
    cc = compile_constraints(constraints)
    if cc is None:
        return constraints.validate_pod(pod)
    return cc.validate(pod)


# -- whole-catalog feasibility mask ------------------------------------------
#
# The type axis is the batch here: columns over instance types, one boolean
# lookup per allowed set, combined with an elementwise AND on the host.
# Memoized by catalog identity (a monotonic token per InstanceType object)
# + allowed sets + required resources.

_token_counter = itertools.count(1)
_INDEX_CACHE: dict = {}
_INDEX_CACHE_CAP = 8
_INDEX_FAILED = object()
_MASK_CACHE: dict = {}
_MASK_CACHE_CAP = 128

_GPU_CLASSES = (res.NVIDIA_GPU, res.AMD_GPU, res.AWS_NEURON)


def _catalog_token(it) -> int:
    """A monotonic token on the InstanceType object: the catalog identity
    the mask, plane and gang caches are keyed by."""
    tok = it.__dict__.get("_feas_token")
    if tok is None:
        tok = it.__dict__["_feas_token"] = next(_token_counter)
    return tok


class CatalogIndex:
    """Columnar view of one instance-type catalog."""

    __slots__ = ("n", "name_vocab", "name_col", "arch_vocab", "arch_col",
                 "os_vocab", "os_mask", "ct_vocab", "zone_vocab",
                 "offer_type", "offer_ct", "offer_zone", "eni_zero",
                 "gpu_zero")


def _build_catalog_index(instance_types) -> Optional[CatalogIndex]:
    n = len(instance_types)
    idx = CatalogIndex()
    idx.n = n
    idx.name_vocab = {}
    idx.arch_vocab = {}
    idx.os_vocab = {}
    idx.ct_vocab = {}
    idx.zone_vocab = {}
    idx.name_col = np.zeros(n, np.int32)
    idx.arch_col = np.zeros(n, np.int32)
    idx.os_mask = np.zeros(n, np.uint64)
    idx.eni_zero = np.zeros(n, bool)
    idx.gpu_zero = {name: np.zeros(n, bool) for name in _GPU_CLASSES}
    ot: List[int] = []
    oc: List[int] = []
    oz: List[int] = []
    for t, it in enumerate(instance_types):
        idx.name_col[t] = idx.name_vocab.setdefault(it.name, len(idx.name_vocab))
        idx.arch_col[t] = idx.arch_vocab.setdefault(it.architecture, len(idx.arch_vocab))
        m = 0
        for os_name in it.operating_systems:
            b = idx.os_vocab.setdefault(os_name, len(idx.os_vocab))
            if b >= 64:
                # one uint64 word per type keeps the column dense; a
                # catalog with more than 64 distinct OS values goes scalar
                return None
            m |= 1 << b
        idx.os_mask[t] = m
        for o in it.offerings:
            ot.append(t)
            oc.append(idx.ct_vocab.setdefault(o.capacity_type, len(idx.ct_vocab)))
            oz.append(idx.zone_vocab.setdefault(o.zone, len(idx.zone_vocab)))
        idx.eni_zero[t] = it.aws_pod_eni.is_zero()
        idx.gpu_zero[res.NVIDIA_GPU][t] = it.nvidia_gpus.is_zero()
        idx.gpu_zero[res.AMD_GPU][t] = it.amd_gpus.is_zero()
        idx.gpu_zero[res.AWS_NEURON][t] = it.aws_neurons.is_zero()
    idx.offer_type = np.array(ot, np.int64)
    idx.offer_ct = np.array(oc, np.int64)
    idx.offer_zone = np.array(oz, np.int64)
    return idx


def _vocab_ok(vocab: Dict[str, int], allowed) -> np.ndarray:
    """Boolean lookup table over a local vocab. ``allowed`` None rejects
    everything: Go's sets.Has(nil) is false (adapter._validate's note)."""
    ok = np.zeros(len(vocab), bool)
    if allowed:
        for v, i in vocab.items():
            if v in allowed:
                ok[i] = True
    return ok


def _combine_columns(cols, n: int) -> np.ndarray:
    acc = np.ones(n, bool)
    for c in cols:
        acc &= c
    return acc


def _compute_mask(idx: CatalogIndex, allowed: tuple,
                  required: frozenset) -> np.ndarray:
    cts, zones, its, archs, oss = allowed
    n = idx.n
    ct_ok = _vocab_ok(idx.ct_vocab, cts)
    zone_ok = _vocab_ok(idx.zone_vocab, zones)
    row_ok = ct_ok[idx.offer_ct] & zone_ok[idx.offer_zone]
    offer_ok = np.bincount(idx.offer_type[row_ok], minlength=n).astype(bool)[:n]
    name_ok = _vocab_ok(idx.name_vocab, its)[idx.name_col]
    arch_ok = _vocab_ok(idx.arch_vocab, archs)[idx.arch_col]
    os_bits = 0
    if oss:
        for v, b in idx.os_vocab.items():
            if v in oss:
                os_bits |= 1 << b
    os_ok = (idx.os_mask & np.uint64(os_bits)) != 0
    cols = [offer_ok, name_ok, arch_ok, os_ok]
    if res.AWS_POD_ENI in required:
        cols.append(~idx.eni_zero)
    for name in _GPU_CLASSES:
        zero = idx.gpu_zero[name]
        # GPU classes are exclusive both ways (packable.go:205-219)
        cols.append(~zero if name in required else zero)
    mask = _combine_columns(cols, n)
    mask.flags.writeable = False
    return mask


def catalog_feasibility_mask(instance_types, allowed: tuple,
                             required: frozenset) -> Optional[np.ndarray]:
    """Per-type viability (True = ``adapter._validate`` would return None)
    for the whole catalog, or None when the catalog cannot be indexed. The
    result array is shared and read-only."""
    tokens = tuple(_catalog_token(it) for it in instance_types)
    mkey = (tokens, allowed, required)
    with _LOCK:
        hit = _MASK_CACHE.get(mkey)
        if hit is not None:
            return hit
        idx = _INDEX_CACHE.get(tokens)
    if idx is _INDEX_FAILED:
        return None
    t0 = time.perf_counter()
    if idx is None:
        idx = _build_catalog_index(instance_types)
        with _LOCK:
            if len(_INDEX_CACHE) >= _INDEX_CACHE_CAP:
                _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
            _INDEX_CACHE[tokens] = idx if idx is not None else _INDEX_FAILED
        if idx is None:
            _count("os-vocab-overflow")
            return None
    mask = _compute_mask(idx, allowed, required)
    FILTER_BATCH_SECONDS.observe(time.perf_counter() - t0, stage="catalog")
    with _LOCK:
        if len(_MASK_CACHE) >= _MASK_CACHE_CAP:
            _MASK_CACHE.pop(next(iter(_MASK_CACHE)))
        _MASK_CACHE[mkey] = mask
    return mask


def clear_catalog_caches() -> None:
    """Forget every catalog index and mask, and the gang and slice columns."""
    with _LOCK:
        _INDEX_CACHE.clear()
        _MASK_CACHE.clear()
    clear_gang_cache()


# -- group-level (gang) columns ----------------------------------------------

_GANG_MASK_CACHE: dict = {}
_GANG_MASK_CACHE_CAP = 128
_SLICE_COL_CACHE: dict = {}
_SLICE_COL_CACHE_CAP = 64


def _slice_column(instance_types, tokens: tuple, shape) -> np.ndarray:
    """Per-type slice compatibility column, cached per (catalog, shape)."""
    skey = (tokens, str(shape))
    with _LOCK:
        col = _SLICE_COL_CACHE.get(skey)
    if col is not None:
        return col
    col = np.fromiter(
        (slice_fits(instance_slice_shape(it), shape) for it in instance_types),
        dtype=bool, count=len(instance_types))
    col.flags.writeable = False
    with _LOCK:
        if len(_SLICE_COL_CACHE) >= _SLICE_COL_CACHE_CAP:
            _SLICE_COL_CACHE.pop(next(iter(_SLICE_COL_CACHE)))
        _SLICE_COL_CACHE[skey] = col
    return col


def gang_scalar_mask(instance_types, member_keys, slice_shape) -> np.ndarray:
    """The scalar per-member oracle: type t is gang-viable iff
    ``adapter._validate`` accepts it for EVERY member (allowed, required)
    key and its advertised topology contains the requested slice."""
    from karpenter_tpu_torch.solver.adapter import _validate

    out = np.zeros(len(instance_types), bool)
    for t, it in enumerate(instance_types):
        if any(_validate(it, allowed, required) is not None
               for allowed, required in member_keys):
            continue
        if slice_shape is not None and not slice_fits(instance_slice_shape(it), slice_shape):
            continue
        out[t] = True
    return out


def gang_feasibility_mask(instance_types, member_keys, slice_shape=None,
                          device: DeviceLike = None) -> np.ndarray:
    """Group-level feasibility column for one gang: True = every member's
    scalar validators accept the type AND the type can carve the requested
    slice (when one is declared). ``member_keys`` is a sequence of
    (allowed, required) pairs, one per member (duplicates collapse). The
    member column runs on ``device`` (default: the CUDA device; ``"cpu"``
    runs the same torch ops on the CPU); where the device leg declines
    (``KARPENTER_DEVICE_FILTER=0``, a catalog the planes cannot hold) it is
    the AND of the members' host catalog masks, and where the catalog
    cannot be indexed the scalar oracle's. Never None; shared and
    read-only."""
    from karpenter_tpu_torch.ops import device_filter

    tokens = tuple(_catalog_token(it) for it in instance_types)
    distinct = tuple(sorted(set(member_keys)))
    gkey = (tokens, distinct, str(slice_shape) if slice_shape else "")
    with _LOCK:
        hit = _GANG_MASK_CACHE.get(gkey)
    if hit is not None:
        return hit
    t0 = time.perf_counter()
    mask: Optional[np.ndarray] = None
    if distinct:
        # the member-AND column from the catalog bit-planes in one device
        # program; None when the kill switch is set or the planes refuse
        mask = device_filter.gang_member_column(instance_types, distinct, device)
    if mask is None:
        mask = np.ones(len(instance_types), bool)
        for allowed, required in distinct:
            col = catalog_feasibility_mask(instance_types, allowed, required)
            if col is None:
                mask = None  # catalog not indexable: the scalar oracle
                break
            mask = mask & col
    if mask is not None and slice_shape is not None:
        mask = mask & _slice_column(instance_types, tokens, slice_shape)
    if mask is None:
        mask = gang_scalar_mask(instance_types, distinct, slice_shape)
        _count("gang-unindexable")
    elif distinct and not mask.any():
        # an all-False column is re-derived from the oracle; scalar wins
        scalar = gang_scalar_mask(instance_types, distinct, slice_shape)
        if scalar.any():
            _count("gang-mismatch")
            mask = scalar
    mask = np.array(mask, bool)
    mask.flags.writeable = False
    FILTER_BATCH_SECONDS.observe(time.perf_counter() - t0, stage="gang")
    with _LOCK:
        if len(_GANG_MASK_CACHE) >= _GANG_MASK_CACHE_CAP:
            _GANG_MASK_CACHE.pop(next(iter(_GANG_MASK_CACHE)))
        _GANG_MASK_CACHE[gkey] = mask
    return mask


def clear_gang_cache() -> None:
    """Forget every cached gang and slice column (a run that counts the
    member-column programs it launches starts here)."""
    with _LOCK:
        _GANG_MASK_CACHE.clear()
        _SLICE_COL_CACHE.clear()


def labels_signature(labels: Dict[str, str]) -> tuple:
    """Hashable identity of one pod's label set: the peer axis is deduped
    by this, so a 10k-replica deployment is ONE peer column."""
    return tuple(sorted(labels.items()))


def selector_signature(sel) -> Optional[tuple]:
    """Hashable identity of a LabelSelector, or None when it carries an
    operator outside {In, NotIn, Exists, DoesNotExist}: such selectors
    send the whole matrix to the scalar path (matches() silently skips
    unknown operators; the columnar mirror refuses to guess instead)."""
    for e in sel.match_expressions:
        if e.operator not in _AFFINITY_OPS:
            return None
    return (tuple(sorted(sel.match_labels.items())),
            tuple((e.key, e.operator, tuple(e.values))
                  for e in sel.match_expressions))


def _affinity_scalar(selectors, peer_sigs) -> np.ndarray:
    """The scalar oracle: LabelSelector.matches per cell, the reference
    semantics every columnar leg must reproduce exactly."""
    out = np.zeros((len(selectors), len(peer_sigs)), bool)
    dicts = [dict(sig) for sig in peer_sigs]
    for s, sel in enumerate(selectors):
        for p, labels in enumerate(dicts):
            out[s, p] = sel.matches(labels)
    return out


def _affinity_columnar(selectors, peer_sigs) -> np.ndarray:
    """Host columnar leg: per-key (presence, value-id) peer columns, one
    vector op per selector clause. Mirrors matches() clause by clause:
    an absent key fails match_labels and In, passes NotIn. The checks hold
    the device matrix against it; no path of the provisioner runs it."""
    P = len(peer_sigs)
    key_cols: Dict[str, tuple] = {}

    def cols_for(key: str):
        ent = key_cols.get(key)
        if ent is None:
            has = np.zeros(P, bool)
            vid = np.full(P, -1, np.int64)
            vocab: Dict[str, int] = {}
            for p, sig in enumerate(peer_sigs):
                for k, v in sig:
                    if k == key:
                        has[p] = True
                        vid[p] = vocab.setdefault(v, len(vocab))
                        break
            ent = key_cols[key] = (has, vid, vocab)
        return ent

    out = np.zeros((len(selectors), P), bool)
    for s, sel in enumerate(selectors):
        acc = np.ones(P, bool)
        for k, v in sel.match_labels.items():
            _has, vid, vocab = cols_for(k)
            i = vocab.get(v)
            acc &= (vid == i) if i is not None else np.zeros(P, bool)
        for e in sel.match_expressions:
            has, vid, vocab = cols_for(e.key)
            if e.operator == "In":
                ids = [vocab[v] for v in e.values if v in vocab]
                acc &= np.isin(vid, ids) if ids else np.zeros(P, bool)
            elif e.operator == "NotIn":
                ids = [vocab[v] for v in e.values if v in vocab]
                if ids:
                    acc &= ~np.isin(vid, ids)
            elif e.operator == "Exists":
                acc &= has
            else:  # DoesNotExist (the signature gate excludes everything else)
                acc &= ~has
        out[s] = acc
    return out


def affinity_match_matrix(selectors, peer_sigs, device: DeviceLike = None) -> np.ndarray:
    """(S, P) bool: ``selectors[s].matches(dict(peer_sigs[p]))`` for every
    cell, computed by the device program on ``device`` (default: the CUDA
    device; ``"cpu"`` runs the same torch ops on the CPU) with the
    probe-verified scalar self-heal described above. ``peer_sigs`` are
    :func:`labels_signature` tuples."""
    if not selectors or not peer_sigs:
        return np.zeros((len(selectors), len(peer_sigs)), bool)
    sigs = tuple(selector_signature(s) for s in selectors)
    if any(sig is None for sig in sigs):
        _count("unsupported-operator")
        return _affinity_scalar(selectors, peer_sigs)
    from karpenter_tpu_torch.ops import device_filter

    t0 = time.perf_counter()
    mat = device_filter.affinity_matrix(sigs, tuple(peer_sigs), device)
    # probe self-heal: sampled cells against the scalar oracle; one
    # divergence condemns the whole matrix (scalar wins)
    S, P = mat.shape
    rng = np.random.default_rng(S * 73856093 + P * 19349663 + 1)
    k = min(_AFFINITY_PROBE_K, S * P)
    cells = rng.choice(S * P, size=k, replace=False)
    for c in cells:
        s, p = int(c) // P, int(c) % P
        if bool(mat[s, p]) != selectors[s].matches(dict(peer_sigs[p])):
            _count("affinity-mismatch")
            mat = _affinity_scalar(selectors, peer_sigs)
            break
    FILTER_BATCH_SECONDS.observe(time.perf_counter() - t0, stage="affinity")
    return mat
