"""Group columns on the device: the gang feasibility column and the pod-pod
affinity match matrix.

A trimmed copy of the gang and affinity parts of the JAX package's
``ops/feasibility.py``.

A gang's allowed-type column (:func:`gang_feasibility_mask`) is the AND of
its members' per-type feasibility, computed on the device from the catalog
bit-planes (``ops/device_filter.gang_member_column``, the JAX package's
``_rows_jit``), intersected with a slice-compatibility column when the
gang declares a slice shape. A catalog that cannot be put in planes takes
the scalar per-member oracle :func:`gang_scalar_mask`, counted under
``gang-unindexable``; ``KARPENTER_DEVICE_FILTER=0`` sends every column to
the oracle, the operator's choice, uncounted. An all-False
column is re-derived from the oracle and the oracle wins when it finds a
type, counted under ``gang-mismatch``. Columns are cached per gang
signature (catalog identity, distinct member keys, slice shape).

Required pod-(anti-)affinity compiles to a
selectors × peers boolean match matrix: S distinct LabelSelector
signatures evaluated against P distinct pod-label signatures. The device
program (:func:`ops.device_filter.affinity_matrix`, B5) computes it from
packed (key, value) pair bit-planes in one call. Its verdict stays a
FILTER: sampled cells are re-checked against the scalar
``LabelSelector.matches`` oracle, and any divergence recomputes the whole
matrix scalar (the scalar matrix wins), counted in :data:`HEALS` under
``affinity-mismatch``. A selector with an operator outside {In, NotIn,
Exists, DoesNotExist} sends the whole matrix to the scalar oracle,
counted under ``unsupported-operator``.

Left out: the columnar constraint engine of the same module
(``compile_constraints``, the per-signature memo of ``validate_pod`` /
``tighten``, ``catalog_feasibility_mask``), which is queued with the
host-bound window work; and the ``KARPENTER_POLICY_COLUMNAR`` kill switch.
A device error raises.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from karpenter_tpu_torch.api.gang import instance_slice_shape, slice_fits
from karpenter_tpu_torch.backend import DeviceLike

_AFFINITY_OPS = frozenset({"In", "NotIn", "Exists", "DoesNotExist"})
_AFFINITY_PROBE_K = 32

_LOCK = threading.Lock()
# self-heals since the last reset, by reason: "affinity-mismatch" (a probe
# cell of the device matrix disagreed with the scalar oracle),
# "unsupported-operator" (the matrix went to the oracle outright),
# "gang-mismatch" (an all-False gang column the oracle refuted) and
# "gang-unindexable" (a gang column the device could not compute)
HEALS: Dict[str, int] = {}


def _count(reason: str) -> None:
    with _LOCK:
        HEALS[reason] = HEALS.get(reason, 0) + 1


def heal_counts() -> Dict[str, int]:
    with _LOCK:
        return dict(HEALS)


def reset_heals() -> None:
    with _LOCK:
        HEALS.clear()


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
    runs the same torch ops on the CPU). Never None; shared and
    read-only."""
    from karpenter_tpu_torch.ops import device_filter

    tokens = tuple(device_filter._catalog_token(it) for it in instance_types)
    distinct = tuple(sorted(set(member_keys)))
    gkey = (tokens, distinct, str(slice_shape) if slice_shape else "")
    with _LOCK:
        hit = _GANG_MASK_CACHE.get(gkey)
    if hit is not None:
        return hit
    if not distinct:
        mask = np.ones(len(instance_types), bool)
    elif device_filter.enabled():
        mask = device_filter.gang_member_column(instance_types, distinct, device)
        if mask is None:
            _count("gang-unindexable")
    else:  # KARPENTER_DEVICE_FILTER=0: the operator chose the host
        mask = gang_scalar_mask(instance_types, distinct, None)
    if mask is not None and slice_shape is not None:
        mask = mask & _slice_column(instance_types, tokens, slice_shape)
    if mask is None:
        mask = gang_scalar_mask(instance_types, distinct, slice_shape)
    elif distinct and not mask.any():
        # an all-False column is re-derived from the oracle; scalar wins
        scalar = gang_scalar_mask(instance_types, distinct, slice_shape)
        if scalar.any():
            _count("gang-mismatch")
            mask = scalar
    mask = np.array(mask, bool)
    mask.flags.writeable = False
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
            return _affinity_scalar(selectors, peer_sigs)
    return mat
