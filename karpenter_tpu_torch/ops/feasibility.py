"""Pod-pod affinity match matrix: selectors × peers, on the device.

A trimmed copy of the affinity part of the JAX package's
``ops/feasibility.py``. Required pod-(anti-)affinity compiles to a
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
``tighten``), which is queued with the host-bound window work; and the
``KARPENTER_POLICY_COLUMNAR`` kill switch. A device error raises.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from karpenter_tpu_torch.backend import DeviceLike

_AFFINITY_OPS = frozenset({"In", "NotIn", "Exists", "DoesNotExist"})
_AFFINITY_PROBE_K = 32

_LOCK = threading.Lock()
# self-heals since the last reset, by reason: "affinity-mismatch" (a probe
# cell of the device matrix disagreed with the scalar oracle) and
# "unsupported-operator" (the matrix went to the oracle outright)
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
