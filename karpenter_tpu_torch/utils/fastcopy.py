"""Fast deep copy for the core object model.

``copy.deepcopy`` is the in-memory apiserver's (runtime/kubecore.py) single
biggest cost at the 10k-pod regime — every create/get/update/watch-event
pays it, and the generic implementation spends most of its time in memo
bookkeeping our object model doesn't need (dataclass trees with no shared
references or cycles). This copier is specialized to that model:

- dataclasses: every ``__dict__`` entry copied recursively (this includes
  non-field cache attributes like the solver marshal tuple, carried across
  copies exactly like deepcopy does);
- dict / list / tuple / set: rebuilt recursively;
- Quantity: immutable value object — fresh instance via its own copy();
- str/int/float/bool/bytes/None/frozenset: returned as-is (atomic);
- anything else: falls back to copy.deepcopy.

A copy of the JAX package's module; tests/test_torch_kubecore.py holds it
against copy.deepcopy equality.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from karpenter_tpu_torch.utils.resources import Quantity

_FIELDS_SEEN: Dict[type, bool] = {}


def _is_dataclass_type(cls: type) -> bool:
    seen = _FIELDS_SEEN.get(cls)
    if seen is None:
        seen = _FIELDS_SEEN[cls] = dataclasses.is_dataclass(cls)
    return seen


_ATOMS = frozenset((str, int, float, bool, bytes, frozenset, type(None)))


def deep_copy(obj: Any) -> Any:
    cls = obj.__class__
    if cls in _ATOMS:
        return obj
    # atoms are taken inline, without a call: a node-affinity term lists
    # hundreds of names, and most fields of an object are strings
    if cls is dict:
        return {k: v if v.__class__ in _ATOMS else deep_copy(v) for k, v in obj.items()}
    if cls is list:
        return [v if v.__class__ in _ATOMS else deep_copy(v) for v in obj]
    if cls is Quantity:
        return obj.deepcopy()
    if cls is tuple:
        return tuple(deep_copy(v) for v in obj)
    if cls is set:
        return {deep_copy(v) for v in obj}
    if _is_dataclass_type(cls):
        new = cls.__new__(cls)
        new.__dict__.update({k: v if v.__class__ in _ATOMS else deep_copy(v)
                             for k, v in obj.__dict__.items()})
        return new
    import copy

    return copy.deepcopy(obj)
