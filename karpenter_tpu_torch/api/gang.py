"""Gang (pod-group) label contract: which pods must bind all-or-nothing.

A copy of the JAX package's parse (``api/gang.py:145-182``), trimmed to
:func:`gang_of` and what it returns. Membership is declared with labels:

    karpenter.sh/pod-group:       <name>     group identity (per namespace)
    karpenter.sh/pod-group-size:  <int>      full membership count (>= 1)
    karpenter.sh/pod-group-slice: v5e-4x4    optional TPU slice shape

Malformed declarations (unparseable size, bad slice syntax) parse to a
:class:`GangSpec` with ``error`` set, never to None, so a pod is not
silently demoted to a singleton. The batcher holds a gang until it is
complete; the port's scheduler holds complete gangs out of the solve
(gang co-pack is not ported yet) and refuses malformed ones.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import Pod

# "v5e-4x4", "v4-2x2x4": family token, then an 'x'-separated integer grid
_SLICE_RE = re.compile(r"^([a-z][a-z0-9]*)-(\d+(?:x\d+)*)$")

# gangs larger than this are refused at parse time (a window could never
# hold them and the batcher would sit on the partial group until TTL)
MAX_GANG_SIZE = 4096


def parse_slice_shape(text: str) -> Optional[str]:
    """``"v5e-4x4"`` → its canonical text; None for anything malformed
    (empty, missing grid, zero dimension)."""
    m = _SLICE_RE.match(text.strip())
    if not m:
        return None
    dims = [int(d) for d in m.group(2).split("x")]
    if any(d <= 0 for d in dims):
        return None
    return f"{m.group(1)}-" + "x".join(str(d) for d in dims)


@dataclass(frozen=True)
class GangSpec:
    """Parsed gang membership of one pod. ``key`` identifies the gang
    (namespace-scoped); the scheduler folds the full spec into the group
    key, so a member that disagrees on size or slice lands in its own
    (forever incomplete) group."""

    namespace: str
    name: str
    size: int
    slice_: Optional[str] = None
    error: Optional[str] = None

    @property
    def key(self) -> Tuple[str, str]:
        return (self.namespace, self.name)

    @property
    def group_part(self) -> tuple:
        """The structural tail appended to the scheduler group key."""
        return ("gang", self.namespace, self.name, self.size, self.slice_ or "")


def gang_of(pod: Pod) -> Optional[GangSpec]:
    """The pod's gang declaration, or None for a plain pod. Cached on the
    pod (labels are immutable through the scheduling path). A malformed
    declaration returns a spec with ``error`` set, never None."""
    cached = pod.__dict__.get("_gang_spec", False)
    if cached is not False:
        return cached
    spec = _parse_gang(pod)
    pod.__dict__["_gang_spec"] = spec
    return spec


def _parse_gang(pod: Pod) -> Optional[GangSpec]:
    labels = pod.metadata.labels or {}
    name = labels.get(wellknown.POD_GROUP_LABEL)
    if name is None:
        return None
    ns = pod.metadata.namespace
    raw_size = labels.get(wellknown.POD_GROUP_SIZE_LABEL, "")
    try:
        size = int(raw_size)
    except (TypeError, ValueError):
        return GangSpec(ns, name, 0,
                        error=f"invalid {wellknown.POD_GROUP_SIZE_LABEL}="
                              f"{raw_size!r} (want an integer)")
    if size < 1 or size > MAX_GANG_SIZE:
        return GangSpec(ns, name, 0,
                        error=f"gang size {size} out of range [1, {MAX_GANG_SIZE}]")
    slice_ = None
    raw_slice = labels.get(wellknown.POD_GROUP_SLICE_LABEL)
    if raw_slice:
        slice_ = parse_slice_shape(raw_slice)
        if slice_ is None:
            return GangSpec(ns, name, size,
                            error=f"invalid {wellknown.POD_GROUP_SLICE_LABEL}="
                                  f"{raw_slice!r} (want e.g. 'v5e-4x4')")
    return GangSpec(ns, name, size, slice_)
