"""Gang (pod-group) label contract: which pods must bind all-or-nothing.

A copy of the JAX package's ``api/gang.py``: the label parse and the
slice-shape algebra. Membership is declared with labels:

    karpenter.sh/pod-group:       <name>     group identity (per namespace)
    karpenter.sh/pod-group-size:  <int>      full membership count (>= 1)
    karpenter.sh/pod-group-slice: v5e-4x4    optional TPU slice shape

The slice shape constrains which offerings may host the gang: an instance
type is slice-compatible when it advertises a TPU topology
(``InstanceType.tpu_topology``) of the same accelerator family whose grid
contains the requested grid (every sorted dimension >=, so a v5e-4x8 host
can carve a v5e-4x4 slice and a v5e-2x2 host cannot). The mask over a
whole catalog is :func:`karpenter_tpu_torch.ops.feasibility.gang_feasibility_mask`.

Malformed declarations (unparseable size, bad slice syntax) parse to a
:class:`GangSpec` with ``error`` set, never to None, so a pod is not
silently demoted to a singleton. The batcher holds a gang until it is
complete; the scheduler hands a complete gang to the co-pack window and
refuses a malformed one.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from itertools import product
from typing import Iterator, Optional, Sequence, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.core import Pod

# "v5e-4x4", "v4-2x2x4": family token, then an 'x'-separated integer grid
_SLICE_RE = re.compile(r"^([a-z][a-z0-9]*)-(\d+(?:x\d+)*)$")

# gangs larger than this are refused at parse time (a window could never
# hold them and the batcher would sit on the partial group until TTL)
MAX_GANG_SIZE = 4096


@dataclass(frozen=True)
class SliceShape:
    """A TPU slice topology: accelerator family + dimension grid."""

    family: str            # "v5e", "v4", ...
    dims: Tuple[int, ...]  # ("4x4" → (4, 4)); never empty

    @property
    def chips(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def grid(self) -> Tuple[int, ...]:
        """The chip grid this shape spans, the torus ops/topology.py
        models: axis i has ``dims[i]`` chips and its links wrap."""
        return self.dims

    def coords(self) -> Iterator[Tuple[int, ...]]:
        """Every chip coordinate of the grid in row-major order."""
        return product(*(range(d) for d in self.dims))

    def flat_index(self, coord: Sequence[int]) -> int:
        """Row-major flat cell index of one chip coordinate."""
        idx = 0
        for c, d in zip(coord, self.dims):
            idx = idx * d + (c % d)
        return idx

    def __str__(self) -> str:
        return f"{self.family}-" + "x".join(str(d) for d in self.dims)


def parse_slice_shape(text: str) -> Optional[SliceShape]:
    """``"v5e-4x4"`` → SliceShape; None for anything malformed (empty,
    missing grid, zero dimension)."""
    m = _SLICE_RE.match(text.strip())
    if not m:
        return None
    dims = tuple(int(d) for d in m.group(2).split("x"))
    if any(d <= 0 for d in dims):
        return None
    return SliceShape(family=m.group(1), dims=dims)


def slice_fits(host: Optional[SliceShape], requested: SliceShape) -> bool:
    """True when a host topology can carve the requested slice: same family
    and the requested grid fits inside the host grid. Grids compare sorted
    descending, the shorter one padded with 1s (a (4, 4) request fits a
    (4, 4, 2) host); orientation does not matter for containment."""
    if host is None or host.family != requested.family:
        return False
    h = sorted(host.dims, reverse=True)
    r = sorted(requested.dims, reverse=True)
    n = max(len(h), len(r))
    h += [1] * (n - len(h))
    r += [1] * (n - len(r))
    return all(rd <= hd for rd, hd in zip(r, h))


def instance_slice_shape(it) -> Optional[SliceShape]:
    """The TPU topology an instance type advertises, parsed once and cached
    on the instance. Empty ``tpu_topology`` → None: the type hosts no
    slice-shaped gangs."""
    cached = it.__dict__.get("_slice_shape", False)
    if cached is not False:
        return cached
    topo = getattr(it, "tpu_topology", "") or ""
    shape = parse_slice_shape(topo) if topo else None
    it.__dict__["_slice_shape"] = shape
    return shape


@dataclass(frozen=True)
class GangSpec:
    """Parsed gang membership of one pod. ``key`` identifies the gang
    (namespace-scoped); the scheduler folds the full spec into the group
    key, so a member that disagrees on size or slice lands in its own
    (forever incomplete) group."""

    namespace: str
    name: str
    size: int
    slice_: Optional[SliceShape] = None
    error: Optional[str] = None

    @property
    def key(self) -> Tuple[str, str]:
        return (self.namespace, self.name)

    @property
    def group_part(self) -> tuple:
        """The structural tail appended to the scheduler group key."""
        return ("gang", self.namespace, self.name, self.size,
                str(self.slice_) if self.slice_ else "")


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
