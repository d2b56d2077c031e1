"""Exact Kubernetes resource-quantity arithmetic.

The reference does all hot-loop math on ``resource.Quantity`` (string-backed
decimal; see pkg/utils/resources/resources.go:22-50). That representation is
hostile to vectorization, so this framework splits the concern:

- Host side (this module): an exact integer ``Quantity`` (nano-units) with the
  same parse/compare/add semantics as k8s ``resource.Quantity``. Used by the
  control plane and the host oracle solver.
- Device side (karpenter_tpu_torch/ops/encode.py): quantities are interned into
  dense int32 tensors with per-resource dynamic scaling, with a host fallback
  when exact int32 encoding is impossible.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Union

NANO = 10**9

_BIN_SUFFIX = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC_SUFFIX = {
    "n": 10**-9, "u": 10**-6, "m": 10**-3, "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
}
_QTY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+)(Ki|Mi|Gi|Ti|Pi|Ei|[eE][+-]?[0-9]+|n|u|m|k|M|G|T|P|E)?$")


class Quantity:
    """Exact quantity stored as integer nano-units.

    Mirrors k8s.io/apimachinery resource.Quantity parse and comparison
    semantics for every format Karpenter actually uses (milli CPU, binary/
    decimal memory, plain counts).
    """

    __slots__ = ("nano", "_suffix")

    def __init__(self, nano: int, suffix: str = ""):
        self.nano = int(nano)
        self._suffix = suffix

    # -- constructors -------------------------------------------------------
    @staticmethod
    def parse(s: Union[str, int, float, "Quantity"]) -> "Quantity":
        if isinstance(s, Quantity):
            return s
        if isinstance(s, int):
            return Quantity(s * NANO)
        if isinstance(s, float):
            # floats only reach here from test fixtures; route through repr to
            # get the decimal the author wrote.
            s = repr(s)
        s = s.strip()
        m = _QTY_RE.match(s)
        if not m:
            raise ValueError(f"cannot parse quantity {s!r}")
        num, suffix = m.group(1), m.group(2) or ""
        if suffix in _BIN_SUFFIX:  # before the exponent branch: "Ei" is exbi
            return Quantity(_decimal_to_nano(num, _BIN_SUFFIX[suffix]), suffix)
        if suffix[:1] in ("e", "E") and len(suffix) > 1:
            # scientific notation (k8s decimalExponent) — exact integer math
            exp = int(suffix[1:])
            if exp >= 0:
                return Quantity(_decimal_to_nano(num, 10**exp), "")
            return Quantity(_decimal_to_nano(num, 1, 10**-exp), "")
        mult = _DEC_SUFFIX[suffix]
        if isinstance(mult, float):  # n/u/m
            denom = {"n": 10**9, "u": 10**6, "m": 10**3}[suffix]
            return Quantity(_decimal_to_nano(num, 1, denom), suffix)
        return Quantity(_decimal_to_nano(num, mult), suffix)

    @staticmethod
    def from_milli(milli: int) -> "Quantity":
        return Quantity(milli * (NANO // 1000), "m")

    @staticmethod
    def from_value(v: int) -> "Quantity":
        return Quantity(v * NANO)

    # -- accessors ----------------------------------------------------------
    def value(self) -> int:
        """Integer value, rounding up (k8s Value() semantics)."""
        return -((-self.nano) // NANO)

    def milli_value(self) -> int:
        """Milli-units, rounding up (k8s MilliValue() semantics)."""
        return -((-self.nano) // (NANO // 1000))

    def is_zero(self) -> bool:
        return self.nano == 0

    # -- arithmetic ---------------------------------------------------------
    def add(self, other: "Quantity") -> "Quantity":
        return Quantity(self.nano + other.nano, self._suffix)

    def sub(self, other: "Quantity") -> "Quantity":
        return Quantity(self.nano - other.nano, self._suffix)

    def cmp(self, other: "Quantity") -> int:
        return (self.nano > other.nano) - (self.nano < other.nano)

    def deepcopy(self) -> "Quantity":
        return Quantity(self.nano, self._suffix)

    def __eq__(self, other):
        return isinstance(other, Quantity) and self.nano == other.nano

    def __lt__(self, other):
        return self.nano < other.nano

    def __le__(self, other):
        return self.nano <= other.nano

    def __hash__(self):
        return hash(self.nano)

    def __repr__(self):
        return f"Quantity({self})"

    def __str__(self):
        if self._suffix in _BIN_SUFFIX and self.nano % (_BIN_SUFFIX[self._suffix] * NANO) == 0:
            return f"{self.nano // (_BIN_SUFFIX[self._suffix] * NANO)}{self._suffix}"
        if self.nano % NANO == 0:
            return str(self.nano // NANO)
        if self.nano % (NANO // 1000) == 0:
            return f"{self.nano // (NANO // 1000)}m"
        return f"{self.nano}n"


def _decimal_to_nano(num: str, mult: int, denom: int = 1) -> int:
    """Parse a decimal string exactly into nano units scaled by mult/denom."""
    neg = num.startswith("-")
    num = num.lstrip("+-")
    if "." in num:
        whole, frac = num.split(".", 1)
    else:
        whole, frac = num, ""
    whole_i = int(whole or "0")
    frac_i = int(frac or "0")
    scale = 10 ** len(frac)
    # value = (whole + frac/scale) * mult / denom, in nano:
    nano = (whole_i * scale + frac_i) * mult * NANO
    if nano % (scale * denom) != 0:
        # inexact (e.g. "0.3n") — round up like k8s (never under-reserve)
        nano = -((-nano) // (scale * denom))
    else:
        nano //= scale * denom
    return -nano if neg else nano


# ---------------------------------------------------------------------------
# ResourceList (reference: pkg/utils/resources/resources.go)
# ---------------------------------------------------------------------------

ResourceList = Dict[str, Quantity]

# Well-known resource names (resources.go:22-27)
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
NVIDIA_GPU = "nvidia.com/gpu"
AMD_GPU = "amd.com/gpu"
AWS_NEURON = "aws.amazon.com/neuron"
AWS_POD_ENI = "vpc.amazonaws.com/pod-eni"
EPHEMERAL_STORAGE = "ephemeral-storage"


def parse_resource_list(d: Optional[Mapping[str, Union[str, int, float, Quantity]]]) -> ResourceList:
    return {k: Quantity.parse(v) for k, v in (d or {}).items()}


def merge(*resource_lists: ResourceList) -> ResourceList:
    """Sum resource lists key-wise (resources.go Merge)."""
    out: ResourceList = {}
    for rl in resource_lists:
        for name, q in rl.items():
            out[name] = out.get(name, Quantity(0)).add(q)
    return out


def requests_for_pods(*pods) -> ResourceList:
    """Sum of container requests across pods (resources.go RequestsForPods)."""
    return merge(*[c.resources.requests for p in pods for c in p.spec.containers])


def limits_for_pods(*pods) -> ResourceList:
    return merge(*[c.resources.limits for p in pods for c in p.spec.containers])


_GPU_RESOURCES = (NVIDIA_GPU, AMD_GPU, AWS_NEURON)


def gpu_limits_for(pod) -> ResourceList:
    """GPU-class limits on a pod (resources.go GPULimitsFor): used to split
    schedules by accelerator demand."""
    return merge(*(
        {n: q for n, q in c.resources.limits.items() if n in _GPU_RESOURCES}
        for c in pod.spec.containers
    ))
