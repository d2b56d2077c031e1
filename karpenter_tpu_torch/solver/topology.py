"""The carve program (B11): gangs × bins × placements on the device.

The JAX package's ``solver/topology.py`` jits ``_carve_jit``: for every
gang of a window, every candidate carve of its slice shape (all origins ×
all distinct orientations, the (S, NC, P, C) placement-mask bank of
ops/topology.py) against every bin's occupancy plane, giving the (G, B)
carve-feasibility verdict. A literal eager port of its vmap would build a
(GB, BB, PB, CB) bool intermediate: 8.6 G cells at the gang window's cap
on a 4x8 grid. Here :func:`carve_program` uses that the verdict depends on
a gang only through its slice class: it computes one (SB, BB) verdict per
slice class with each bin's cells packed into int64 words (one word for
every grid of the fake TPU catalog, more for larger grids), S × BB × PB
words in all, then gathers each gang's row by its class. Torch integer
ops, not a hand kernel; equal to ``_carve_jit`` bit for bit by
construction, and held so by the tests.

The verdict is a FILTER: solver/gang.py ANDs it into the gang kernel's
compat rows on the device, and the host walk re-verifies every carve cell
by cell before commit. Deterministic probe cells of the verdict are
checked against the scalar oracle ``scalar_carve_cell``; a disagreement
condemns the whole verdict, the scalar scan ``scalar_carve`` answers
instead and :data:`HEALS` counts it.

``KARPENTER_TOPOLOGY_CARVE=0`` switches carving off: the provisioning
encoder then passes no slice or grid annotations and the gang window is
the shape-only one. It chooses between two semantics, not between the
card and the host. Left out of the reference: ``CarveConfig`` (its device
gates, the watchdog and the breaker) and the host-mirror fallback on a
device error, which raises.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.backend import DeviceLike, resolve_device, to_device_int32
from karpenter_tpu_torch.ops.topology import (
    CarveEncoding, host_carve, scalar_carve, scalar_carve_cell)
from karpenter_tpu_torch.solver.solve import record_executor

_ENV = "KARPENTER_TOPOLOGY_CARVE"
# verdict cells checked against the scalar oracle at fetch
PROBES = 8
# int64 words one step of the program holds: the slice-class axis is
# walked in steps so a large window's (S, BB, PB, W) intermediate stays
# bounded
_STEP_WORDS = 1 << 24

_LOCK = threading.Lock()
HEALS = 0  # verdicts a failed probe sent to scalar_carve since import
RUNS = 0   # carve programs run since import


def carve_enabled() -> bool:
    """KARPENTER_TOPOLOGY_CARVE=0/false/off turns carving off (shape-only
    slice gating); default on."""
    return os.environ.get(_ENV, "").strip().lower() not in ("0", "false", "off")


def _pack_cells(cells: torch.Tensor) -> torch.Tensor:
    """(..., CB) 0/1 → (..., W) int64 words, cell c at bit c % 64 of word
    c // 64 (CB is a power of two). The bits are distinct, so their sum is
    their OR; bit 63 wraps to the sign, which ``&`` and ``!= 0`` read
    correctly."""
    cb = cells.shape[-1]
    width = min(cb, 64)
    shifts = torch.arange(width, dtype=torch.int64, device=cells.device)
    words = cells.reshape(*cells.shape[:-1], cb // width, width).to(torch.int64) << shifts
    return words.sum(-1)


def carve_program(occ: torch.Tensor, cls_of: torch.Tensor, scls_of: torch.Tensor,
                  pmask: torch.Tensor, pvalid: torch.Tensor) -> torch.Tensor:
    """(GB, BB) bool carve verdict from the padded carve tensors on one
    device (``occ`` (BB, CB), ``cls_of`` (BB,), ``scls_of`` (GB,),
    ``pmask`` (SB, NCB, PB, CB), ``pvalid`` (SB, NCB, PB); bool or 0/1
    int32). Row g is True everywhere when gang g has no slice class; a bin
    with no grid class is False for a slice gang."""
    global RUNS
    occ_w = _pack_cells(occ)                        # (BB, W)
    pm_w = _pack_cells(pmask)                       # (SB, NCB, PB, W)
    pvalid = pvalid != 0
    has_grid = cls_of >= 0
    clsx = cls_of.clamp(min=0).long()
    SB, _, PB, W = pm_w.shape
    BB = occ_w.shape[0]
    step = max(1, _STEP_WORDS // max(1, BB * PB * W))
    per_class = []
    for s0 in range(0, SB, step):
        mb = pm_w[s0:s0 + step][:, clsx]           # (s, BB, PB, W)
        overlap = ((mb & occ_w[None, :, None, :]) != 0).any(-1)
        vb = pvalid[s0:s0 + step][:, clsx]         # (s, BB, PB)
        per_class.append((vb & ~overlap).any(-1) & has_grid[None, :])
    ok = torch.cat(per_class) if len(per_class) > 1 else per_class[0]  # (SB, BB)
    rows = ok.index_select(0, scls_of.clamp(min=0).long())  # (GB, BB)
    with _LOCK:
        RUNS += 1
    return rows | (scls_of < 0)[:, None]


def carve_arrays(cv: CarveEncoding) -> List[np.ndarray]:
    """The padded carve arrays in :func:`carve_program`'s argument order."""
    return [cv.d_occ, cv.d_cls, cv.d_scls, cv.d_pmask, cv.d_pvalid]


def probe_pairs(g: int, b: int, n: int) -> List[Tuple[int, int]]:
    """Deterministic probe cells spread over the (G, B) verdict, no RNG,
    so a window probes the same cells on every run."""
    total = g * b
    if total <= 0:
        return []
    n = min(n, total)
    step = max(total // n, 1)
    return [((i * step) % total // b, (i * step) % b) for i in range(n)]


def probes_hold(enc, pairs: List[Tuple[int, int]], values) -> bool:
    """Whether the verdict's values at ``pairs`` equal the scalar oracle;
    a disagreement is counted in :data:`HEALS`."""
    global HEALS
    for (gi, bi), v in zip(pairs, values):
        if bool(v) != scalar_carve_cell(enc, gi, bi):
            with _LOCK:
                HEALS += 1
            return False
    return True


def check_probes(enc, verdict: np.ndarray, probes: int = PROBES
                 ) -> Tuple[bool, np.ndarray]:
    """Probe a deterministic subset of a (G, B) verdict against the scalar
    oracle. A divergence condemns the WHOLE verdict: :data:`HEALS` counts
    it and the scalar scan answers. Returns (probes held, verdict to
    trust)."""
    pairs = probe_pairs(verdict.shape[0], verdict.shape[1], probes)
    if probes_hold(enc, pairs, [verdict[gi, bi] for gi, bi in pairs]):
        return True, verdict
    return False, scalar_carve(enc)


@dataclass
class CarveHandle:
    """In-flight half of a standalone carve solve (checks and tools; the
    provisioning path runs the same program inside the gang dispatch)."""

    enc: object                      # GangEncoding (carries .carve)
    cv: CarveEncoding
    _out: Optional[torch.Tensor] = None
    _result: Optional[Tuple[np.ndarray, str]] = None

    def fetch(self) -> Tuple[np.ndarray, str]:
        """((G, B) carve feasibility, executor): ``"device-carve"``,
        ``"scalar-carve"`` after a failed probe, or ``"host-carve"`` for a
        window that carries no padded arrays."""
        if self._result is not None:
            return self._result
        if self._out is None:
            verdict, executor = host_carve(self.cv), "host-carve"
        else:
            verdict = self._out.cpu().numpy()[:self.cv.g, :self.cv.b]
            ok, verdict = check_probes(self.enc, verdict)
            executor = "device-carve" if ok else "scalar-carve"
            self._out = None
        record_executor(executor)
        self._result = (verdict, executor)
        return self._result


def dispatch_carve_window(enc, device: DeviceLike = None) -> CarveHandle:
    """Copy the window's carve arrays to ``device`` (default: the CUDA
    device; ``"cpu"`` runs the same torch ops on the CPU) in one copy and
    run the program without waiting for it."""
    cv = enc.carve
    if cv is None:
        raise ValueError("gang window carries no carve encoding")
    handle = CarveHandle(enc=enc, cv=cv)
    if cv.device_ready:
        handle._out = carve_program(*to_device_int32(carve_arrays(cv), resolve_device(device)))
    return handle


def solve_carve_window(enc, device: DeviceLike = None) -> Tuple[np.ndarray, str]:
    """dispatch + fetch in one call."""
    return dispatch_carve_window(enc, device).fetch()
