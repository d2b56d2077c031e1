"""Worker-pool sizing for the GIL-bound control plane.

The reference sizes concurrency for goroutines (10,000 concurrent selection
reconciles, selection/controller.go:181). Python threads doing CPU-bound
reconcile work share one GIL: beyond a few threads per core they add
context switches and lock contention without adding throughput. The
selection controller never parks a worker on the batch gate, so a pool
only needs enough threads to hide the occasional kube I/O wait.
"""

from __future__ import annotations

import os


def adaptive_workers(requested: int, per_core: int = 8, floor: int = 2) -> int:
    """``requested`` clamped to ``per_core`` threads a core, at least
    ``floor``."""
    cores = os.cpu_count() or 1
    return max(floor, min(requested, cores * per_core))
