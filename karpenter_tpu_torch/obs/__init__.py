"""Observability layer: span tracing (`obs.trace`), the black-box flight
recorder (`obs.flight`) and the per-pod SLO engine (`obs.slo`).

Kept import-light: nothing here may import controllers or the solver —
the hot path imports *us* on every window.
"""

from karpenter_tpu_torch.obs import flight, trace  # noqa: F401
