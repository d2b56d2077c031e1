"""Brownout subsystem: pressure-aware admission, priority-aware shedding,
and a degradation ladder for the provisioning pipeline.

- :mod:`karpenter_tpu_torch.pressure.monitor` — signals → L0..L3 with hysteresis
- :mod:`karpenter_tpu_torch.pressure.bands` — priority bands + shedding policy
"""

from karpenter_tpu_torch.pressure.bands import (  # noqa: F401
    BANDS, RANK, classify, effective_rank, shed_reason,
)
from karpenter_tpu_torch.pressure.monitor import (  # noqa: F401
    PressureConfig, PressureLevel, PressureMonitor, configure, get_monitor, read_rss_bytes,
    set_monitor,
)
