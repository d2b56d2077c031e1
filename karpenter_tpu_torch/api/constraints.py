"""Constraints — the node constraints a Provisioner applies.

Reference: pkg/apis/provisioning/v1alpha5/constraints.go:24-43. The solver
reads the requirements (the viability validators) and carries the labels
and taints through to the caller.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from karpenter_tpu_torch.api.core import Taint
from karpenter_tpu_torch.api.requirements import Requirements


@dataclass
class Constraints:
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    requirements: Requirements = field(default_factory=Requirements)
