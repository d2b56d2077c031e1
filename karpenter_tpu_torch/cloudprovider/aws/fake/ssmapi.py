"""Fake SSM API returning deterministic AMI ids per parameter path.

A copy of the JAX package's fake (reference:
pkg/cloudprovider/aws/fake/ssmapi.go).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

from karpenter_tpu_torch.cloudprovider.aws import sdk


class FakeSSMAPI(sdk.SSMAPI):
    def __init__(self):
        self.calls: List[str] = []
        self.parameters: Dict[str, str] = {}

    def get_parameter(self, name: str) -> str:
        self.calls.append(name)
        if name in self.parameters:
            return self.parameters[name]
        # stable fake AMI id derived from the query, so distinct queries
        # (gpu/arm64 suffixes) yield distinct AMIs
        digest = hashlib.sha256(name.encode()).hexdigest()[:17]
        return f"ami-{digest}"

    def reset(self) -> None:
        self.calls.clear()
        self.parameters.clear()
