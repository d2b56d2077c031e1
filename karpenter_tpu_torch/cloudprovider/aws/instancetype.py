"""EC2 instance-type adaptation: raw DescribeInstanceTypes data → SPI
InstanceType.

A copy of the JAX package's module (reference:
pkg/cloudprovider/aws/instancetype.go). The capacity math the Go adapter
does lazily per accessor is materialized once here into the value type the
solver encodes into capacity tensors.
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.cloudprovider.aws import sdk
from karpenter_tpu_torch.cloudprovider.aws.vendor import AWS_TO_KUBE_ARCHITECTURES
from karpenter_tpu_torch.cloudprovider.spi import InstanceType, Offering
from karpenter_tpu_torch.utils.resources import Quantity

# EC2 VM consumes <7.5% of machine memory (instancetype.go:32)
EC2_VM_AVAILABLE_MEMORY_FACTOR = 0.925

# kube-reserved CPU percentage ladder (instancetype.go:143-152, from
# bottlerocket's kubernetes settings)
_CPU_OVERHEAD_LADDER = (
    (0, 1000, 0.06),
    (1000, 2000, 0.01),
    (2000, 4000, 0.005),
    (4000, 1 << 31, 0.0025),
)


def eni_limited_pods(info: sdk.InstanceTypeInfo) -> int:
    """max ENIs × (IPv4 addresses per ENI − 1) + 2 (instancetype.go:166-169)."""
    return info.maximum_network_interfaces * (info.ipv4_addresses_per_interface - 1) + 2


def memory_mib(info: sdk.InstanceTypeInfo) -> int:
    """Memory discounted by the VM overhead factor (instancetype.go:65-71)."""
    return int(info.memory_mib * EC2_VM_AVAILABLE_MEMORY_FACTOR)


def architecture(info: sdk.InstanceTypeInfo) -> str:
    """First recognized architecture (instancetype.go:53-60)."""
    for arch in info.supported_architectures:
        if arch in AWS_TO_KUBE_ARCHITECTURES:
            return AWS_TO_KUBE_ARCHITECTURES[arch]
    return str(info.supported_architectures)  # unrecognized; kept for errors


def gpu_count(info: sdk.InstanceTypeInfo, manufacturer: str) -> int:
    """Sum GPU counts gated on the FIRST entry's manufacturer — the
    reference checks Gpus[0].Manufacturer inside the loop
    (instancetype.go:92-116); quirk preserved for parity."""
    if not info.gpus:
        return 0
    if info.gpus[0].manufacturer != manufacturer:
        return 0
    return sum(g.count for g in info.gpus)


def overhead_cpu_milli(vcpus: int) -> int:
    """system-reserved 100m + kube-reserved ladder (instancetype.go:127-161)."""
    cpu_milli = vcpus * 1000
    total = 100  # system-reserved
    for start, end, percentage in _CPU_OVERHEAD_LADDER:
        if cpu_milli >= start:
            r = float(min(cpu_milli, end) - start)
            total += int(r * percentage)
    return total


def overhead_memory_mib(info: sdk.InstanceTypeInfo) -> int:
    """kube-reserved (11 Mi/pod + 255) + system-reserved 100 + eviction
    threshold 100 (instancetype.go:134-139)."""
    return (11 * eni_limited_pods(info) + 255) + 100 + 100


def pods(info: sdk.InstanceTypeInfo, max_pods: Optional[int]) -> int:
    """Configured cap if the ENI-limited density option is off, else the ENI
    formula (instancetype.go:73-78)."""
    if max_pods is not None:
        return max_pods
    return eni_limited_pods(info)


def adapt(
    info: sdk.InstanceTypeInfo,
    offerings: List[Offering],
    max_pods: Optional[int] = None,
) -> InstanceType:
    """Materialize the SPI value type from raw EC2 data."""
    pod_eni = info.pod_eni_branch_interfaces if info.pod_eni_trunking_compatible else 0
    return InstanceType(
        name=info.instance_type,
        offerings=list(offerings),
        architecture=architecture(info),
        operating_systems=frozenset({wellknown.OPERATING_SYSTEM_LINUX}),
        cpu=Quantity.parse(str(info.vcpus)),
        memory=Quantity.parse(f"{memory_mib(info)}Mi"),
        pods=Quantity.parse(str(pods(info, max_pods))),
        nvidia_gpus=Quantity.parse(str(gpu_count(info, "NVIDIA"))),
        amd_gpus=Quantity.parse(str(gpu_count(info, "AMD"))),
        aws_neurons=Quantity.parse(str(info.inference_accelerator_count)),
        aws_pod_eni=Quantity.parse(str(pod_eni)),
        overhead={
            "cpu": Quantity.parse(f"{overhead_cpu_milli(info.vcpus)}m"),
            "memory": Quantity.parse(f"{overhead_memory_mib(info)}Mi"),
        },
        price=info.price_per_hour,
    )
