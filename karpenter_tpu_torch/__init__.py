"""PyTorch/CUDA port of the karpenter_tpu node-provisioning solver.

Pods and an instance-type catalog go in through
:func:`karpenter_tpu_torch.solver.solve.solve`; a node set comes out. The
first-fit-decreasing pack runs as a hand-written CUDA kernel for Hopper
(``csrc/pack.cu``, built at first use); every kernel has a plain PyTorch
version beside it that the CPU runs. Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from karpenter_tpu_torch.backend import resolve_device

__all__ = ["resolve_device"]
