"""PyTorch/CUDA port of the karpenter_tpu node-provisioning solver.

Pods and an instance-type catalog go in through
:func:`karpenter_tpu_torch.solver.solve.solve`; a node set comes out. The
first-fit-decreasing pack runs as a hand-written CUDA kernel for Hopper
(``csrc/pack.cu``, built at first use); every kernel has a plain PyTorch
version beside it that the CPU runs. Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # torch comes with the first module that needs it, not with the
    # package: the stub servers' processes never load it
    if name == "resolve_device":
        from karpenter_tpu_torch.backend import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
