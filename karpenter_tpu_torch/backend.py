"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU. There is no
probe that answers "cpu" when the card is missing: a caller that asked for
the default device and has no CUDA device gets an error naming the missing
card, never a quiet CPU run.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; an explicit device is taken as given. Raises
    ``RuntimeError`` when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "karpenter_tpu_torch runs on a CUDA device by default and found "
            "none (torch.cuda.is_available() is False); pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: expected 'cuda' or 'cpu'")
    return dev

