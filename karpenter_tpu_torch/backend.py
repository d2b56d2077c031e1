"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU. There is no
probe that answers "cpu" when the card is missing: a caller that asked for
the default device and has no CUDA device gets an error naming the missing
card, never a quiet CPU run.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def to_device_int32(arrays: Sequence[np.ndarray],
                    device: torch.device) -> List[torch.Tensor]:
    """Host arrays → int32 tensors of the same shapes on ``device`` in ONE
    host→device copy: the arrays are laid end to end in one buffer, copied,
    and handed back as contiguous views of it. Values must fit int32 (bool
    arrays arrive as 0/1; uint32 bit patterns are reinterpreted)."""
    parts = [np.ascontiguousarray(a) for a in arrays]
    return _one_copy([a.view(np.int32) if a.dtype == np.uint32
                      else a.astype(np.int32, copy=False) for a in parts], device)


def to_device_float32(arrays: Sequence[np.ndarray],
                      device: torch.device) -> List[torch.Tensor]:
    """:func:`to_device_int32` for float32 tensors: one host→device copy."""
    return _one_copy([np.ascontiguousarray(a, dtype=np.float32) for a in arrays], device)


def _one_copy(parts: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in parts])).to(device)
    out, o = [], 0
    for a in parts:
        out.append(flat[o:o + a.size].view(a.shape))
        o += a.size
    return out


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

