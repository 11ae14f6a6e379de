"""The port's one rule for devices: run on the card unless the caller asks
for the CPU. A missing card is an error, never a silent CPU run."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
