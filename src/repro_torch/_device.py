"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The torch device an entry point runs on.  A CUDA device without a
    card raises — entry points never carry on on the CPU unless asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return dev
