"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the host: ``device=None``
means CUDA, and a missing card is an error, never a silent CPU fallback. The
tests pass ``device="cpu"`` explicitly to run the plain PyTorch versions."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vtpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
