"""Where an entry point computes.

The port's entry points run on the card unless the caller asks for
``device="cpu"``; with no card, the default raises rather than falling
back to the CPU. Below the entry points every function follows its
input tensors.
"""

from __future__ import annotations

import torch


def on_device(x, device) -> torch.Tensor:
    """``x`` (tensor or array) as a tensor on ``device``; a CUDA device
    with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless given device='cpu'"
        )
    return torch.as_tensor(x).to(device)
