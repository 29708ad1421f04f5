"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA
    device.  Raises ``RuntimeError`` for None when PyTorch sees no CUDA
    device: the port runs on the card unless the caller asks for the CPU
    (``device="cpu"``), and it never falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU by default; "
                               "pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
