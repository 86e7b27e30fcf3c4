"""PyTorch/CUDA port of the D-SPACE4Cloud planner.

Mirrors the layout of the JAX reference package (``core/``, ``kernels/``,
``obs/``) and imports none of it.  Every entry point takes a ``device``:
by default the current CUDA device, and it raises when there is none;
``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``.  Raises rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
