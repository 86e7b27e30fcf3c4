"""Single-rounding fused multiply-add for the plain float32 versions.

The reference's XLA programs contract ``c + a*b`` into one FMA at a few
places, and the CUDA kernels write ``__fmaf_rn`` there.  The plain
versions emulate it: the product of two float32 values is exact in
float64, so ``a*b + c`` is formed in float64 and rounded once to float32.
(The float64 sum itself rounds, so in rare cases the emulation can differ
from a true FMA by double rounding; the parity tests would show it.)
"""
from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` with the product unrounded."""
    return (a.double() * b.double() + c.double()).float()
