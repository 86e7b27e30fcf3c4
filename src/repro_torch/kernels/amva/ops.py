"""Wrapper of the batched processor-sharing fixed point.

A CUDA tensor launches the hand-written kernel ``csrc/amva.cu`` (the
counterpart of the reference's ``amva_fwd``/``_ps_kernel``); a CPU tensor
takes the plain version in ``ref.py``.  ``ps_fixed_point.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.mva import PS_ITERS
from repro_torch.kernels import build
from repro_torch.kernels.amva import ref


def _check(args):
    a = args[0]
    for x in args:
        if not isinstance(x, torch.Tensor):
            raise TypeError("ps_fixed_point takes tensors")
        if x.dtype != torch.float32 or x.dim() != 1 \
                or x.shape != a.shape or x.device != a.device:
            raise ValueError("ps_fixed_point takes four float32 (N,) "
                             "tensors on one device")


def ps_fixed_point(a_over_c: torch.Tensor, b: torch.Tensor,
                   think: torch.Tensor, h_users: torch.Tensor,
                   iters: int = PS_ITERS) -> torch.Tensor:
    """PS fixed point ``T <- a*max(1, h*T/(T+z)) + b`` from ``T0 = a + b``,
    ``iters`` rounds, per element of four float32 ``(N,)`` tensors."""
    args = (a_over_c, b, think, h_users)
    _check(args)
    dev = a_over_c.device
    if dev.type == "cpu":
        return ref.ps_fixed_point(*args, iters=iters)
    if dev.type != "cuda":
        raise ValueError(f"no amva kernel for device {dev}")
    args = tuple(x.contiguous() for x in args)
    out = torch.empty_like(args[0])
    n = out.numel()
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.amva_ps_launch(*(x.data_ptr() for x in args),
                                out.data_ptr(), n, int(iters), stream)
    build.check(rc, "amva")
    ps_fixed_point.launches += 1
    return out


ps_fixed_point.launches = 0
