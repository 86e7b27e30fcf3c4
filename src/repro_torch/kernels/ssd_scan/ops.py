"""Wrapper of the Mamba2 SSD chunked scan.

A CUDA tensor launches the hand-written kernel ``csrc/ssd_scan.cu`` (the
counterpart of the reference's ``ssd_fwd``/``_ssd_kernel``); a CPU tensor
takes the plain version in ``ref.py``.  The semantics are ``ssd_fwd``'s:
the chunk is clamped to ``min(chunk, S)`` and S must be a multiple of the
clamped chunk.  The inputs keep the reference's layouts and are read
through their strides (the last axis of x, B_ and C_ must be contiguous),
so no transposed copy is made.  ``ssd.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

MAX_CHUNK = 128          # the kernel's shared-memory plan: Q, P, N <= 128
MAX_HEAD_DIM = 128
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, A, B_, C_, chunk) -> int:
    """Raise on input the scan does not take; the clamped chunk."""
    named = (("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("B_", B_, 3),
             ("C_", C_, 3))
    for name, t, ndim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ssd takes tensors; {name} is {type(t)}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} axes, not {t.dim()}")
        if t.device != x.device:
            raise ValueError("x, dt, A, B_ and C_ must share one device")
        if t.dtype not in _DTYPES:
            raise ValueError(f"ssd takes float32 or bfloat16; {name} is "
                             f"{t.dtype}")
    if B_.dtype != C_.dtype:
        raise ValueError("B_ and C_ must share one dtype")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) or \
            tuple(B_.shape) != (Bb, S, N) or C_.shape != B_.shape:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B_ {tuple(B_.shape)}, C_ {tuple(C_.shape)} "
            "do not match (B,S,H,P), (B,S,H), (H,), (B,S,N), (B,S,N)")
    if not 0 < P <= MAX_HEAD_DIM or not 0 < N <= MAX_STATE:
        raise ValueError(f"head dim {P} and state size {N} must be in "
                         f"[1, {MAX_HEAD_DIM}]")
    for name, t in (("x", x), ("B_", B_), ("C_", C_)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"the last axis of {name} must be contiguous")
    if S < 1:
        raise ValueError("ssd takes a sequence of at least one step")
    chunk = min(int(chunk), S)
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} is not in [1, {MAX_CHUNK}]")
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    return chunk


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B_: torch.Tensor, C_: torch.Tensor, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B_/C_: (B,S,N).  Returns
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) float32)."""
    chunk = _check(x, dt, A, B_, C_, chunk)
    dev = x.device
    if dev.type == "cpu":
        return ref.ssd(x, dt, A, B_, C_, chunk)
    if dev.type != "cuda":
        raise ValueError(f"no ssd kernel for device {dev}")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state.zero_()
    strides = [*x.stride()[:3], *dt.stride(), A.stride(0),
               *B_.stride()[:2], *C_.stride()[:2]]
    dtypes = [_DTYPES[t.dtype] for t in (x, dt, A, B_)]
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), y.data_ptr(), state.data_ptr(), Bb, S, H, P, N,
            chunk, *strides, *dtypes, stream)
    build.check(rc, "ssd_scan")
    build.count(ssd)
    return y, state


ssd.launches = 0
