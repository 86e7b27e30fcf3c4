"""Wrapper of the Mamba2 SSD chunked scan.

A CUDA tensor launches the hand-written kernel ``csrc/ssd_scan.cu`` (the
counterpart of the reference's ``ssd_fwd``/``_ssd_kernel``) by one of two
routes, which ``route`` chooses from the inputs' dtypes, strides and
alignment alone:

- ``"wgmma"`` (``ssd_wgmma_kernel``: TMA tiles, wgmma products) when x, B_
  and C_ are bfloat16 and TMA can read them: each base 16-byte aligned and
  each (b, s, head) stride of x and (b, s) stride of B_ and C_ a multiple
  of 8 elements (16 bytes); and the head dim P is a multiple of 8, since
  y, contiguous, is written by TMA too.  dt and A may be float32 or
  bfloat16.  Every served model's prefill takes it.
- ``"f32"`` (``ssd_f32_kernel``, f32 on the CUDA cores) for everything
  else: float32 inputs, whose 1e-4 tolerance the tensor cores' bf16
  operands cannot promise at chunk 128, mixed dtypes, and any layout TMA
  cannot read.

A route never falls back to the other: a failed launch raises.  A CPU
tensor takes the plain version in ``ref.py``.

``ssd`` is differentiable where autograd records (grad enabled and an
input that requires it): ``SSD``, a ``torch.autograd.Function``, saves
the inputs, and its backward is ``ssd_bwd``, the vjp of the scan at (dy,
dstate) that the reference's ``ops._bwd`` takes through the plain scan:
on CUDA tensors the hand-written kernels of ``csrc/ssd_scan_bwd.cu``
(one entry point, six kernels, float32 on the CUDA cores, every sum in a
fixed order: two calls agree bit for bit), on CPU tensors
``ref.ssd_bwd``.  A failed launch raises; nothing falls back to the
plain version on the card.  The semantics are ``ssd_fwd``'s: the chunk
is clamped to ``min(chunk, S)`` and S must be a multiple of the clamped
chunk (the reference's backward does not clamp: its vjp raises where S
is under the chunk).  The inputs keep the reference's layouts and are
read through their strides (the last axis of x, B_ and C_ must be
contiguous), so no transposed copy is made.  ``ssd.launches`` counts
forward launches, ``ssd.routes`` the launches of each route, and
``ssd_bwd.launches`` backward launches.
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
ROUTES = {"f32": 0, "wgmma": 1}


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


def _strides(t, axes):
    """The element strides of ``t``'s first ``axes`` axes; an axis of size
    1 never multiplies a nonzero index, so it gets its contiguous stride,
    whatever torch reports for it."""
    natural = [1] * t.dim()
    for i in range(t.dim() - 2, -1, -1):
        natural[i] = natural[i + 1] * t.shape[i + 1]
    return [st if size > 1 else nat for st, size, nat in
            zip(t.stride()[:axes], t.shape[:axes], natural[:axes])]


def route(x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor) -> str:
    """The kernel a CUDA launch of these inputs takes: ``"wgmma"`` when x,
    B_ and C_ are bfloat16 with 16-byte-aligned bases and strides that are
    multiples of 8 elements (what TMA can read) and the head dim is a
    multiple of 8 (y, contiguous, is written by TMA too), else ``"f32"``.
    A pure function of dtypes, shapes, strides and base addresses (dt and
    A do not enter: the kernel reads them with plain loads)."""
    tensors = ((x, 3), (B_, 2), (C_, 2))
    if x.shape[-1] % 8 or any(t.dtype != torch.bfloat16
                              for t, _ in tensors):
        return "f32"
    for t, axes in tensors:
        if t.data_ptr() % 16 or any(st % 8 for st in _strides(t, axes)):
            return "f32"
    return "wgmma"


def launch(x, dt, A, B_, C_, chunk: int, route_: str):
    """Launch the kernel of ``route_`` on checked CUDA tensors (``chunk``
    already clamped); the (y, state) it writes.  ``ssd`` calls it with
    ``route(x, B_, C_)``; the card's checks call it directly to time the
    float32 route on bfloat16 inputs.  A route the inputs do not allow
    raises."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    dev = x.device
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state.zero_()
    strides = [*_strides(x, 3), *dt.stride(), A.stride(0),
               *_strides(B_, 2), *_strides(C_, 2)]
    dtypes = [_DTYPES[t.dtype] for t in (x, dt, A, B_)]
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), y.data_ptr(), state.data_ptr(), Bb, S, H, P, N,
            chunk, *strides, *dtypes, ROUTES[route_], stream)
    build.check(rc, f"ssd_scan ({route_} route)")
    return y, state


def _forward(x, dt, A, B_, C_, chunk):
    """(y, state) of checked inputs: the kernel on CUDA, the plain version
    on the CPU."""
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, B_, C_, chunk)
    way = route(x, B_, C_)
    y, state = launch(x, dt, A, B_, C_, chunk, way)
    if y.numel():
        build.count(ssd, way)
    return y, state


def _check_cotangents(x, B_, dy, dstate) -> None:
    """Raise on cotangents that do not match the scan's outputs."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    for name, t, shape in (("dy", dy, (Bb, S, H, P)),
                           ("dstate", dstate, (Bb, H, P, N))):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a tensor of shape {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} must lie on x's device")
        if t.dtype not in _DTYPES:
            raise ValueError(f"ssd_bwd takes float32 or bfloat16; {name} is "
                             f"{t.dtype}")


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
            dstate: torch.Tensor, chunk: int = 128):
    """The vjp of ``ssd`` at (dy (B,S,H,P), dstate (B,H,P,N)): (dx, ddt,
    dA, dB, dC) in the dtypes of x, dt, A, B_ and C_.  CPU tensors take
    ``ref.ssd_bwd``; CUDA tensors launch the kernels, their outputs
    contiguous, with float32 scratch allocated here and freed on return
    (each chunk's entering state and its cotangent, per-head partials of
    dB and dC, a few rows: about 620 MB at mamba2-780m's training
    shape)."""
    chunk = _check(x, dt, A, B_, C_, chunk)
    _check_cotangents(x, B_, dy, dstate)
    if x.device.type == "cpu":
        return ref.ssd_bwd(x, dt, A, B_, C_, dy, dstate, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_bwd kernel for device {x.device}")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    nc = S // chunk
    dev, f32 = x.device, torch.float32
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    dstate = dstate.to(f32).contiguous()
    dx = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bb, S, H), dtype=dt.dtype, device=dev)
    dA = torch.empty((H,), dtype=A.dtype, device=dev)
    dB = torch.empty((Bb, S, N), dtype=B_.dtype, device=dev)
    dC = torch.empty((Bb, S, N), dtype=C_.dtype, device=dev)
    if dx.numel() == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_()
    states = torch.empty((Bb, H, nc + 1, P, N), dtype=f32, device=dev)
    dstates = torch.empty((Bb, H, nc, P, N), dtype=f32, device=dev)
    rows = torch.empty((4, Bb, H, S), dtype=f32, device=dev)
    chunks = torch.empty((2, Bb, H, nc), dtype=f32, device=dev)
    dBp = torch.empty((Bb, H, S, N), dtype=f32, device=dev)
    dCp = torch.empty_like(dBp)
    strides = [*_strides(x, 3), *dt.stride(), A.stride(0), *_strides(B_, 2),
               *_strides(C_, 2), *_strides(dy, 3)]
    dtypes = [_DTYPES[t.dtype] for t in (x, dt, A, B_, dy)]
    ptrs = [t.data_ptr() for t in (x, dt, A, B_, C_, dy, dstate, dx, ddt, dA,
                                   dB, dC, states, dstates, rows, chunks,
                                   dBp, dCp)]
    rc = build.launch(dev, build.library().ssd_bwd_launch, *ptrs, Bb, S, H,
                      P, N, chunk, *strides, *dtypes)
    build.check(rc, "ssd_bwd")
    build.count(ssd_bwd)
    return dx, ddt, dA, dB, dC


class SSD(torch.autograd.Function):
    """The scan with the reference's backward: the forward saves its
    inputs, the backward is ``ssd_bwd`` at (dy, dstate) (the kernels on
    the card, the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk):
        ctx.save_for_backward(x, dt, A, B_, C_)
        ctx.chunk = chunk
        return _forward(x, dt, A, B_, C_, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = ssd_bwd(*ctx.saved_tensors, dy, dstate, ctx.chunk)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad)), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B_: torch.Tensor, C_: torch.Tensor, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); B_/C_: (B,S,N).  Returns
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) float32);
    differentiable through ``SSD`` where autograd records."""
    chunk = _check(x, dt, A, B_, C_, chunk)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ssd kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B_, C_)):
        return SSD.apply(x, dt, A, B_, C_, chunk)
    return _forward(x, dt, A, B_, C_, chunk)


ssd.launches = 0
ssd.routes = dict.fromkeys(ROUTES, 0)
ssd_bwd.launches = 0
