"""Wrappers of the flash-attention kernels, forward and backward.

A CUDA tensor launches the hand-written kernels: the forward
``csrc/flash_attention.cu`` (the counterpart of the reference's
``flash_attention_fwd``/``_fa_kernel``), bfloat16 by its wgmma route,
whose tiles TMA loads, float32 by its SIMT route; the backward
``csrc/flash_attention_bwd.cu`` (the counterpart of the reference's
``jnp_impl._bwd_vjp``), three kernels: ``fa_bwd_delta``, ``fa_bwd_dkdv``
and ``fa_bwd_dq``.  A CPU tensor takes the plain versions in ``ref.py``.
The inputs keep the reference's (B,S,H,Dh)/(B,S,KV,Dh) layout: the
kernels read them through their strides, so no transposed copy is made.

``flash_attention`` is differentiable: where autograd records (grad
enabled and an input that requires it), it runs ``FlashAttention``, a
``torch.autograd.Function`` that, as the reference's custom VJP does,
saves (q, k, v, out, lse) in its forward and runs the backward from them.
Otherwise (serving) it runs the forward alone, without lse.  Each
wrapper's ``launches`` counts its kernel's launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, window):
    for x in (q, k, v):
        if not isinstance(x, torch.Tensor):
            raise TypeError("flash_attention takes tensors")
        if x.dim() != 4:
            raise ValueError("flash_attention takes q (B,S,H,Dh) and k/v "
                             "(B,S,KV,Dh)")
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError("q, k and v must share one device and dtype")
        if x.stride(-1) != 1:
            raise ValueError("the head dimension must be contiguous")
    # float64 only on the CPU: the plain versions' autograd checks
    if q.dtype not in _DTYPES and not (q.dtype == torch.float64
                                       and q.device.type == "cpu"):
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    B, S, H, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != Dh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} q heads do not split over {KV} kv heads")
    if Dh % 8 or not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} is not a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if q.is_cuda and q.dtype == torch.bfloat16:
        _check_tma(q, k, v)


def _strides(x):
    """(b, s, head) element strides of a (B,S,n,Dh) tensor.  A dim of
    size 1 never multiplies a nonzero index, so it gets its contiguous
    stride, whatever torch reports for it."""
    _, S, n, Dh = x.shape
    natural = (S * n * Dh, n * Dh, Dh)
    return [st if size > 1 else nat
            for st, size, nat in zip(x.stride()[:3], x.shape[:3], natural)]


def _check_tma(*tensors):
    """The bfloat16 forward kernel loads its tiles with TMA, which needs a
    16-byte-aligned base and byte strides that are multiples of 16."""
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError("flash_attention's bfloat16 kernel needs a "
                             "16-byte-aligned base (TMA)")
        if any(st % 8 for st in _strides(x)):
            raise ValueError(f"flash_attention's bfloat16 kernel needs "
                             f"strides that are multiples of 16 bytes "
                             f"(TMA), not {x.stride()}")


def _forward(q, k, v, causal, window, want_lse):
    """(out, lse or None) of checked inputs: the kernel on CUDA, the plain
    version on the CPU."""
    if q.device.type == "cpu":
        out, lse = ref.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
        return out, (lse if want_lse else None)
    B, S, H, Dh = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        return out, lse
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    rc = build.launch(
        q.device, build.library().flash_attention_launch, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if want_lse else None, B, S, H, k.shape[2], Dh,
        *strides, int(bool(causal)), window, _DTYPES[q.dtype])
    build.check(rc, "flash_attention")
    build.count(flash_attention)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,S,H,Dh) in q's dtype, lse (B,H,S) float32): the forward
    with each row's log-sum-exp, as the backward reads it."""
    window = int(window)
    _check(q, k, v, window)
    return _forward(q, k, v, causal, window, want_lse=True)


def fa_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Launch ``fa_bwd_delta_kernel``: rowsum(dout * out), (B,H,S) float32,
    on checked CUDA tensors."""
    B, S, H, Dh = out.shape
    delta = torch.empty((B, H, S), dtype=torch.float32, device=out.device)
    rc = build.launch(out.device, build.library().fa_bwd_delta_launch,
                      out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, S,
                      H, Dh, *_strides(out), *_strides(dout),
                      _DTYPES[out.dtype])
    build.check(rc, "fa_bwd_delta")
    build.count(fa_bwd_delta)
    return delta


def fa_bwd_dkdv(q, k, v, dout, lse, delta, causal: bool, window: int):
    """Launch ``fa_bwd_dkdv_kernel``: (dk, dv) (B,S,KV,Dh) on checked CUDA
    tensors."""
    B, S, H, Dh = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = [s for x in (q, k, v, dout, dk, dv) for s in _strides(x)]
    rc = build.launch(q.device, build.library().fa_bwd_dkdv_launch,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], Dh,
                      *strides, int(bool(causal)), window, _DTYPES[q.dtype])
    build.check(rc, "fa_bwd_dkdv")
    build.count(fa_bwd_dkdv)
    return dk, dv


def fa_bwd_dq(q, k, v, dout, lse, delta, causal: bool, window: int):
    """Launch ``fa_bwd_dq_kernel``: dq (B,S,H,Dh) on checked CUDA
    tensors."""
    B, S, H, Dh = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, dout, dq) for s in _strides(x)]
    rc = build.launch(q.device, build.library().fa_bwd_dq_launch,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), B, S, H, k.shape[2], Dh, *strides,
                      int(bool(causal)), window, _DTYPES[q.dtype])
    build.check(rc, "fa_bwd_dq")
    build.count(fa_bwd_dq)
    return dq


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs, ``out`` and ``lse`` (B,H,S)
    and the output's gradient ``dout``: the three backward kernels on
    CUDA tensors, the plain version on CPU tensors."""
    window = int(window)
    _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} and lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if any(x.device != q.device for x in (out, lse, dout)):
        raise ValueError("out, lse and dout must be on q's device")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                       causal=causal, window=window)
    out, dout = (x.to(q.dtype) for x in (out, dout))
    if out.stride(-1) != 1:
        out = out.contiguous()
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    lse = lse.float().contiguous()
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = fa_bwd_delta(out, dout)
    dk, dv = fa_bwd_dkdv(q, k, v, dout, lse, delta, causal, window)
    dq = fa_bwd_dq(q, k, v, dout, lse, delta, causal, window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward saves (q, k, v, out,
    lse), as the reference's ``ops._fwd`` does, and the backward runs
    ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention of q (B,S,H,Dh) over k/v (B,S,KV,Dh), causal
    and/or within a sliding ``window``; (B,S,H,Dh) in q's dtype.
    Differentiable through ``FlashAttention`` where autograd records."""
    window = int(window)
    _check(q, k, v, window)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal), window)
    return _forward(q, k, v, causal, window, want_lse=False)[0]


flash_attention.launches = 0
fa_bwd_delta.launches = 0
fa_bwd_dkdv.launches = 0
fa_bwd_dq.launches = 0
