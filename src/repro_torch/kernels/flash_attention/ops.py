"""Wrapper of the flash-attention forward.

A CUDA tensor launches the hand-written kernel ``csrc/flash_attention.cu``
(the counterpart of the reference's ``flash_attention_fwd``/``_fa_kernel``):
bfloat16 takes its wgmma route, whose tiles TMA loads, float32 its SIMT
route.  A CPU tensor takes the plain version in ``ref.py``.  The inputs
keep the reference's (B,S,H,Dh)/(B,S,KV,Dh) layout: the kernel reads them
through their strides, so no transposed copy is made.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

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
    if q.dtype not in _DTYPES:
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
    """The bfloat16 kernel loads its tiles with TMA, which needs a
    16-byte-aligned base and byte strides that are multiples of 16."""
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError("flash_attention's bfloat16 kernel needs a "
                             "16-byte-aligned base (TMA)")
        if any(st % 8 for st in _strides(x)):
            raise ValueError(f"flash_attention's bfloat16 kernel needs "
                             f"strides that are multiples of 16 bytes "
                             f"(TMA), not {x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention of q (B,S,H,Dh) over k/v (B,S,KV,Dh), causal
    and/or within a sliding ``window``; (B,S,H,Dh) in q's dtype."""
    window = int(window)
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {dev}")
    B, S, H, Dh = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], Dh, *strides, int(bool(causal)), window,
            _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention")
    build.count(flash_attention)
    return out


flash_attention.launches = 0
