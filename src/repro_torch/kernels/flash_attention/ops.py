"""Wrappers of the flash-attention kernels, forward and backward.

A CUDA tensor launches the hand-written kernels.  The forward (the
counterpart of the reference's ``flash_attention_fwd``/``_fa_kernel``)
takes one of two routes, which ``fwd_route`` chooses from dtype and head
dim: ``"wgmma"``, on Hopper's wgmma and TMA, where bfloat16 launches
``fa_wgmma_kernel`` (``csrc/flash_attention.cu``) and float32 at Dh <=
128 launches ``fa_fwd_split`` (the inputs as three bf16 parts each)
then ``fa_fwd_parts_kernel`` (``csrc/flash_attention_fwd_parts.cu``);
``"simt"`` (float32 at Dh in (128, 256]) launches ``fa_f32_kernel`` on
the CUDA cores, which ``flash_attention_simt`` runs at any float32 head
dim, to hold the two routes against each other.  The backward ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_bwd_parts.cuh`` (the counterparts of the
reference's ``jnp_impl._bwd_vjp``) takes one of two routes, which
``bwd_route`` chooses from dtype and head dim: ``"wgmma"`` (bfloat16 at
Dh <= 256, float32 at Dh <= 128) on wgmma and TMA, where bfloat16 at Dh
<= 128 launches the pair ``fa_bwd_dq_wgmma``, which also writes delta,
then ``fa_bwd_dkdv_wgmma``, and the rest the parts kernels
``fa_bwd_prep`` (delta, and float32's operands as three bf16 parts
each), ``fa_bwd_dq_parts`` and ``fa_bwd_dkdv_parts``; ``"simt"``
(float32 at Dh in (128, 256]) launches ``fa_bwd_delta``, ``fa_bwd_dkdv``
and ``fa_bwd_dq`` on the CUDA cores.  No route gives way to another: a
build or launch that fails raises.  A CPU tensor takes the plain
versions in ``ref.py``.  The inputs keep the reference's
(B,S,H,Dh)/(B,S,KV,Dh) layout: the kernels read them through their
strides, so no transposed copy is made.

``flash_attention`` is differentiable: where autograd records (grad
enabled and an input that requires it), it runs ``FlashAttention``, a
``torch.autograd.Function`` that, as the reference's custom VJP does,
saves (q, k, v, out, lse) in its forward and runs the backward from them.
Otherwise (serving) it runs the forward alone, without lse.  Each
wrapper's ``launches`` counts its kernel's launches;
``flash_attention.launches`` counts forwards on any route and
``flash_attention.routes`` each forward kernel's (``FWD_KERNELS``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

MAX_HEAD_DIM = 256
# the float32 wgmma forward's head-dim limit: three bf16 parts of a Q
# tile and a K/V ring fit shared memory up to 128
MAX_F32_WGMMA_FWD_HEAD_DIM = 128
FWD_ROUTES = ("wgmma", "simt")
# the forward's kernels, counted in flash_attention.routes: bfloat16's,
# the float32 wgmma route's (after fa_fwd_split), the simt route's
FWD_KERNELS = ("fa_wgmma_kernel", "fa_fwd_parts_kernel", "fa_f32_kernel")
# the wgmma backward's head-dim limits: bfloat16, float32 (the parts
# kernels' float32 tiles, three bf16 parts an operand, fit shared memory
# up to 128), and the bfloat16 pair's
MAX_WGMMA_BWD_HEAD_DIM = 256
MAX_F32_WGMMA_BWD_HEAD_DIM = 128
MAX_PAIR_HEAD_DIM = 128
ROWS_TILE = 64            # the wgmma dkdv kernel's q rows a ring tile
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


def fwd_route(q: torch.Tensor) -> str:
    """The forward kernels a CUDA launch of q takes: ``"wgmma"`` for
    bfloat16 (``fa_wgmma_kernel``) and for float32 with a head dim of at
    most 128 (``fa_fwd_split``, then ``fa_fwd_parts_kernel``: three bf16
    parts an operand; TMA pads the head dim to a multiple of 64),
    ``"simt"`` (``fa_f32_kernel``) for float32 at head dims in (128,
    256].  A pure function of dtype and head dim."""
    if q.dtype == torch.bfloat16 or (
            q.dtype == torch.float32
            and q.shape[-1] <= MAX_F32_WGMMA_FWD_HEAD_DIM):
        return "wgmma"
    return "simt"


def fwd_kernel(q: torch.Tensor, route=None) -> str:
    """The forward kernel (of ``FWD_KERNELS``) a CUDA launch of q on
    ``route`` (None: ``fwd_route(q)``) runs; raises for a route q cannot
    take (bfloat16 has no simt kernel; float32 past head dim 128 no
    wgmma one)."""
    want = fwd_route(q)
    if route is None:
        route = want
    if route not in FWD_ROUTES:
        raise ValueError(f"no forward route {route!r}: {FWD_ROUTES}")
    if route == "wgmma" and want == "simt":
        raise ValueError(f"the float32 wgmma forward takes a head dim of "
                         f"at most {MAX_F32_WGMMA_FWD_HEAD_DIM}, not "
                         f"{q.shape[-1]}")
    if q.dtype == torch.bfloat16:
        if route == "simt":
            raise ValueError("bfloat16 has no simt forward kernel")
        return FWD_KERNELS[0]
    return FWD_KERNELS[1] if route == "wgmma" else FWD_KERNELS[2]


def fa_fwd_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 wgmma route's split pass on checked float32 tensors at
    a head dim of at most 128: the parts (``parts_shape``, bf16 hi, mid
    and lo, their sum the value exactly, zeros past Dh) of q, k and v,
    contiguous, what ``fa_fwd_parts_kernel``'s TMA maps read.  A CUDA
    tensor launches ``fa_fwd_split_kernel``; a CPU tensor takes
    ``ref.split_parts``."""
    if q.dtype != torch.float32 or fwd_route(q) != "wgmma":
        raise ValueError(f"the split takes float32 with a head dim of at "
                         f"most {MAX_F32_WGMMA_FWD_HEAD_DIM}, not "
                         f"{q.dtype} at {q.shape[-1]}")
    if q.device.type == "cpu":
        return tuple(ref.split_parts(x) for x in (q, k, v))
    B, S, H, Dh = q.shape
    parts = tuple(torch.empty(parts_shape(x), dtype=torch.bfloat16,
                              device=q.device) for x in (q, k, v))
    rc = build.launch(q.device, build.library().fa_fwd_split_launch,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      *(x.data_ptr() for x in parts), B, S, H, k.shape[2],
                      Dh, *_strides(q), *_strides(k), *_strides(v))
    build.check(rc, "fa_fwd_split")
    build.count(fa_fwd_split)
    return parts


def _outputs(q, want_lse):
    B, S, H, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    return out, lse


def fa_fwd_parts(q, k, parts, causal: bool, window: int, want_lse: bool):
    """Launch ``fa_fwd_parts_kernel`` (the float32 wgmma route's second
    kernel) on the parts ``fa_fwd_split`` returned for checked float32
    CUDA tensors q, k: (out (B,S,H,Dh) float32, lse (B,H,S) or None).
    Counted in ``flash_attention``'s launches and routes."""
    if fwd_kernel(q) != "fa_fwd_parts_kernel":
        raise ValueError(f"fa_fwd_parts_kernel takes float32 with a head "
                         f"dim of at most {MAX_F32_WGMMA_FWD_HEAD_DIM}, "
                         f"not {q.dtype} at {q.shape[-1]}")
    if tuple(p.shape for p in parts) != (parts_shape(q), parts_shape(k),
                                         parts_shape(k)) or any(
            p.dtype != torch.bfloat16 or not p.is_contiguous()
            or p.data_ptr() % 16 or p.device != q.device for p in parts):
        raise ValueError("fa_fwd_parts_kernel reads the parts fa_fwd_split "
                         "writes")
    B, S, H, Dh = q.shape
    out, lse = _outputs(q, want_lse)
    rc = build.launch(
        q.device, build.library().fa_fwd_parts_launch,
        *(p.data_ptr() for p in parts), out.data_ptr(),
        lse.data_ptr() if want_lse else None, B, S, H, k.shape[2], Dh,
        *_strides(out), int(bool(causal)), window)
    build.check(rc, "fa_fwd_parts_kernel")
    build.count(flash_attention, "fa_fwd_parts_kernel")
    return out, lse


def _forward(q, k, v, causal, window, want_lse, route=None):
    """(out, lse or None) of checked inputs: the kernels of ``route``
    (None: ``fwd_route(q)``) on CUDA, the plain version on the CPU."""
    kernel = fwd_kernel(q, route)
    if q.device.type == "cpu":
        out, lse = ref.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
        return out, (lse if want_lse else None)
    if q.numel() == 0:
        return _outputs(q, want_lse)
    if kernel == "fa_fwd_parts_kernel":
        return fa_fwd_parts(q, k, fa_fwd_split(q, k, v), causal, window,
                            want_lse)
    B, S, H, Dh = q.shape
    out, lse = _outputs(q, want_lse)
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    rc = build.launch(
        q.device, build.library().flash_attention_launch, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if want_lse else None, B, S, H, k.shape[2], Dh,
        *strides, int(bool(causal)), window, _DTYPES[q.dtype])
    build.check(rc, kernel)
    build.count(flash_attention, kernel)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,S,H,Dh) in q's dtype, lse (B,H,S) float32): the forward
    with each row's log-sum-exp, as the backward reads it."""
    window = int(window)
    _check(q, k, v, window)
    return _forward(q, k, v, causal, window, want_lse=True)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """The float32 forward on the simt route (``fa_f32_kernel``) at any
    head dim, also where ``fwd_route`` takes wgmma: to hold or time the
    two routes against each other.  Not differentiable; bfloat16 raises
    (no simt kernel)."""
    window = int(window)
    _check(q, k, v, window)
    return _forward(q, k, v, causal, window, want_lse=False,
                    route="simt")[0]


def fa_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Launch ``fa_bwd_delta_kernel`` (the simt route's): rowsum(dout *
    out), (B,H,S) float32, on checked CUDA tensors."""
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
    """Launch ``fa_bwd_dkdv_kernel`` (the simt route's): (dk, dv)
    (B,S,KV,Dh) on checked CUDA tensors."""
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
    """Launch ``fa_bwd_dq_kernel`` (the simt route's): dq (B,S,H,Dh) on
    checked CUDA tensors."""
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


def _tma_ready(x):
    """``x``, or a contiguous copy where TMA cannot read it (a base not
    16-byte aligned, or a stride not a multiple of 16 bytes): a copy of
    the layout, not a fallback."""
    if x.data_ptr() % 16 == 0 and x.stride(-1) == 1 and \
            not any(st % 8 for st in _strides(x)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward kernels a CUDA launch of these inputs takes:
    ``"wgmma"`` for bfloat16 with a head dim of at most 256 and for
    float32 with one of at most 128 (TMA's zero fill pads it to a
    multiple of 64), ``"simt"`` for float32 at head dims in (128, 256].
    A pure function of dtype and shape (q, k and v share both; the
    bfloat16 inputs already satisfy ``_check_tma``)."""
    Dh = q.shape[-1]
    if (q.dtype == torch.bfloat16 and Dh <= MAX_WGMMA_BWD_HEAD_DIM) or (
            q.dtype == torch.float32 and Dh <= MAX_F32_WGMMA_BWD_HEAD_DIM):
        return "wgmma"
    return "simt"


def wgmma_kernels(q) -> str:
    """Which kernels the wgmma route launches for q: ``"pair"``
    (bfloat16 at Dh <= 128: ``fa_bwd_dq_wgmma``, ``fa_bwd_dkdv_wgmma``)
    or ``"parts"`` (``fa_bwd_prep``, ``fa_bwd_dq_parts``,
    ``fa_bwd_dkdv_parts``)."""
    if q.dtype == torch.bfloat16 and q.shape[-1] <= MAX_PAIR_HEAD_DIM:
        return "pair"
    return "parts"


def bwd_kernels(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels a CUDA launch at this dtype and head dim takes:
    ``"pair"`` or ``"parts"`` (the wgmma route, as ``wgmma_kernels``) or
    ``"simt"``, for a caller that holds a config rather than tensors."""
    q = torch.empty((0, head_dim), dtype=dtype, device="meta")
    return wgmma_kernels(q) if bwd_route(q, q, q) == "wgmma" else "simt"


def _check_wgmma(q):
    if q.dtype != torch.bfloat16 or q.shape[-1] > MAX_PAIR_HEAD_DIM:
        raise ValueError(f"the wgmma pair takes bfloat16 with a head dim "
                         f"of at most {MAX_PAIR_HEAD_DIM}, not {q.dtype} at "
                         f"{q.shape[-1]}")


def _check_parts(q):
    if bwd_route(q, q, q) != "wgmma" or wgmma_kernels(q) != "parts":
        raise ValueError(f"the parts kernels take bfloat16 with a head dim "
                         f"in ({MAX_PAIR_HEAD_DIM}, {MAX_WGMMA_BWD_HEAD_DIM}] "
                         f"or float32 with one of at most "
                         f"{MAX_F32_WGMMA_BWD_HEAD_DIM}, not {q.dtype} at "
                         f"{q.shape[-1]}")


def rows_shape(q) -> Tuple[int, int, int, int]:
    """The wgmma route's rows buffer for q (B,S,H,Dh): (B, H, S_pad, 2)
    float32, S_pad = S rounded up to a multiple of 64 (the dkdv kernel
    fetches a 64-row tile's 512 bytes in one bulk copy), which the pair's
    dq pass or ``fa_bwd_prep`` fills with each row's (lse * log2(e),
    delta), zeros past S."""
    B, S, H, _ = q.shape
    return (B, H, -(-S // ROWS_TILE) * ROWS_TILE, 2)


def rows_delta(rows: torch.Tensor, S: int) -> torch.Tensor:
    """delta (B,H,S) = rowsum(dout * out), a view of the rows buffer the
    pair's dq pass or ``fa_bwd_prep`` wrote."""
    return rows[:, :, :S, 1]


def fa_bwd_dq_wgmma(q, k, v, out, dout, lse, causal: bool, window: int):
    """Launch ``fa_bwd_dq_wgmma_kernel`` (the wgmma route's first kernel)
    on checked bfloat16 CUDA tensors that TMA can read, Dh <= 128: (dq
    (B,S,H,Dh), the rows buffer (``rows_shape``) with each q row's (lse *
    log2(e), delta = rowsum(dout * out)), which ``fa_bwd_dkdv_wgmma``
    reads)."""
    _check_wgmma(q)
    B, S, H, Dh = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rows = torch.empty(rows_shape(q), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v, out, dout, dq) for s in _strides(x)]
    rc = build.launch(q.device, build.library().fa_bwd_dq_wgmma_launch,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      rows.data_ptr(), dq.data_ptr(), B, S, H, k.shape[2],
                      Dh, *strides, int(bool(causal)), window,
                      _DTYPES[q.dtype])
    build.check(rc, "fa_bwd_dq_wgmma")
    build.count(fa_bwd_dq_wgmma)
    return dq, rows


def fa_bwd_dkdv_wgmma(q, k, v, dout, rows, causal: bool, window: int):
    """Launch ``fa_bwd_dkdv_wgmma_kernel`` (the wgmma route's second
    kernel) on the inputs of ``fa_bwd_dq_wgmma`` and the rows buffer it
    returned: (dk, dv) (B,S,KV,Dh)."""
    _check_wgmma(q)
    _check_rows(q, rows, "the wgmma dkdv kernel")
    B, S, H, Dh = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = [s for x in (q, k, v, dout, dk, dv) for s in _strides(x)]
    rc = build.launch(q.device, build.library().fa_bwd_dkdv_wgmma_launch,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      dout.data_ptr(), rows.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), B, S, H, k.shape[2], Dh, *strides,
                      int(bool(causal)), window, _DTYPES[q.dtype])
    build.check(rc, "fa_bwd_dkdv_wgmma")
    build.count(fa_bwd_dkdv_wgmma)
    return dk, dv


def _check_rows(q, rows, who):
    if tuple(rows.shape) != rows_shape(q) or rows.dtype != torch.float32 \
            or not rows.is_contiguous() or rows.data_ptr() % 16 \
            or rows.device != q.device:
        raise ValueError(f"{who} reads the rows buffer {rows_shape(q)}, "
                         f"not {rows.dtype} {tuple(rows.shape)}")


def parts_shape(x) -> Tuple[int, int, int, int]:
    """A float32 operand's parts for the parts kernels (the backward's and
    the float32 wgmma forward's): (B, S, n, 3 DP) bfloat16, DP = Dh
    rounded up to 64, hi, mid and lo (their sum the value exactly) in [0,
    DP), [DP, 2 DP), [2 DP, 3 DP), zeros past Dh."""
    B, S, n, Dh = x.shape
    return (B, S, n, 3 * (-(-Dh // 64) * 64))


def fa_bwd_prep(q, k, v, out, dout, lse):
    """Launch ``fa_bwd_prep_kernel`` (the parts kernels' first) on checked
    CUDA tensors: (the rows buffer (``rows_shape``) with each q row's (lse
    * log2(e), delta = rowsum(dout * out)), the operands (q, k, v, dout)
    the products read: for float32 their bf16 parts (``parts_shape``), for
    bfloat16 the tensors themselves)."""
    _check_parts(q)
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    rows = torch.empty(rows_shape(q), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        operands = tuple(torch.empty(parts_shape(x), dtype=torch.bfloat16,
                                     device=q.device)
                         for x in (q, k, v, dout))
        ptrs = [x.data_ptr() for x in operands]
    else:
        operands, ptrs = (q, k, v, dout), [None] * 4
    strides = [s for x in (q, k, v, out, dout) for s in _strides(x)]
    rc = build.launch(q.device, build.library().fa_bwd_prep_launch,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      rows.data_ptr(), *ptrs, B, S, H, KV, Dh, *strides,
                      _DTYPES[q.dtype])
    build.check(rc, "fa_bwd_prep")
    build.count(fa_bwd_prep)
    return rows, operands


def fa_bwd_dq_parts(q, operands, rows, causal: bool, window: int):
    """Launch ``fa_bwd_dq_parts_kernel`` on the operands and the rows
    buffer ``fa_bwd_prep`` returned for q: dq (B,S,H,Dh) in q's dtype."""
    _check_parts(q)
    _check_rows(q, rows, "the parts dq kernel")
    B, S, H, Dh = q.shape
    qp, kp, vp, dop = operands
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [s for x in (qp, kp, vp, dop, dq) for s in _strides(x)]
    rc = build.launch(q.device, build.library().fa_bwd_dq_parts_launch,
                      qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      dop.data_ptr(), rows.data_ptr(), dq.data_ptr(), B, S,
                      H, kp.shape[2], Dh, *strides, int(bool(causal)),
                      window, _DTYPES[q.dtype])
    build.check(rc, "fa_bwd_dq_parts")
    build.count(fa_bwd_dq_parts)
    return dq


def fa_bwd_dkdv_parts(q, k, operands, rows, causal: bool, window: int):
    """Launch ``fa_bwd_dkdv_parts_kernel`` on the operands and the rows
    buffer ``fa_bwd_prep`` returned for q: (dk, dv) (B,S,KV,Dh) in k's
    dtype."""
    _check_parts(q)
    _check_rows(q, rows, "the parts dkdv kernel")
    B, S, H, Dh = q.shape
    qp, kp, vp, dop = operands
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    strides = [s for x in (qp, kp, vp, dop, dk, dv) for s in _strides(x)]
    rc = build.launch(q.device, build.library().fa_bwd_dkdv_parts_launch,
                      qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      dop.data_ptr(), rows.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), B, S, H, k.shape[2], Dh, *strides,
                      int(bool(causal)), window, _DTYPES[q.dtype])
    build.check(rc, "fa_bwd_dkdv_parts")
    build.count(fa_bwd_dkdv_parts)
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs, ``out`` and ``lse`` (B,H,S)
    and the output's gradient ``dout``: on CUDA tensors the kernels of
    ``bwd_route(q, k, v)``, on CPU tensors the plain version."""
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
    lse = lse.float().contiguous()
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if bwd_route(q, k, v) == "wgmma":
        out, dout = _tma_ready(out), _tma_ready(dout)
        if wgmma_kernels(q) == "pair":
            dq, rows = fa_bwd_dq_wgmma(q, k, v, out, dout, lse, causal,
                                       window)
            dk, dv = fa_bwd_dkdv_wgmma(q, k, v, dout, rows, causal, window)
            return dq, dk, dv
        rows, operands = fa_bwd_prep(q, k, v, out, dout, lse)
        dq = fa_bwd_dq_parts(q, operands, rows, causal, window)
        dk, dv = fa_bwd_dkdv_parts(q, k, operands, rows, causal, window)
        return dq, dk, dv
    if out.stride(-1) != 1:
        out = out.contiguous()
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
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
flash_attention.routes = dict.fromkeys(FWD_KERNELS, 0)
fa_fwd_split.launches = 0
fa_bwd_delta.launches = 0
fa_bwd_dkdv.launches = 0
fa_bwd_dq.launches = 0
fa_bwd_dq_wgmma.launches = 0
fa_bwd_dkdv_wgmma.launches = 0
fa_bwd_prep.launches = 0
fa_bwd_dq_parts.launches = 0
fa_bwd_dkdv_parts.launches = 0
