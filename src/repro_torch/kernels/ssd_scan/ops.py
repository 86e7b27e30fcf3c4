"""Wrapper of the Mamba2 SSD chunked scan.

A CUDA tensor launches hand-written kernels (the counterpart of the
reference's ``ssd_fwd``/``_ssd_kernel``) by one of two routes, which
``route`` chooses from the inputs' dtypes, strides and alignment alone
(the only chooser):

- ``"wgmma"`` (``csrc/ssd_scan.cu``, ``ssd_wgmma_kernel``: TMA tiles,
  wgmma products) when x, B_ and C_ are bfloat16 and TMA can read them:
  each base 16-byte aligned and each (b, s, head) stride of x and (b, s)
  stride of B_ and C_ a multiple of 8 elements (16 bytes); and the head
  dim P is a multiple of 8, since y, contiguous, is written by TMA too.
  dt and A may be float32 or bfloat16.  Every served model's prefill
  takes it.
- ``"parts"`` (``csrc/ssd_scan_parts.cu``) for everything else: float32
  inputs, mixed dtypes and any layout TMA cannot read.  ``ssd_split``
  writes x, B_ and C_ as three bf16 parts each (their sum the value
  exactly; through any strides), then ``ssd_parts`` runs four wgmma and
  TMA kernels on them (C B^T once per (b, chunk), each chunk's state
  term, the states' scan, y); every product six bf16 terms, within the
  float32 tolerance 1e-4.

``ssd_f32_kernel`` (float32 on the CUDA cores, the route every float32
input took before the parts kernels) has no caller on any path: only
``launch(..., "f32")`` runs it, to hold or time the two against each
other.  A route never falls back to another: a failed launch raises.  A
CPU tensor takes the plain version in ``ref.py``.

``ssd`` is differentiable where autograd records (grad enabled and an
input that requires it): ``SSD``, a ``torch.autograd.Function``, saves
the inputs, and its backward is ``ssd_bwd``, the vjp of the scan at (dy,
dstate) that the reference's ``ops._bwd`` takes through the plain scan.
On CUDA tensors it takes one of two routes of hand-written kernels, which
``bwd_route`` chooses (the only chooser):

- ``"wgmma"`` (``csrc/ssd_scan_bwd_wgmma.cu``, one entry point, five
  kernels on TMA and wgmma, the heads summed inside the accumulators)
  when the forward's ``route`` is ``"wgmma"`` and dy is bfloat16; dy
  gets a contiguous copy where TMA cannot read it (a copy of the layout,
  not a fallback).  Every training step of a bf16 model takes it.
- ``"simt"`` (``csrc/ssd_scan_bwd.cu``, one entry point, six kernels,
  float32 on the CUDA cores) for float32 inputs and any other layout.

Every sum of both routes is in a fixed order (no atomics): two calls agree
bit for bit.  On CPU tensors ``ssd_bwd`` is ``ref.ssd_bwd``.  A failed
launch raises; nothing falls back to the other route or to the plain
version on the card.  The semantics are ``ssd_fwd``'s: the chunk
is clamped to ``min(chunk, S)`` and S must be a multiple of the clamped
chunk (the reference's backward does not clamp: its vjp raises where S
is under the chunk).  The inputs keep the reference's layouts and are
read through their strides (the last axis of x, B_ and C_ must be
contiguous), so no transposed copy is made.  ``ssd.launches`` counts
forward launches, ``ssd.routes`` the launches of each route (``launch(...,
"f32")`` counts none), ``ssd_split.launches`` the split's,
``ssd_bwd.launches`` backward calls and ``ssd_bwd.routes`` those of each
backward route.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
# dy's copy where TMA cannot read it: the flash backward's, for the same
# (B, S, heads, D) layout
from repro_torch.kernels.flash_attention.ops import _tma_ready
from repro_torch.kernels.ssd_scan import ref

MAX_CHUNK = 128          # the kernels' shared-memory plans: Q, P, N <= 128
MAX_HEAD_DIM = 128
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward's routes, route()'s values, counted in ssd.routes
# (ssd_f32_kernel runs only through launch(..., "f32"), uncounted)
ROUTES = ("wgmma", "parts")
# the route index of ssd_scan_launch (csrc/ssd_scan.cu)
_LAUNCH_ROUTES = {"f32": 0, "wgmma": 1}
BWD_ROUTES = ("simt", "wgmma")


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
    """The kernels a CUDA launch of these inputs takes: ``"wgmma"`` when
    x, B_ and C_ are bfloat16 with 16-byte-aligned bases and strides that
    are multiples of 8 elements (what TMA can read) and the head dim is a
    multiple of 8 (y, contiguous, is written by TMA too), else ``"parts"``
    (the split reads any dtypes and strides).  A pure function of dtypes,
    shapes, strides and base addresses (dt and A do not enter: the
    kernels read them with plain loads)."""
    tensors = ((x, 3), (B_, 2), (C_, 2))
    if x.shape[-1] % 8 or any(t.dtype != torch.bfloat16
                              for t, _ in tensors):
        return "parts"
    for t, axes in tensors:
        if t.data_ptr() % 16 or any(st % 8 for st in _strides(t, axes)):
            return "parts"
    return "wgmma"


def _pad64(d: int) -> int:
    """``d`` rounded up to a multiple of 64 (a tile's column block)."""
    return -(-d // 64) * 64


def parts_shapes(x: torch.Tensor, B_: torch.Tensor):
    """The split's outputs' shapes: x's parts (B, S, H, 3 DP) and B's and
    C's (B, S, 2, 3 NP), DP and NP the head dim and the state size rounded
    up to 64 (``ref.split``)."""
    Bb, S, H, P = x.shape
    return (Bb, S, H, 3 * _pad64(P)), (Bb, S, 2, 3 * _pad64(B_.shape[-1]))


def parts_scratch_shapes(Bb: int, S: int, H: int, P: int, N: int,
                         chunk: int) -> dict:
    """The parts kernels' f32 scratch by name (the chunk clamped): C B^T
    in the y kernel's fragment order (``g``, 64 KB a (b, chunk)), each
    chunk's state term and then the state entering it (``u``, P and N
    rounded up to 64; 50.3 MB at mamba2-780m's prefill shape) and
    exp(cs[Q-1]) a chunk (``e``)."""
    return {"g": (Bb, S // chunk, 4, 128, 32),
            "u": (Bb, H, S // chunk, _pad64(P), _pad64(N)),
            "e": (Bb, H, S // chunk)}


def ssd_split(x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parts route's split pass on checked tensors: (xp, bcp)
    (``parts_shapes``: bf16 hi, mid and lo, their sum the value exactly,
    zeros past P and N; bcp's head 0 B_'s, head 1 C_'s), contiguous, what
    the parts kernels' TMA maps read.  A CUDA tensor launches
    ``ssd_parts_split_kernel`` (any strides, float32 or bfloat16); a CPU
    tensor takes ``ref.split``."""
    if x.device.type == "cpu":
        return ref.split(x, B_, C_)
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    xp, bcp = (torch.empty(shape, dtype=torch.bfloat16, device=x.device)
               for shape in parts_shapes(x, B_))
    if xp.numel() == 0:
        return xp, bcp
    rc = build.launch(x.device, build.library().ssd_parts_split_launch,
                      x.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                      xp.data_ptr(), bcp.data_ptr(), Bb, S, H, P, N,
                      *_strides(x, 3), *_strides(B_, 2), *_strides(C_, 2),
                      _DTYPES[x.dtype], _DTYPES[B_.dtype])
    build.check(rc, "ssd_parts_split")
    build.count(ssd_split)
    return xp, bcp


def ssd_parts(x, dt, A, B_, C_, parts, chunk: int):
    """The parts route's kernels on the parts ``ssd_split`` returned for
    checked tensors (``chunk`` already clamped): (y (B,S,H,P) in x's
    dtype, state (B,H,P,N) f32), scratch (``parts_scratch_shapes``)
    allocated here and freed on return.  Counted in ``ssd``'s launches and
    routes.  The kernels run on the card only (``ssd`` takes the plain
    scan on the CPU): any other tensor raises."""
    if x.device.type != "cuda":
        raise ValueError("the parts kernels run on the card only, not on "
                         f"{x.device}")
    if tuple(p.shape for p in parts) != parts_shapes(x, B_) or any(
            p.dtype != torch.bfloat16 or not p.is_contiguous()
            or p.data_ptr() % 16 or p.device != x.device for p in parts):
        raise ValueError("the parts kernels read the parts ssd_split writes")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    dev = x.device
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state.zero_()
    g, u, e = (torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in parts_scratch_shapes(Bb, S, H, P, N,
                                                 chunk).values())
    rc = build.launch(dev, build.library().ssd_parts_launch,
                      *(p.data_ptr() for p in parts), dt.data_ptr(),
                      A.data_ptr(), y.data_ptr(), state.data_ptr(),
                      g.data_ptr(), u.data_ptr(), e.data_ptr(), Bb, S, H, P,
                      N, chunk, *dt.stride(), A.stride(0), _DTYPES[dt.dtype],
                      _DTYPES[A.dtype], _DTYPES[x.dtype])
    build.check(rc, "ssd_parts")
    build.count(ssd, "parts")
    return y, state


def launch(x, dt, A, B_, C_, chunk: int, route_: str):
    """Launch ``ssd_scan_launch``'s kernel of ``route_`` (``"wgmma"`` or
    ``"f32"``, ``ssd_f32_kernel``) on checked CUDA tensors (``chunk``
    already clamped), without counting; the (y, state) it writes.
    ``ssd`` calls it with the wgmma route; the card's checks call it with
    ``"f32"`` to hold or time ``ssd_f32_kernel`` (any dtypes and layouts)
    against the parts route.  A route the inputs do not allow raises."""
    if route_ not in _LAUNCH_ROUTES:
        raise ValueError(f"ssd_scan_launch has no route {route_!r}: "
                         f"{tuple(_LAUNCH_ROUTES)}")
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
            chunk, *strides, *dtypes, _LAUNCH_ROUTES[route_], stream)
    build.check(rc, f"ssd_scan ({route_} route)")
    return y, state


def _forward(x, dt, A, B_, C_, chunk):
    """(y, state) of checked inputs: the kernel on CUDA, the plain version
    on the CPU."""
    if x.device.type == "cpu":
        return ref.ssd(x, dt, A, B_, C_, chunk)
    if route(x, B_, C_) == "parts":
        return ssd_parts(x, dt, A, B_, C_, ssd_split(x, B_, C_), chunk)
    y, state = launch(x, dt, A, B_, C_, chunk, "wgmma")
    if y.numel():
        build.count(ssd, "wgmma")
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


def bwd_route(x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
              dy: torch.Tensor) -> str:
    """The backward kernels a CUDA launch of these inputs takes:
    ``"wgmma"`` where the forward's ``route`` is ``"wgmma"`` (bfloat16 x,
    B_ and C_ that TMA can read, P a multiple of 8) and dy is bfloat16,
    else ``"simt"``.  dy's layout does not enter: ``ssd_bwd`` copies it
    where TMA cannot read it.  A pure function of dtypes, shapes, strides
    and base addresses."""
    if dy.dtype == torch.bfloat16 and route(x, B_, C_) == "wgmma":
        return "wgmma"
    return "simt"


def image_bytes(P: int, N: int) -> int:
    """Bytes of one state's image on the wgmma route: its f32 values split
    into three bf16 parts (hi + mid + lo, exact), P and N rounded up to 64
    or 128 (the kernels' ``IMG``)."""
    pad = lambda d: 64 if d <= 64 else 128
    return 3 * pad(P) * pad(N) * 2


def bwd_groups(Bb: int, nc: int, H: int, sms: int) -> Tuple[int, int]:
    """(G2, G3): the groups of heads of the wgmma route's chunk pass (a
    block per (chunk, b, group), 2 warpgroups) and of its dB/dC pass (a
    block per (chunk, b, role, group)), each as many as fill the card's
    ``sms`` multiprocessors once, at least 1 and at most H, normalised so
    that every group holds a head (the C launcher refuses any other)."""
    def norm(want):
        g = max(1, min(H, want))
        per = -(-H // g)
        return -(-H // per)
    return norm(sms // (Bb * nc)), norm(sms // (2 * Bb * nc))


def bwd_scratch_shapes(Bb: int, S: int, H: int, P: int, N: int,
                       chunk: int, G2: int, G3: int) -> dict:
    """The wgmma route's scratch by name: shape, dtype (the chunk
    clamped).  At mamba2-780m's training shape about 322 MB: the states'
    and their cotangents' images (151.0 MB each), the chunk pass's sums of
    dG over its head groups, dcs's per-step terms, the dB and dC partials
    by head group."""
    nc = S // chunk
    u8, f32 = torch.uint8, torch.float32
    return {"s_img": ((Bb * H * nc * image_bytes(P, N),), u8),
            "ds_img": ((Bb * H * nc * image_bytes(P, N),), u8),
            "dgsum": ((Bb, nc, G2, MAX_CHUNK, MAX_CHUNK), f32),
            "rows": ((2, Bb, H, S), f32),
            "chunks": ((2, Bb, H, nc), f32),
            "dbc": ((2, Bb, G3, S, N), f32)}


def _bwd_simt(x, dt, A, B_, C_, dy, dstate, chunk, outs):
    """Launch the SIMT route (``ssd_bwd_launch``, six kernels) into
    ``outs`` (dx, ddt, dA, dB, dC)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    nc = S // chunk
    dev, f32 = x.device, torch.float32
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    states = torch.empty((Bb, H, nc + 1, P, N), dtype=f32, device=dev)
    dstates = torch.empty((Bb, H, nc, P, N), dtype=f32, device=dev)
    rows = torch.empty((4, Bb, H, S), dtype=f32, device=dev)
    chunks = torch.empty((2, Bb, H, nc), dtype=f32, device=dev)
    dBp = torch.empty((Bb, H, S, N), dtype=f32, device=dev)
    dCp = torch.empty_like(dBp)
    strides = [*_strides(x, 3), *dt.stride(), A.stride(0), *_strides(B_, 2),
               *_strides(C_, 2), *_strides(dy, 3)]
    dtypes = [_DTYPES[t.dtype] for t in (x, dt, A, B_, dy)]
    ptrs = [t.data_ptr() for t in (x, dt, A, B_, C_, dy, dstate, *outs,
                                   states, dstates, rows, chunks, dBp, dCp)]
    rc = build.launch(dev, build.library().ssd_bwd_launch, *ptrs, Bb, S, H,
                      P, N, chunk, *strides, *dtypes)
    build.check(rc, "ssd_bwd")


def _bwd_wgmma(x, dt, A, B_, C_, dy, dstate, chunk, outs):
    """Launch the wgmma route (``ssd_bwd_wgmma_launch``, five kernels) into
    ``outs`` (dx, ddt, dA, dB, dC); dy already TMA-ready."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G2, G3 = bwd_groups(Bb, S // chunk, H, sms)
    scratch = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype
               in bwd_scratch_shapes(Bb, S, H, P, N, chunk, G2,
                                     G3).values()]
    strides = [*_strides(x, 3), *dt.stride(), A.stride(0), *_strides(B_, 2),
               *_strides(C_, 2), *_strides(dy, 3)]
    ptrs = [t.data_ptr() for t in (x, dt, A, B_, C_, dy, dstate, *outs,
                                   *scratch)]
    rc = build.launch(dev, build.library().ssd_bwd_wgmma_launch, *ptrs, Bb,
                      S, H, P, N, chunk, G2, G3, *strides,
                      _DTYPES[dt.dtype], _DTYPES[A.dtype])
    build.check(rc, "ssd_bwd (wgmma route)")


def bwd_launch(x, dt, A, B_, C_, dy, dstate, chunk: int, route_: str):
    """Launch the backward kernels of ``route_`` on checked CUDA tensors
    (``chunk`` already clamped); (dx, ddt, dA, dB, dC), contiguous.
    ``ssd_bwd`` calls it with ``bwd_route(x, B_, C_, dy)`` and counts the
    call; the card's checks call it directly to time the SIMT route on
    bfloat16 inputs.  A route the inputs do not allow raises before any
    launch."""
    if route_ not in BWD_ROUTES:
        raise ValueError(f"no backward route {route_!r}: {BWD_ROUTES}")
    if route_ == "wgmma" and bwd_route(x, B_, C_, dy) != "wgmma":
        raise ValueError(
            "the wgmma backward takes bfloat16 x, B_, C_ and dy that TMA "
            f"can read with P a multiple of 8, not {x.dtype}/{B_.dtype}/"
            f"{dy.dtype} at P = {x.shape[-1]}")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    dev = x.device
    dstate = dstate.to(torch.float32).contiguous()
    outs = (torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev),
            torch.empty((Bb, S, H), dtype=dt.dtype, device=dev),
            torch.empty((H,), dtype=A.dtype, device=dev),
            torch.empty((Bb, S, N), dtype=B_.dtype, device=dev),
            torch.empty((Bb, S, N), dtype=C_.dtype, device=dev))
    if outs[0].numel() == 0:
        return tuple(t.zero_() for t in outs)
    if route_ == "wgmma":
        _bwd_wgmma(x, dt, A, B_, C_, _tma_ready(dy), dstate, chunk, outs)
    else:
        _bwd_simt(x, dt, A, B_, C_, dy, dstate, chunk, outs)
    return outs


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B_: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
            dstate: torch.Tensor, chunk: int = 128):
    """The vjp of ``ssd`` at (dy (B,S,H,P), dstate (B,H,P,N)): (dx, ddt,
    dA, dB, dC) in the dtypes of x, dt, A, B_ and C_.  CPU tensors take
    ``ref.ssd_bwd``; CUDA tensors launch the kernels of ``bwd_route``'s
    route, their outputs contiguous, with scratch allocated here and freed
    on return: on the wgmma route the states' and their cotangents' bf16
    images and a few f32 partials (``bwd_scratch_shapes``, about 322 MB
    at mamba2-780m's training shape), on the SIMT route f32 states,
    cotangents and per-head partials of dB and dC (about 620 MB there)."""
    chunk = _check(x, dt, A, B_, C_, chunk)
    _check_cotangents(x, B_, dy, dstate)
    if x.device.type == "cpu":
        return ref.ssd_bwd(x, dt, A, B_, C_, dy, dstate, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_bwd kernel for device {x.device}")
    way = bwd_route(x, B_, C_, dy)
    outs = bwd_launch(x, dt, A, B_, C_, dy, dstate, chunk, way)
    if outs[0].numel():
        build.count(ssd_bwd, way)
    return outs


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
ssd_split.launches = 0
ssd_bwd.launches = 0
ssd_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)
