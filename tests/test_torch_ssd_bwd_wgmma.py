"""The SSD backward's wgmma route (``csrc/ssd_scan_bwd_wgmma.cu``) on the
CPU, where it cannot run: the route rule ``ops.bwd_route`` at its edges
(dtype, P % 8, dy's strides, base alignment), no launch counted on CPU
tensors, the wrappers refusing what the route cannot run before any
launch, the Python limits against the C launcher's, the kernels' names
for the profiler's group, and an emulation of the route's arithmetic
held to ``ref.ssd_bwd``.

The emulation follows the kernels' products as written: the bf16 inputs
enter exactly; an f32 operand of a product that feeds dx, ddt or dcs
(the states' updates, the states and cotangents in the chunk passes,
G o L) is split into three bf16 parts whose sum is exact, one product
each; one that feeds only dB or dC (exp(cs) dy and decay dt x against
the states, the sums of dG) into bf16 hi + lo, two products, three
where both operands are f32 (hi.hi + hi.mid + lo.hi); dG is summed over
the heads before its B and C products; the cumulative sums are f64
rounded once.  It is held to the plain version at chunk 128, P = 64, N = 128 with
dt and A as training gives them (softplus of a normal, -exp of a small
normal), within 1e-4 of each output's largest magnitude (and one bf16
step of a bf16 output besides): the tolerance the card's checks
(chip_smoke.py ``SSD_BWD_ATOL``, ``SSD_BWD_BF16_RTOL``) hold the kernels
to.  Inputs come from numpy with a seed.
"""
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

torch.set_num_threads(1)

ATOL = 1e-4            # x the output's largest magnitude
BF16_RTOL = 2.0 ** -7  # one bfloat16 step
CSRC = pathlib.Path(ssd_ops.__file__).resolve().parents[2] / "csrc"
KERNELS = CSRC / "ssd_scan_bwd_wgmma.cuh"     # the kernels and constants
SOURCE = CSRC / "ssd_scan_bwd_wgmma.cu"       # the C entry points
BF16, F32 = torch.bfloat16, torch.float32


def _inputs(B, S, H, P, N, types=(BF16, F32, BF16), seed=0, nonzero=True):
    """x, dt, A, B_, C_, dy, dstate: normal x, B, C, dy; dt = softplus of a
    normal, A = -exp(0.3 normal) (a training step's range: cs reaches
    about -100 at chunk 128); dstate normal or zero."""
    g = np.random.default_rng(seed)
    t = lambda a, dtype: torch.from_numpy(a.astype(np.float32)).to(dtype)
    tx, tdt, tbc = types
    x = t(g.standard_normal((B, S, H, P)), tx)
    dt = t(np.log1p(np.exp(g.standard_normal((B, S, H)))), tdt)
    A = t(-np.exp(0.3 * g.standard_normal(H)), F32)
    Bm = t(g.standard_normal((B, S, N)), tbc)
    Cm = t(g.standard_normal((B, S, N)), tbc)
    dy = t(g.standard_normal((B, S, H, P)), tx)
    ds = t(g.standard_normal((B, H, P, N)) if nonzero
           else np.zeros((B, H, P, N)), F32)
    return x, dt, A, Bm, Cm, dy, ds


# ------------------------------------------------------------------ route

def _route_case(name):
    x, dt, A, Bm, Cm, dy, ds = _inputs(1, 64, 4, 16, 32)
    if name == "float32 x":
        x = x.float()
    elif name == "float32 dy":
        dy = dy.float()
    elif name == "float32 B and C":
        Bm, Cm = Bm.float(), Cm.float()
    elif name == "P = 12":
        x, dy = x[..., :12].contiguous(), dy[..., :12].contiguous()
    elif name == "x one element past an aligned base":
        buf = torch.empty(x.numel() + 8, dtype=x.dtype)
        off = (-buf.data_ptr() // 2) % 8 + 1
        x = buf[off:off + x.numel()].view(x.shape).copy_(x)
    elif name == "B a view of odd stride":
        bc = torch.zeros((1, 64, 2 * 32 + 1), dtype=BF16)
        Bm = bc[..., :32]
    elif name == "dy of odd stride":
        pad = torch.zeros(dy.shape[:-1] + (dy.shape[-1] + 1,), dtype=BF16)
        dy = pad[..., :-1].copy_(dy)
    elif name == "dy one element past an aligned base":
        buf = torch.empty(dy.numel() + 8, dtype=dy.dtype)
        off = (-buf.data_ptr() // 2) % 8 + 1
        dy = buf[off:off + dy.numel()].view(dy.shape).copy_(dy)
    elif name == "dt and A bfloat16":
        dt, A = dt.to(BF16), A.to(BF16)
    return x, dt, A, Bm, Cm, dy, ds


ROUTE_CASES = {
    "bfloat16": "wgmma", "float32 x": "simt", "float32 dy": "simt",
    "float32 B and C": "simt", "P = 12": "simt",
    "x one element past an aligned base": "simt",
    "B a view of odd stride": "simt",
    # dy's layout never decides: ssd_bwd copies it where TMA cannot read
    "dy of odd stride": "wgmma", "dy one element past an aligned base":
    "wgmma", "dt and A bfloat16": "wgmma"}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_backward_route_at_its_edges(name):
    x, dt, A, Bm, Cm, dy, ds = _route_case(name)
    assert ssd_ops.bwd_route(x, Bm, Cm, dy) == ROUTE_CASES[name]


@pytest.mark.parametrize("name", ["dy of odd stride",
                                  "dy one element past an aligned base",
                                  "bfloat16"])
def test_dy_is_copied_only_where_tma_cannot_read_it(name):
    dy = _route_case(name)[5]
    ready = ssd_ops._tma_ready(dy)
    assert torch.equal(ready, dy)
    assert (ready.data_ptr() == dy.data_ptr()) == (name == "bfloat16")
    assert ready.data_ptr() % 16 == 0 and ready.is_contiguous()


def test_cpu_tensors_count_no_launch():
    """On CPU tensors ssd_bwd is the plain version on either route's
    inputs: no launch and no route counted."""
    for name in ("bfloat16", "float32 x"):
        ins = _route_case(name)
        before = (ssd_ops.ssd_bwd.launches, dict(ssd_ops.ssd_bwd.routes))
        got = ssd_ops.ssd_bwd(*ins, chunk=16)
        want = ssd_ref.ssd_bwd(*ins, chunk=16)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (ssd_ops.ssd_bwd.launches, ssd_ops.ssd_bwd.routes) == before


@pytest.mark.parametrize("bad", ["wgmma on float32", "wgmma at P = 12",
                                 "no such route", "meta device"])
def test_wrappers_refuse_before_any_launch(bad, monkeypatch):
    """What the route cannot run raises before the library is built or a
    kernel launched."""
    def no_library():
        raise AssertionError("the library was asked for")
    monkeypatch.setattr(build, "library", no_library)
    before = ssd_ops.ssd_bwd.launches
    if bad == "meta device":
        ins = [t.to("meta") for t in _route_case("bfloat16")]
        with pytest.raises(ValueError, match="no ssd_bwd kernel"):
            ssd_ops.ssd_bwd(*ins, chunk=16)
    else:
        ins = _route_case({"wgmma on float32": "float32 x",
                           "wgmma at P = 12": "P = 12",
                           "no such route": "bfloat16"}[bad])
        route = "tensor cores" if bad == "no such route" else "wgmma"
        with pytest.raises(ValueError):
            ssd_ops.bwd_launch(*ins, 16, route)
    assert ssd_ops.ssd_bwd.launches == before


# ---------------------------------------------------- the C launcher's limits

def _c_constant(name):
    return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                         KERNELS.read_text()).group(1))


def test_python_limits_match_the_c_launcher():
    src = SOURCE.read_text()
    launcher = src[src.index('extern "C" int ssd_bwd_wgmma_launch('):]
    assert _c_constant("QP") == ssd_ops.MAX_CHUNK
    assert f"P > {ssd_ops.MAX_HEAD_DIM}" in launcher and "P % 8" in launcher
    assert f"N > {ssd_ops.MAX_STATE}" in launcher
    assert "chunk > QP" in launcher
    # the image: three bf16 parts of the state, P and N padded to 64 or 128
    # (the launcher's instances: PP = 128 past P = 64, NP = 128 past N = 64)
    assert "PART = PP * NP * 2, IMG = 3 * PART" in KERNELS.read_text()
    assert "if (P > 64) return" in launcher and "N <= 64 ?" in launcher
    for P, N, want in ((8, 16, 24576), (64, 128, 49152), (65, 64, 49152),
                       (128, 128, 98304)):
        assert ssd_ops.image_bytes(P, N) == want


@pytest.mark.parametrize("Bb,nc,H", [(8, 8, 48), (2, 8, 112), (1, 1, 1),
                                     (1, 2, 7), (4, 7, 48), (300, 1, 5),
                                     (1, 1, 131), (3, 5, 97)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_head_groups_satisfy_the_launcher(Bb, nc, H, sms):
    """Every group of the chunk and dB/dC passes holds a head, as
    ssd_bwd_wgmma_launch demands ((G - 1) * ceil(H / G) < H), and the
    groups fill the card at most once."""
    G2, G3 = ssd_ops.bwd_groups(Bb, nc, H, sms)
    for G, blocks in ((G2, Bb * nc), (G3, 2 * Bb * nc)):
        assert 1 <= G <= H
        assert (G - 1) * math.ceil(H / G) < H
        assert G == 1 or G * blocks <= sms


def test_scratch_is_below_the_simt_routes():
    """The route's scratch at mamba2-780m's training shape: about 322 MB,
    against the SIMT route's 620 MB (float32 states, cotangents and per-
    head partials of dB and dC)."""
    Bb, S, H, P, N, Q = 8, 1024, 48, 64, 128, 128
    G2, G3 = ssd_ops.bwd_groups(Bb, S // Q, H, 132)
    shapes = ssd_ops.bwd_scratch_shapes(Bb, S, H, P, N, Q, G2, G3)
    total = sum(math.prod(s) * torch.empty((), dtype=d).element_size()
                for s, d in shapes.values())
    nc = S // Q
    simt = 4 * (Bb * H * (2 * nc + 1) * P * N + 4 * Bb * H * S
                + 2 * Bb * H * nc + 2 * Bb * H * S * N)
    assert 315e6 < total < 330e6 and simt > 600e6


def test_kernels_are_named_for_the_profilers_group():
    """The route's kernels, as its source defines them, start with
    ``ssd_bwd_``, which the training profile gathers as "SSD backward",
    and chip_smoke.py's SSD_BWD_KERNELS names each, first, the wgmma
    route's five (its profiled step reads their device ms)."""
    pattern = r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\("
    names = set(re.findall(pattern, KERNELS.read_text()))
    assert len(names) == 4 and all(n.startswith("ssd_bwd_") for n in names)
    smoke = (CSRC.parents[2] / "chip_smoke.py").read_text()
    listed = re.findall(r'"([^"]+)"', re.search(
        r"SSD_BWD_KERNELS = \(([^)]*)\)", smoke).group(1))
    assert {n.split("<")[0] for n in listed[:5]} == names
    assert sorted(n for n in listed[:5] if "state" in n) == [
        "ssd_bwd_wgmma_state_kernel<false>",
        "ssd_bwd_wgmma_state_kernel<true>"]


# ------------------------------------------------------------- emulation

def _split(v):
    """Two bf16 parts: hi, and what it leaves rounded (to ~2^-17 of v)."""
    hi = v.to(BF16).float()
    return hi, (v - hi).to(BF16).float()


def _parts3(v):
    """Three bf16 parts whose sum is v: hi, mid, lo."""
    hi = v.to(BF16).float()
    mid = (v - hi).to(BF16).float()
    return hi, mid, (v - hi - mid).to(BF16).float()


def _two(eq, a, b):
    """The product of f32 ``a`` (split hi + lo) and exact ``b``."""
    ah, al = _split(a)
    return torch.einsum(eq, ah, b) + torch.einsum(eq, al, b)


def _three(eq, a, b):
    """The product of f32 ``a`` (three parts) and exact ``b``."""
    return sum(torch.einsum(eq, part, b) for part in _parts3(a))


def _scaled(eq, a, image):
    """The product of f32 ``a`` (split hi + lo) and an image's hi and mid
    parts: hi.hi + hi.mid + lo.hi."""
    ah, al = _split(a)
    bh, bm, _ = image
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bm)
            + torch.einsum(eq, al, bh))


def emulate(x, dt, A, B_, C_, dy, dstate, chunk):
    """The wgmma route's arithmetic (see the module note): (dx, ddt, dA,
    dB, dC) in the inputs' dtypes."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xf, dyf = x.float(), dy.float()
    dtf, Af = dt.float(), A.float()
    cs = ssd_ref.cumsum((dtf * Af).reshape(Bb, nc, Q, H), dim=2)
    e = torch.exp(cs)
    decay = torch.exp(cs[:, :, -1:] - cs)
    w = dtf.reshape(Bb, nc, Q, H) * decay
    xc, dyc = xf.reshape(Bb, nc, Q, H, P), dyf.reshape(Bb, nc, Q, H, P)
    dtc = dtf.reshape(Bb, nc, Q, H)
    Bc, Cc = B_.float().reshape(Bb, nc, Q, N), C_.float().reshape(
        Bb, nc, Q, N)
    # the states' replay and the cotangents' reverse walk
    St = torch.zeros((Bb, H, P, N))
    s_in, s_out = [], []
    for c in range(nc):
        s_in.append(St)
        St = St * torch.exp(cs[:, c, -1])[..., None, None] + _three(
            "bshp,bsn->bhpn", xc[:, c] * w[:, c, :, :, None], Bc[:, c])
        s_out.append(St)
    dS = dstate.float()
    ds_in = [None] * nc
    for c in reversed(range(nc)):
        ds_in[c] = dS
        dS = dS * torch.exp(cs[:, c, -1])[..., None, None] + _three(
            "blhp,bln->bhpn", dyc[:, c] * e[:, c, :, :, None], Cc[:, c])
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()     # [l, s]: s <= l
    dx = torch.empty((Bb, nc, Q, H, P))
    ddt = torch.empty((Bb, nc, Q, H), dtype=dt.dtype)
    dA = torch.zeros(H, dtype=torch.float64)
    dB, dC = torch.empty((Bb, nc, Q, N)), torch.empty((Bb, nc, Q, N))
    for c in range(nc):
        x_, dy_, dt_ = xc[:, c], dyc[:, c], dtc[:, c]
        cs_, e_, dec_ = cs[:, c], e[:, c], decay[:, c]
        s0, ds = _parts3(s_in[c]), _parts3(ds_in[c])
        # the chunk pass: G^T[s, l], L^T[s, l] = exp(cs[l] - cs[s]), l >= s
        GT = torch.einsum("bsn,bln->bsl", Bc[:, c], Cc[:, c])
        seg = cs_.transpose(1, 2)[..., None, :] - \
            cs_.transpose(1, 2)[..., :, None]                 # (B,H,s,l)
        LT = torch.exp(seg.masked_fill(~tril.T, float("-inf")))
        MT = torch.einsum("bshp,blhp->bhsl", x_, dy_)
        dGT = MT * LT * dt_.transpose(1, 2)[..., None]
        dGGT = dGT * GT[:, None]
        dsum = torch.zeros((Bb, Q, Q))
        for h in range(H):                  # the group's heads, in order
            dsum = dsum + dGT[:, h]
        U = sum(torch.einsum("bsn,bhpn->bhsp", Bc[:, c], part)
                for part in ds)
        xs = x_.transpose(1, 2)                               # (B,H,s,p)
        to_state = (dec_ * dt_).transpose(1, 2) * (xs * U).sum(-1)
        X = dec_.transpose(1, 2)[..., None] * U + _three(
            "bhsl,blhp->bhsp", GT[:, None] * LT, dy_)
        dx[:, c] = (X * dt_.transpose(1, 2)[..., None]).transpose(1, 2)
        xx = (X * xs).sum(-1)                                 # (B,H,s)
        part = dGGT.sum(-2) - dGGT.sum(-1) - to_state
        # the dB/dC pass
        dC[:, c] = _scaled("blhp,bhpn->bln", dyc[:, c] * e_[..., None],
                           s0) + _two("bls,bsn->bln", dsum.transpose(1, 2),
                                      Bc[:, c])
        dB[:, c] = _scaled("bshp,bhpn->bsn", x_ * (dt_ * dec_)[..., None],
                           ds) + _two("bsl,bln->bsn", dsum, Cc[:, c])
        W = sum(torch.einsum("bln,bhpn->bhlp", Cc[:, c], part)
                for part in s0)
        wterm = e_.transpose(1, 2) * (dy_.transpose(1, 2) * W).sum(-1)
        dcs = part + wterm
        dcs[..., -1] += (s_out[c] * sum(ds)).sum((-2, -1))
        da = ssd_ref.revcumsum(dcs, dim=-1)                   # (B,H,Q)
        pa = da * Af[:, None]
        both = (xx.to(dt.dtype) + pa.to(dt.dtype)) if dt.dtype == BF16 \
            else xx + pa
        ddt[:, c] = both.transpose(1, 2).to(dt.dtype)
        dA += (da * dt_.transpose(1, 2)).double().sum((0, 2))
    return (dx.reshape(Bb, S, H, P).to(x.dtype), ddt.reshape(Bb, S, H),
            dA.float().to(A.dtype), dB.reshape(Bb, S, N).to(B_.dtype),
            dC.reshape(Bb, S, N).to(C_.dtype))


def _within(got, want):
    """The largest error of each output as a share of its tolerance."""
    out = {}
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        w32 = w.float()
        tol = ATOL * float(w32.abs().max()) + (
            BF16_RTOL * w32.abs() if w.dtype == BF16 else 0.0)
        out[name] = float(((g.float() - w32).abs() / tol).max())
    return out


@pytest.mark.parametrize("case", [(1, 256, 4, 64, 128, 128, True),
                                  (2, 128, 3, 64, 128, 128, False),
                                  (2, 256, 4, 64, 128, 128, True),
                                  (1, 512, 8, 64, 128, 128, True)])
def test_emulated_route_is_within_the_card_tolerance(case):
    """Rounded as the route rounds, the arithmetic stays within the
    tolerance the card's checks hold the kernels to (x, B, C and dy in
    bfloat16, dt and A in float32, as training gives them)."""
    B, S, H, P, N, chunk, nonzero = case
    ins = _inputs(B, S, H, P, N, seed=S + H, nonzero=nonzero)
    share = _within(emulate(*ins, chunk), ssd_ref.ssd_bwd(*ins, chunk))
    assert max(share.values()) <= 1.0, share


def test_emulation_with_one_bf16_per_operand_misses_the_tolerance():
    """The splits are needed: with each f32 operand rounded to one bf16,
    the same arithmetic misses the tolerance."""
    global _split, _parts3
    keep = _split, _parts3
    zero = torch.zeros_like
    _split = lambda v: (v.to(BF16).float(), zero(v))
    _parts3 = lambda v: (v.to(BF16).float(), zero(v), zero(v))
    try:
        ins = _inputs(1, 96, 2, 64, 128, seed=226)
        share = _within(emulate(*ins, 32), ssd_ref.ssd_bwd(*ins, 32))
    finally:
        _split, _parts3 = keep
    assert max(share.values()) > 1.0, share
