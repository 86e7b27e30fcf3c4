"""The float32 flash forward's wgmma route on the CPU: ``ops.fwd_route``
and ``ops.fwd_kernel`` at their edges, the split pass's plain version
(three bf16 parts that sum to the value exactly, zeros past Dh), the
route's arithmetic emulated in plain torch (the parts, the six S terms,
P in two parts, the five P.V terms, a tile's own P.V accumulator, log2
units, the kernel's key tiles) against the Pallas kernel in interpret
mode and the reference's exact attention within the reference's 2e-5
(and with the backward's three P.V terms, which chip_smoke.py's bound
counts), the wrappers' refusals before any launch, and the C source's limits,
term list and shared-memory table.  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, marker ``cuda``)."""
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FA_CASES

from repro.kernels.flash_attention import kernel as fa_kernel
from repro.models.layers import attention_exact as ref_attention_exact
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref

TOL = 2e-5                       # the reference's float32 tolerance
SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "flash_attention_fwd_parts.cu").read_text()
# ragged S, GQA, causal/window/non-causal, head dims 8 ... 128
RAGGED = [(2, 77, 8, 2, 64, True, 0), (1, 100, 4, 4, 80, True, 24),
          (2, 33, 6, 3, 16, False, 0), (1, 129, 4, 1, 32, False, 40),
          (1, 70, 4, 2, 128, True, 0), (2, 65, 4, 1, 8, True, 1)]


def _qkv(seed, B, S, H, KV, Dh):
    g = np.random.default_rng(seed)
    arrs = [g.standard_normal((B, S, n, Dh)).astype(np.float32)
            for n in (H, KV, KV)]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                            for a in arrs]


def _c_expr(expr: str, i: int) -> int:
    """Evaluate one of the source's term selectors, a right-nested
    ``cond ? a : b`` over ``i`` with ``==`` and ``||``."""
    expr = expr.strip()
    if "?" not in expr:
        return int(expr)
    cond, rest = expr.split("?", 1)
    then, other = rest.split(":", 1)
    hit = any(int(t.split("==")[1]) == i for t in cond.split("||"))
    return _c_expr(then if hit else other, i)


def _pv_terms():
    """The kernel's P.V terms, (P part, V part), from the source."""
    n = int(re.search(r"constexpr int PV_TERMS = (\d+);", SRC).group(1))
    sel = {f: re.search(rf"int {f}\(int i\) \{{\s*return ([^;]+);", SRC)
           .group(1) for f in ("pv_a", "pv_b")}
    return [(_c_expr(sel["pv_a"], i), _c_expr(sel["pv_b"], i))
            for i in range(n)]


def _parts(x):
    """x's three parts as float64 tensors of bf16 values (hi, mid, lo)."""
    Dh = x.shape[-1]
    p = ref.split_parts(x).double()
    DP = p.shape[-1] // 3
    return [p[..., i * DP:i * DP + Dh] for i in range(3)]


def _parts_arithmetic(q, k, v, *, causal, window, pv_terms=None):
    """What the card's float32 wgmma route computes, in plain torch: q, k
    and v in three bf16 parts; S over the BK-key tiles of the kernel (64
    up to Dh 64, else 32) as the five cross terms (lo.hi, mid.mid, hi.lo,
    mid.hi, hi.mid; products exact in float64) rounded to f32 plus hi.hi
    rounded to f32; logits in log2 units, the finite NEG_INF, exp2; p in
    f32 for l, split into bf16 hi and lo for P.V; the tile's P.V as the
    kernel's terms (``PV_TERMS`` of the source; or ``pv_terms``, (P part,
    V part) pairs) in a zeroed accumulator, rounded to f32, then O = O *
    corr + tile in one rounding; out = O / max(l, 1e-37), lse = m ln 2 +
    log(l).  The tensor cores' truncation is not emulated."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    BK = 64 if Dh <= 64 else 32
    qp = [t.transpose(1, 2) for t in _parts(q)]
    kp, vp = ([t.repeat_interleave(G, 2).transpose(1, 2) for t in _parts(x)]
              for x in (k, v))
    scale = torch.tensor(math.log2(math.e) / math.sqrt(Dh))
    band = ref.band_mask(S, causal, window)
    m = torch.full((B, H, S), ref.NEG_INF)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, Dh))
    cross = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1)]
    for k0 in range(0, S, BK):
        ks = slice(k0, k0 + BK)
        s = sum(qp[a] @ kp[b][:, :, ks].transpose(-1, -2)
                for a, b in cross).float() \
            + (qp[0] @ kp[0][:, :, ks].transpose(-1, -2)).float()
        x = (s * scale).masked_fill(~band[:, ks], ref.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = (l.double() * corr + p.sum(-1).double()).float()
        hi = p.to(torch.bfloat16).float()
        pp = [hi.double(), (p - hi).to(torch.bfloat16).double()]
        tile = sum(pp[a] @ vp[b][:, :, ks]
                   for a, b in pv_terms or _pv_terms()).float()
        acc = (acc.double() * corr[..., None] + tile).float()
        m = m_new
    den = l.clamp_min(1e-37)
    out = (acc / den[..., None]).transpose(1, 2)
    return out, m * math.log(2) + torch.log(den)


def _close(want, got):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


# (dtype, head dim) -> the forward's route: bfloat16 always wgmma,
# float32 up to a head dim of 128 (three parts fit shared memory), else
# simt
@pytest.mark.parametrize("dtype,Dh,want", [
    (torch.float32, 8, "wgmma"), (torch.float32, 64, "wgmma"),
    (torch.float32, 128, "wgmma"), (torch.float32, 136, "simt"),
    (torch.float32, 192, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 136, "wgmma"),
    (torch.bfloat16, 256, "wgmma")])
def test_fwd_route_at_its_edges(dtype, Dh, want):
    q = torch.empty((1, 8, 4, Dh), dtype=dtype, device="meta")
    assert ops.fwd_route(q) == want


@pytest.mark.parametrize("dtype,Dh,route,want", [
    (torch.float32, 64, None, "fa_fwd_parts_kernel"),
    (torch.float32, 128, "wgmma", "fa_fwd_parts_kernel"),
    (torch.float32, 64, "simt", "fa_f32_kernel"),
    (torch.float32, 192, None, "fa_f32_kernel"),
    (torch.bfloat16, 64, None, "fa_wgmma_kernel"),
    (torch.bfloat16, 256, "wgmma", "fa_wgmma_kernel"),
    (torch.float32, 136, "wgmma", "at most 128"),
    (torch.bfloat16, 64, "simt", "no simt forward"),
    (torch.float32, 64, "tf32", "no forward route")])
def test_fwd_kernel_of_each_route(dtype, Dh, route, want):
    """The kernel a launch runs, of ``FWD_KERNELS``; a route the inputs
    cannot take raises."""
    q = torch.empty((1, 8, 4, Dh), dtype=dtype, device="meta")
    if want in ops.FWD_KERNELS:
        assert ops.fwd_kernel(q, route) == want
    else:
        with pytest.raises(ValueError, match=want):
            ops.fwd_kernel(q, route)


@pytest.mark.parametrize("Dh", [8, 64, 72, 128])
def test_split_parts_sum_to_the_value_exactly(Dh):
    """The split's plain version: three bf16 parts of DP = Dh rounded up
    to 64 columns each, whose sum is the float32 value exactly (signed
    values from 2^-110, below which mid and lo would be subnormal, to
    1e30), zeros past Dh."""
    g = np.random.default_rng(Dh)
    x = g.standard_normal((2, 9, 3, Dh)) * 10.0 ** g.integers(
        -30, 30, (2, 9, 3, Dh))
    x = torch.from_numpy(x.astype(np.float32))
    x[0, 0, 0, :4] = torch.tensor([0.0, -1.0, 1.0 + 2.0 ** -23,
                                   -(1.0 + 2.0 ** -23) * 2.0 ** -110])
    parts = ref.split_parts(x)
    DP = -(-Dh // 64) * 64
    assert parts.shape == (2, 9, 3, 3 * DP) == ops.parts_shape(x)
    assert parts.dtype == torch.bfloat16
    p = parts.view(2, 9, 3, 3, DP).double()
    assert torch.equal(p[..., :Dh].sum(-2), x.double())
    assert not p[..., Dh:].any()
    # hi is x rounded, mid what is left rounded: each part carries 8 bits
    assert torch.equal(parts[..., :Dh], x.to(torch.bfloat16))


def test_split_wrapper_on_the_cpu_takes_the_plain_version():
    """``fa_fwd_split`` on CPU tensors returns the plain parts of q, k and
    v and counts no launch; inputs off the route raise first."""
    _, (q, k, v) = _qkv(1, 1, 20, 4, 2, 40)
    before = (ops.fa_fwd_split.launches, dict(ops.flash_attention.routes))
    parts = ops.fa_fwd_split(q, k, v)
    for got, x in zip(parts, (q, k, v)):
        assert torch.equal(got, ref.split_parts(x))
    for bad in (q.bfloat16(), torch.zeros((1, 20, 4, 136))):
        with pytest.raises(ValueError, match="split takes float32"):
            ops.fa_fwd_split(bad, bad, bad)
    assert (ops.fa_fwd_split.launches, ops.flash_attention.routes) == before


def test_parts_wrapper_refuses_foreign_parts_before_any_launch():
    """``fa_fwd_parts`` reads only what ``fa_fwd_split`` writes for q and
    k, at a head dim of at most 128: anything else raises before the
    library is built."""
    _, (q, k, v) = _qkv(2, 1, 20, 4, 2, 64)
    parts = ops.fa_fwd_split(q, k, v)
    before = dict(ops.flash_attention.routes)
    bad_parts = [parts[:2], (parts[0], parts[1], parts[2].float()),
                 (parts[0][:, 1:], parts[1], parts[2]),
                 (parts[0], parts[1].transpose(1, 2), parts[2])]
    for bad in bad_parts:
        with pytest.raises(ValueError, match="parts fa_fwd_split writes"):
            ops.fa_fwd_parts(q, k, bad, True, 0, False)
    wide = torch.zeros((1, 20, 4, 192))
    with pytest.raises(ValueError, match="at most 128"):
        ops.fa_fwd_parts(wide, wide, parts, True, 0, False)
    assert ops.flash_attention.routes == before


def test_route_keyword_on_the_cpu():
    """A CPU forward takes the plain version on either float32 route
    (``flash_attention``, ``flash_attention_simt``) and counts nothing;
    bfloat16 has no simt route; the public entries take no route."""
    _, (q, k, v) = _qkv(3, 1, 30, 4, 2, 16)
    want = ref.flash_attention(q, k, v)
    before = ops.flash_attention.launches
    for entry in (ops.flash_attention, ops.flash_attention_simt):
        assert torch.equal(entry(q, k, v), want)
    assert ops.flash_attention.launches == before
    with pytest.raises(ValueError, match="no simt forward"):
        ops.flash_attention_simt(*(x.bfloat16() for x in (q, k, v)))
    for entry in (ops.flash_attention, ops.flash_attention_fwd):
        with pytest.raises(TypeError):
            entry(q, k, v, route="simt")


@pytest.mark.parametrize("case", FA_CASES)
def test_parts_arithmetic_within_tolerance_of_pallas_kernel(case):
    """The route's arithmetic (three bf16 parts, the S and P.V term
    lists, a tile's own accumulator) stays within the reference's
    float32 tolerance of the Pallas kernel on its own cases."""
    B, S, H, KV, Dh, causal, window, blk = case
    (qj, kj, vj), (qt, kt, vt) = _qkv(S + H + Dh, B, S, H, KV, Dh)
    want = fa_kernel.flash_attention_fwd(
        qj, kj, vj, causal=causal, window=window, block_q=blk, block_k=blk,
        interpret=True)
    got, _ = _parts_arithmetic(qt, kt, vt, causal=causal, window=window)
    _close(want, got)


@pytest.mark.parametrize("case", RAGGED)
def test_parts_arithmetic_within_tolerance_at_ragged_lengths(case):
    """The same at ragged S, GQA, windows and head dims 8 ... 128 against
    the reference's exact attention; lse within 2e-5 of the plain one."""
    B, S, H, KV, Dh, causal, window = case
    (qj, kj, vj), (qt, kt, vt) = _qkv(S, B, S, H, KV, Dh)
    want = ref_attention_exact(qj, kj, vj, causal=causal, window=window)
    got, lse = _parts_arithmetic(qt, kt, vt, causal=causal, window=window)
    _close(want, got)
    _, want_lse = ref.flash_attention_fwd(qt, kt, vt, causal=causal,
                                          window=window)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)


# the backward's three P.V accumulation terms, (P part, V part): lo.hi,
# hi.mid, hi.hi
BWD_PV_TERMS = [(1, 0), (0, 1), (0, 0)]


def test_pv_terms_are_all_but_lo_lo():
    """P.V sums every (P part, V part) term but lo.lo, smallest first:
    lo.mid, hi.lo, lo.hi, hi.mid, hi.hi; with S's six, the terms whose
    work rate chip_smoke.py prints.  Its bound counts S's six and the
    backward's three, which are among them."""
    assert _pv_terms() == [(1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
    cs = _chip_smoke()
    assert cs.FA_F32_KERNEL_TERMS == 6 + len(_pv_terms())
    assert set(BWD_PV_TERMS) < set(_pv_terms())
    assert cs.FA_F32_BOUND_TERMS == 6 + len(BWD_PV_TERMS)


@pytest.mark.parametrize("case", RAGGED)
def test_bound_terms_meet_the_tolerance(case):
    """The terms chip_smoke.py's bound counts (S's six, P.V the
    backward's three) already meet 2e-5 against the reference's exact
    attention: the bound is the fewest terms the function needs, not
    the five P.V terms the kernel runs for margin."""
    B, S, H, KV, Dh, causal, window = case
    (qj, kj, vj), (qt, kt, vt) = _qkv(S, B, S, H, KV, Dh)
    want = ref_attention_exact(qj, kj, vj, causal=causal, window=window)
    got, _ = _parts_arithmetic(qt, kt, vt, causal=causal, window=window,
                               pv_terms=BWD_PV_TERMS)
    _close(want, got)


def test_fwd_limits_match_the_c_launcher():
    """``MAX_F32_WGMMA_FWD_HEAD_DIM`` is the head dim the C launchers
    refuse past, and the launcher takes DP 64 up to Dh 64."""
    limit = re.search(r"constexpr int MAX_DH = (\d+);", SRC)
    assert limit and int(limit.group(1)) == ops.MAX_F32_WGMMA_FWD_HEAD_DIM
    assert "Dh > MAX_DH" in SRC
    assert re.search(r"Dh <= 64\s*\?\s*launch_fwd_parts<64,", SRC)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shared_memory_table_matches_the_instances():
    """Each launched instance fa_fwd_parts_kernel<DP, WGS, BK, STAGES>
    fits a block's 232,448 bytes, with the total the source's table
    gives, and [build] in chip_smoke.py requires exactly these."""
    inst = [tuple(map(int, m)) for m in re.findall(
        r"launch_fwd_parts<(\d+), (\d+), (\d+), (\d+)>\(", SRC)]
    assert len(inst) == 2
    for DP, WGS, BK, STAGES in inst:
        q_bytes = 3 * 64 * WGS * DP * 2
        kv_bytes = 3 * BK * DP * 2
        smem = q_bytes + 2 * STAGES * kv_bytes + 8 * (1 + 2 * STAGES) + 1024
        assert smem <= 232448
        assert re.search(rf"<DP {DP}, WGS {WGS}, BK {BK}, STAGES {STAGES}>"
                         rf".*\s{smem // 1000},{smem % 1000:03d}\n", SRC)
    assert _chip_smoke().FA_FWD_INSTANCES == tuple(
        f"fa_fwd_parts_kernel<{', '.join(map(str, i))}>" for i in inst)


def test_forward_kernels_are_named_for_the_profilers_group():
    """The route's kernels start with ``fa_fwd_``, which chip_smoke.py's
    training profile gathers as "flash forward" and its serving profile
    counts as flash_attention's."""
    names = set(re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\(", SRC))
    assert names == {"fa_fwd_parts_kernel", "fa_fwd_split_kernel"}
    cs = _chip_smoke()
    groups = dict(cs.TRAIN_GROUPS)
    assert all(any(p in n for p in groups["flash forward"]) for n in names)
    assert names <= set(cs.DEVICE_KERNELS["flash_attention"])


@pytest.mark.parametrize("dtype,want", [
    ("float32", {"fa_fwd_parts_kernel": 4}),
    ("bfloat16", {"fa_wgmma_kernel": 4})])
def test_train_step_forward_launches_by_kernel(dtype, want):
    """granite-3-2b's step at depth 2: four forwards (two a layer under
    remat), all on the kernel of the config's dtype."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("granite-3-2b").replace(n_layers=2, dtype=dtype)
    assert _chip_smoke().train_fwd_routes(cfg) == {
        **dict.fromkeys(ops.FWD_KERNELS, 0), **want}


def test_float32_bounds_at_granite_heads():
    """The timed row's bounds: the function's 17.2 GFLOP at 67 TFLOP/s,
    the split's 126 MB at 3.35 TB/s, the parts kernel's 6 + 3 bf16 terms
    (the fewest that meet 2e-5) at 989 TFLOP/s, about 0.078 ms; the work
    of the 11 it runs."""
    cs = _chip_smoke()
    b = cs.fa_f32_bounds(*cs.FA_F32_TIME)
    assert b["flops"] == 4 * 4 * 32 * 64 * (1024 * 1025 // 2)
    assert b["function"] == (pytest.approx(0.25667, abs=1e-5),
                             "operations")
    assert b["fa_fwd_split"][2] == 4 * 1024 * (32 + 16) * 64 * 10
    assert b["fa_fwd_split"][0] == pytest.approx(0.03756, abs=1e-5)
    assert b["fa_fwd_parts"] == (pytest.approx(
        9 * b["flops"] / 2 / 989e9), "operations")
    assert b["fa_fwd_parts"][0] == pytest.approx(0.07825, abs=1e-5)
    assert b["route"][0] == pytest.approx(0.11581, abs=1e-5)
    assert b["term_flops"] == 11 * b["flops"] // 2
