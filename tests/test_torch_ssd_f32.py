"""The float32 SSD scan's parts route on the CPU (``csrc/ssd_scan_parts.cu``):
the split pass's plain version (three bf16 parts that sum to the value
exactly, zeros past P and N, the layout the kernels' TMA maps read), the
route's arithmetic emulated in plain torch (C B^T, each chunk's state term,
the states' scan, C S^T and P x, every product as the source's bf16 terms
over three parts an operand, hi.hi in an accumulator of its own) against
the Pallas kernel ``ssd_fwd`` in interpret mode and against the plain
version, the term count (every term kept, and a term fewer misses), the
wrappers on CPU tensors, the C source's limits and shared-memory table,
and the launches a float32 mamba2-780m step must show.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``, marker
``cuda``).

Each product keeps the six terms down to 2^-16 of it.  They are held to
half the reference's float32 tolerance, 1e-4 + 1e-4 |want| (the card's
checks print each row's share of it).  At chunk 128 the reference's
kernel sums its cumulative sums in float32 and lies 1.25 of that
tolerance from the plain version, which sums them in float64 as the
kernels do (tests/test_torch_ssd.py), so there the emulation is held to
the plain version, which the card holds the kernels to, at half the
tolerance, and to the exact float64 recurrence at the tolerance.  The
mamba2 float32 check row is emulated at its full 48 heads: cut to a few
heads, one dropped term of the state's product stayed within half the
tolerance, at 48 it misses.
"""
import importlib.util
import math
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch
from test_kernels import SSD_CASES
from test_torch_ssd import _exact, _inputs

from repro.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops, ref

torch.set_num_threads(1)

TOL = 1e-4                       # the reference's float32 tolerance
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SRC = (CSRC / "ssd_scan_parts.cu").read_text()
PARTS_SRC = (CSRC / "flash_attention_parts.cuh").read_text()
# chip_smoke.py's "mamba2 shape, float32" row: B, S, H, P, N, chunk
MAMBA2_F32 = (2, 512, 48, 64, 128, 128)
PRODUCTS = ("G", "U", "CS", "PX")


def _c_expr(expr: str, **env) -> int:
    """Evaluate one of the source's term selectors, a right-nested
    ``cond ? a : b`` whose conditions are ``var == k`` joined by ``||``."""
    expr = expr.strip()
    if "?" not in expr:
        return int(expr)
    cond, rest = expr.split("?", 1)
    then, other = rest.split(":", 1)
    hit = any(env[v.strip()] == int(k)
              for v, k in (t.split("==") for t in cond.split("||")))
    return _c_expr(then if hit else other, **env)


def _source_terms():
    """The terms every product of the route sums, (A part, B part) with
    hi 0, mid 1, lo 2, smallest first (the last in an accumulator of its
    own): ``TERMS = RTERMS<3>`` of ssd_scan_parts.cu, selected by
    flash_attention_parts.cuh's ``rterm_a`` and ``rterm_b``."""
    assert "constexpr int TERMS = RTERMS<3>;" in SRC
    n3 = re.search(r"constexpr int RTERMS = PARTS == 1 \? 1 : (\d+);",
                   PARTS_SRC)
    sel = {f: re.search(rf"{f}\(int i, int n\) \{{\s*return ([^;]+);",
                        PARTS_SRC).group(1) for f in ("rterm_a", "rterm_b")}
    n = int(n3.group(1))
    return [(_c_expr(sel["rterm_a"], i=i, n=n),
             _c_expr(sel["rterm_b"], i=i, n=n)) for i in range(n)]


def _parts(t, n=3):
    """t's first ``n`` bf16 parts (hi, mid, lo) as float64 tensors."""
    out, rest = [], t.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16)
        out.append(p.double())
        rest = rest - p.float()
    return out


def _product(A, B, terms, eq):
    """sum of ``terms`` (A part, B part) of einsum ``eq``, each product
    exact in float64: hi.hi rounded to f32 alone, the rest summed and
    rounded, the two added in f32 (the kernels' two accumulators; the
    tensor cores' truncation is not emulated)."""
    cross = [t for t in terms if t != (0, 0)]
    out = sum(torch.einsum(eq, A[a], B[b]) for a, b in cross).float()
    if (0, 0) in terms:
        out = out + torch.einsum(eq, A[0], B[0]).float()
    return out


def _parts_arithmetic(x, dt, A, B_, C_, chunk, terms=None, p_parts=3):
    """What the parts route computes, in plain torch (float32 inputs): cs
    the float64 cumulative sums rounded once; G = C B^T; each chunk's
    state term U = (xdt o w)^T B with xdt o w = (x dt) w in f32, w =
    exp(cs[Q-1] - cs), split in three parts; the entering states S' = S
    exp(cs[Q-1]) + U (two f32 roundings); y = exp(cs) o (C S^T) + P x with
    S in three parts and P = (G exp(cs[l] - cs[s])) dt[s] (s <= l) in
    ``p_parts`` parts.  ``terms`` maps a product (G, U, CS, PX) to its
    (A part, B part) terms; the source's six where absent."""
    terms = {k: (terms or {}).get(k, _source_terms()) for k in PRODUCTS}
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(int(chunk), S)
    nc = S // Q
    xp = [p.reshape(Bb, nc, Q, H, P) for p in _parts(x)]
    bp = [p.reshape(Bb, nc, Q, N) for p in _parts(B_)]
    cp = [p.reshape(Bb, nc, Q, N) for p in _parts(C_)]
    dtc = dt.float().reshape(Bb, nc, Q, H)
    cs = ref.cumsum((dt.float() * A.float()).reshape(Bb, nc, Q, H), dim=2)
    G = _product(cp, bp, terms["G"], "bcln,bcsn->bcls")
    w = torch.exp(cs[:, :, -1:] - cs)
    v = (x.float().reshape(Bb, nc, Q, H, P) * dtc[..., None]) * w[..., None]
    U = _product(_parts(v), bp, terms["U"], "bcshp,bcsn->bchpn")
    e = torch.exp(cs[:, :, -1])
    states, st = [], torch.zeros((Bb, H, P, N))
    for c in range(nc):
        states.append(st)
        st = st * e[:, c, :, None, None] + U[:, c]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    cst = cs.transpose(2, 3)                                  # (B,nc,H,Q)
    seg = torch.where(tril, cst[..., :, None] - cst[..., None, :], 0.0)
    L = torch.where(tril, torch.exp(seg), 0.0)
    Pm = (G[:, :, None] * L) * dtc.transpose(2, 3)[..., None, :]
    ypx = _product(_parts(Pm, p_parts), xp, terms["PX"],
                   "bchls,bcshp->bclhp")
    ys = _product(cp, _parts(torch.stack(states, 1)), terms["CS"],
                  "bcln,bchpn->bclhp")
    y = torch.exp(cs)[..., None] * ys + ypx
    return y.reshape(Bb, S, H, P), st


def _share(want, got):
    """The largest |got - want| as a share of 1e-4 + 1e-4 |want|."""
    want = torch.as_tensor(np.array(want, np.float32))
    return float(((got.float() - want).abs() / (TOL + TOL * want.abs()))
                 .max())


@lru_cache(maxsize=None)
def _mamba2_row():
    """The mamba2 float32 row's inputs, the plain version and the exact
    recurrence."""
    B, S, H, P, N, chunk = MAMBA2_F32
    _, targs = _inputs(S + H + P, B, S, H, P, N)
    return targs, ref.ssd(*targs, chunk=chunk), _exact(*targs)


def _mamba2_share(**kw):
    targs, (yr, sr), _ = _mamba2_row()
    y, st = _parts_arithmetic(*targs, MAMBA2_F32[-1], **kw)
    return max(_share(yr, y), _share(sr, st))


# ------------------------------------------------------------- the split

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [5, 64, 100, 128])
def test_split_parts_sum_exactly_to_the_input(dtype, D):
    """Three bf16 parts (hi, mid, lo) in columns [0, DP), [DP, 2 DP),
    [2 DP, 3 DP), zeros past D; hi + mid + lo is the input bit for bit,
    over magnitudes 2^-100 .. 2^100 and zeros."""
    g = np.random.default_rng(D)
    t = (g.standard_normal((3, 7, D)) *
         2.0 ** g.integers(-100, 100, (3, 7, D))).astype(np.float32)
    t[0, 0, :3] = 0.0
    t = torch.from_numpy(t).to(dtype)
    p = ref.split_parts(t)
    DP = -(-D // 64) * 64
    assert p.dtype == torch.bfloat16 and p.shape == (3, 7, 3 * DP)
    assert torch.equal(ref.join_parts(p, D), t.float())
    assert not p.reshape(3, 7, 3, DP)[..., D:].any()
    if dtype == torch.bfloat16:                 # mid and lo are zero
        assert not p.reshape(3, 7, 3, DP)[..., 1:, :].any()


def test_split_layout_and_the_cpu_wrapper():
    """``ref.split``: x's parts (B, S, H, 3 DP) and B's and C's stacked as
    heads 0 and 1 (B, S, 2, 3 NP), the shapes ``ops.parts_shapes`` gives;
    ``ops.ssd_split`` on CPU tensors is it, with no launch counted;
    ``ops.ssd_parts`` runs only on the card (``ops.ssd`` takes the plain
    scan on the CPU) and refuses CPU tensors."""
    (_, targs) = _inputs(3, 2, 64, 3, 80, 16)
    x, dt, A, B_, C_ = targs
    before = ops.ssd_split.launches, ops.ssd.launches
    xp, bcp = ops.ssd_split(x, B_, C_)
    assert (tuple(xp.shape), tuple(bcp.shape)) == ops.parts_shapes(x, B_) \
        == ((2, 64, 3, 3 * 128), (2, 64, 2, 3 * 64))
    assert torch.equal(ref.join_parts(xp, 80), x)
    assert torch.equal(ref.join_parts(bcp[:, :, 0], 16), B_)
    assert torch.equal(ref.join_parts(bcp[:, :, 1], 16), C_)
    with pytest.raises(ValueError, match="card"):
        ops.ssd_parts(x, dt, A, B_, C_, (xp, bcp), 16)
    assert (ops.ssd_split.launches, ops.ssd.launches) == before


def test_scratch_shapes():
    """The parts kernels' scratch at mamba2-780m's prefill shape: G in the
    y kernel's fragment order (64 KB a (b, chunk)), the chunks' state
    terms (50.3 MB), exp(cs[Q-1]) a chunk."""
    sh = ops.parts_scratch_shapes(4, 1024, 48, 64, 128, 128)
    assert sh == {"g": (4, 8, 4, 128, 32), "u": (4, 48, 8, 64, 128),
                  "e": (4, 48, 8)}
    assert 4 * math.prod(sh["u"]) == 50_331_648
    assert ops.parts_scratch_shapes(1, 40, 2, 12, 5, 40)["u"] == \
        (1, 2, 1, 64, 64)


# ------------------------------------------------- the route's arithmetic

def test_terms_are_the_six_down_to_two_to_the_minus_16():
    """Every product sums lo.hi, mid.mid, hi.lo, mid.hi, hi.mid and hi.hi,
    smallest first, hi.hi last (its own accumulator)."""
    assert _source_terms() == [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1),
                               (0, 0)]


@pytest.mark.parametrize("case", SSD_CASES)
def test_parts_arithmetic_within_half_the_tolerance_of_the_kernel(case):
    """At the reference's four cases: within half of 1e-4 + 1e-4 |want| of
    ``ssd_fwd`` in interpret mode, y and the final state."""
    B, S, H, P, N, chunk = case
    (xj, dtj, Aj, Bj, Cj), targs = _inputs(S + H + P, B, S, H, P, N)
    yk, sk = ssd_kernel.ssd_fwd(xj, dtj, Aj, Bj, Cj, chunk=chunk)
    y, st = _parts_arithmetic(*targs, chunk)
    assert max(_share(yk, y), _share(sk, st)) <= 0.5


def test_parts_arithmetic_at_the_mamba2_float32_row():
    """chip_smoke.py's "mamba2 shape, float32" row at its 48 heads: within
    half the tolerance of the plain version, and as near the exact float64
    recurrence as the plain version is (within 5% of its distance: both
    lie ~1.6 of the tolerance from it there, float32's own rounding of
    sums of 128 terms up to ~100)."""
    targs, (yr, sr), (ye, se) = _mamba2_row()
    y, st = _parts_arithmetic(*targs, MAMBA2_F32[-1])
    assert _mamba2_share() <= 0.5
    assert max(_share(ye, y), _share(se, st)) <= \
        1.05 * max(_share(ye, yr), _share(se, sr))


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("dropped", [(2, 0), (1, 1), (0, 2)])
def test_a_term_fewer_misses(product, dropped):
    """The six are the fewest: without any one of a product's three
    2^-16 terms the mamba2 float32 row misses half the tolerance."""
    terms = [t for t in _source_terms() if t != dropped]
    assert _mamba2_share(terms={product: terms}) > 0.5


def test_p_in_two_parts_misses():
    """P = C B^T o L o dt in two parts (hi and the rest rounded once, its
    lo terms gone) misses half the tolerance at the mamba2 row."""
    assert _mamba2_share(p_parts=2,
                         terms={"PX": [t for t in _source_terms()
                                       if t[0] != 2]}) > 0.5


# ----------------------------------------------------- the C source

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_limits_match_the_c_launcher():
    """The launcher refuses past 128 in P, N and the chunk (the wrapper's
    limits) and takes NP 64 up to N = 64, else 128."""
    limit = re.search(r"constexpr int MAXDIM = (\d+);", SRC)
    assert int(limit.group(1)) == ops.MAX_HEAD_DIM == ops.MAX_STATE == \
        ops.MAX_CHUNK
    assert re.search(r"N <= 64 \? launch_parts<64>\([^;]*launch_parts<128>",
                     SRC)
    for bad in ("P > MAXDIM", "N > MAXDIM", "chunk > MAXDIM", "S % chunk"):
        assert bad in SRC


def test_shared_memory_table_matches_the_instances():
    """Each kernel's shared memory at NP 64 and 128 fits a block's
    232,448 bytes, with the totals the source's table gives; [build] in
    chip_smoke.py requires exactly these instances and the split's four."""
    QP, BLK = 128, 128 * 128
    for NP in (64, 128):
        NT = NP // 64
        smem = {"g": 6 * NT * BLK + 8 + 1024,
                "state": 3 * BLK + 3 * NT * BLK + 2 * QP * 4 + 8 + 1024,
                "y": 3 * NT * BLK + 3 * BLK + 3 * NT * 64 * 128 + 3 * QP * 4
                + 8 + 1024}
        for kernel, n in smem.items():
            assert n <= 232448
            row = re.search(rf"//\s+ssd_parts_{kernel}_kernel<NP>:.*?"
                            rf"([\d,]+) / ([\d,]+)\n", SRC)
            assert int(row.group(1 if NP == 128 else 2).replace(",", "")) \
                == n, (kernel, NP)
    assert _chip_smoke().SSD_PARTS_INSTANCES == tuple(
        f"ssd_parts_{k}_kernel<{np_}>" for k in ("g", "state", "y")
        for np_ in (64, 128))


def test_kernels_are_named_for_the_profilers_group():
    """The route's kernels start with ``ssd_parts_``, which chip_smoke.py's
    training profile gathers as "SSD forward" and its serving profile as
    ssd_scan's."""
    names = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                           r"(\w+)\(", SRC))
    assert names == {"ssd_parts_split_kernel", "ssd_parts_g_kernel",
                     "ssd_parts_state_kernel", "ssd_parts_scan_kernel",
                     "ssd_parts_y_kernel"}
    cs = _chip_smoke()
    groups = dict(cs.TRAIN_GROUPS)
    assert all(any(p in n for p in groups["SSD forward"]) for n in names)
    assert all(any(p in n for p in cs.DEVICE_KERNELS["ssd_scan"])
               for n in names)


@pytest.mark.parametrize("dtype,want", [
    ("float32", {"wgmma": 0, "parts": 4}),
    ("bfloat16", {"wgmma": 4, "parts": 0})])
def test_train_step_forward_launches_by_route(dtype, want):
    """mamba2-780m's step at depth 2: four forwards (two a layer under
    remat), all on the route of the config's dtype; the float32 step's
    backward on the SIMT route."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("mamba2-780m").replace(n_layers=2, dtype=dtype)
    cs = _chip_smoke()
    assert cs.train_ssd_routes(cfg) == want
    assert cs.train_launches(cfg) == {"ssd_scan": 4, "ssd_bwd": 2}
    assert not any(cs.train_fwd_routes(cfg).values())    # no attention
    assert cs.train_ssd_bwd_routes(cfg) == (
        {"simt": 2, "wgmma": 0} if dtype == "float32" else
        {"simt": 0, "wgmma": 2})


def test_float32_bounds_at_mamba2_prefill():
    """The timed row's bounds: the function's 8.13 GFLOP at 67 TFLOP/s,
    the split's bytes at 3.35 TB/s, the parts kernels' six bf16 terms a
    product at 989 TFLOP/s, and the route's (their sum)."""
    cs = _chip_smoke()
    b = cs.ssd_f32_bounds(4, 1024, 48, 64, 128, 128)
    flops = 4 * 48 * 8 * (128 * 129 * 64 + 4 * 128 * 64 * 128) + \
        4 * 8 * 128 * 129 * 128
    assert b["flops"] == flops
    assert b["function"] == (pytest.approx(1e3 * flops / 67e12),
                             "operations")
    elems = 4 * 1024 * (48 * 64 + 2 * 128)
    assert b["split"][2] == elems * 10
    assert b["parts"][0] == pytest.approx(1e3 * 6 * flops / 989e12)
    assert b["route"][0] == pytest.approx(b["split"][0] + b["parts"][0])
