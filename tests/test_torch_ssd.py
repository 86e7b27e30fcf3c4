"""The port's SSD chunked scan on the CPU (its plain version, which a CPU
tensor takes) against the reference: the Pallas kernel ``ssd_fwd`` in
interpret mode and the model's ``ssd_chunked``, on the reference's own
cases, in float32, bfloat16 and the serving path's mix; the chunk clamp,
the ``S % chunk`` check and the wrapper's other input checks; and the
CUDA wrapper's route rule (``ops.route``) on every shape and layout the
card's checks use.  Inputs are made with numpy from a seed and handed to
both.

Tolerances are the reference's (tests/test_kernels.py), absolute and
relative alike: 1e-4 in float32 (the two sides sum in other orders) and
5e-2 in bfloat16 (the outputs round to bfloat16, and XLA and torch round
the bfloat16 inputs' products at other places).

At chunk 128, the full-width configs' chunk, y reaches ~130 and is a sum
of ~128 terms of that size, so where it nearly cancels, float32 rounding
alone comes near 1e-4 (absolute): the port's plain version and the
reference's kernel are each within 0.72 of that tolerance of the exact
value (the recurrence in float64), and their errors can add up to 1.04 of
it against each other (measured on the cases below).  There each side is
held to the exact value at the reference's tolerance, and the two to each
other at twice it in float32 (the sum of two errors each within it); in
bfloat16 they are held to each other at 5e-2 directly.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import SSD_CASES
from test_torch_cuda import SSD_CARD_CASES, SSD_DTYPES, SSD_EDGE_CASES

from repro.kernels.ssd_scan import kernel as ssd_kernel
from repro.models import mamba2 as JM
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 5e-2, "serving": 5e-2}
# dtypes of x, dt and B/C; A is float32 throughout, as in the reference
TYPES = {"float32": ("float32",) * 3, "bfloat16": ("bfloat16",) * 3,
         "serving": ("bfloat16", "float32", "bfloat16")}


def _inputs(seed, B, S, H, P, N, types="float32"):
    """(jax arrays, torch tensors) of x, dt, A, B_, C_."""
    g = np.random.default_rng(seed)
    arrs = [g.standard_normal((B, S, H, P)),
            np.logaddexp(g.standard_normal((B, S, H)), 0.0),
            -np.exp(g.standard_normal(H) * 0.3),
            g.standard_normal((B, S, N)), g.standard_normal((B, S, N))]
    tx, tdt, tbc = TYPES[types]
    kinds = (tx, tdt, "float32", tbc, tbc)
    arrs = [a.astype(np.float32) for a in arrs]
    return ([jnp.asarray(a).astype(getattr(jnp, k))
             for a, k in zip(arrs, kinds)],
            [torch.from_numpy(a).to(getattr(torch, k))
             for a, k in zip(arrs, kinds)])


def _close(want, got, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("types", list(TYPES))
def test_plain_matches_pallas_kernel_and_ssd_chunked(case, types):
    B, S, H, P, N, chunk = case
    (xj, dtj, Aj, Bj, Cj), targs = _inputs(S + H + P, B, S, H, P, N, types)
    yk, sk = ssd_kernel.ssd_fwd(xj, dtj, Aj, Bj, Cj, chunk=chunk)
    yc, sc = JM.ssd_chunked(xj, dtj, Aj, Bj, Cj, min(chunk, S))
    before = ssd_ops.ssd.launches
    y, state = ssd_ops.ssd(*targs, chunk=chunk)
    assert ssd_ops.ssd.launches == before           # no kernel on a CPU
    assert y.dtype == targs[0].dtype and y.shape == targs[0].shape
    assert state.dtype == torch.float32 and state.shape == (B, H, P, N)
    for want_y, want_s in ((yk, sk), (yc, sc)):
        _close(want_y, y, TOL[types])
        _close(want_s, state, TOL[types])


# B, S, H, P, N, chunk: mamba2-780m's state and zamba2-7b's at chunk 128
CHUNK128_CASES = [(1, 256, 2, 64, 128, 128), (1, 384, 4, 64, 64, 128)]


def _exact(x, dt, A, B_, C_):
    """The SSD recurrence one step at a time in float64:
    ``state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T``,
    ``y_t = state_t C_t``.  Returns (y, final state)."""
    x, dt, A, B_, C_ = (t.double().numpy() for t in (x, dt, A, B_, C_))
    Bb, S, H, P = x.shape
    state = np.zeros((Bb, H, P, B_.shape[-1]))
    y = np.empty_like(x)
    for t in range(S):
        state = state * np.exp(dt[:, t] * A)[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B_[:, t])
        y[:, t] = np.einsum("bhpn,bn->bhp", state, C_[:, t])
    return y, state


@pytest.mark.parametrize("case", CHUNK128_CASES)
@pytest.mark.parametrize("types", list(TYPES))
def test_plain_matches_the_reference_at_chunk_128(case, types):
    B, S, H, P, N, chunk = case
    (xj, dtj, Aj, Bj, Cj), targs = _inputs(S + H + P, B, S, H, P, N, types)
    ref = [ssd_kernel.ssd_fwd(xj, dtj, Aj, Bj, Cj, chunk=chunk),
           JM.ssd_chunked(xj, dtj, Aj, Bj, Cj, chunk)]
    ref = [[torch.from_numpy(np.array(a, np.float32)) for a in r]
           for r in ref]
    got = ssd_ops.ssd(*targs, chunk=chunk)
    tol = TOL[types]
    for outs in ref + [got]:
        for want, g in zip(_exact(*targs), outs):
            _close(want, g, tol)
    pair_tol = 2 * tol if types == "float32" else tol
    for outs in ref:
        for want, g in zip(outs, got):
            _close(want.numpy(), g, pair_tol)


def test_ssd_chunked_carries_an_incoming_state():
    B, S, H, P, N = 2, 32, 3, 16, 8
    (xj, dtj, Aj, Bj, Cj), targs = _inputs(4, B, S, H, P, N)
    s0 = np.random.default_rng(5).standard_normal((B, H, P, N)).astype(
        np.float32)
    want = JM.ssd_chunked(xj, dtj, Aj, Bj, Cj, 16, init_state=jnp.asarray(s0))
    got = ssd_ref.ssd_chunked(*targs, 16, init_state=torch.from_numpy(s0))
    for w, g in zip(want, got):
        _close(w, g, TOL["float32"])


@pytest.mark.parametrize("S,chunk", [(8, 16), (24, 128), (1, 4)])
def test_chunk_is_clamped_to_the_sequence(S, chunk):
    """S < chunk: one chunk of S steps, as ``ssd_fwd`` clamps it."""
    (xj, dtj, Aj, Bj, Cj), targs = _inputs(S, 2, S, 3, 16, 8)
    want = ssd_kernel.ssd_fwd(xj, dtj, Aj, Bj, Cj, chunk=chunk)
    got = ssd_ops.ssd(*targs, chunk=chunk)
    for w, g in zip(want, got):
        _close(w, g, TOL["float32"])
    for a, b in zip(got, ssd_ref.ssd_chunked(*targs, S)):
        assert torch.equal(a, b)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    _, targs = _inputs(0, 1, 24, 2, 16, 8)
    for fn in (ssd_ops.ssd, ssd_ref.ssd):
        with pytest.raises(ValueError, match="multiple"):
            fn(*targs, chunk=16)
    with pytest.raises(ValueError, match="multiple"):
        ssd_ref.ssd_chunked(*targs, 16)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, (x, dt, A, B_, C_) = _inputs(1, 1, 32, 2, 16, 8)
    bad = [
        ((x[0], dt, A, B_, C_), ValueError, "axes"),
        ((x, dt[:, :16], A, B_, C_), ValueError, "do not match"),
        ((x, dt, A[:1], B_, C_), ValueError, "do not match"),
        ((x, dt, A, B_, C_[..., :4]), ValueError, "do not match"),
        ((x.double(), dt, A, B_, C_), ValueError, "float32 or bfloat16"),
        ((x, dt, A, B_, C_.to(torch.bfloat16)), ValueError, "one dtype"),
        ((x, dt, A, B_.numpy(), C_), TypeError, "tensors"),
        ((torch.zeros(1, 32, 2, 130), dt, A, B_, C_), ValueError,
         "head dim"),
        ((x, dt, A, torch.zeros(1, 32, 129), torch.zeros(1, 32, 129)),
         ValueError, "state size"),
        ((torch.zeros(1, 32, 16, 2).transpose(2, 3), dt, A, B_, C_),
         ValueError, "contiguous"),
        ((x[:, :0], dt[:, :0], A, B_[:, :0], C_[:, :0]), ValueError,
         "at least one step"),
    ]
    for args, err, match in bad:
        with pytest.raises(err, match=match):
            ssd_ops.ssd(*args, chunk=16)
    for chunk in (0, 256):
        _, targs = _inputs(2, 1, 256, 2, 16, 8)
        with pytest.raises(ValueError, match="chunk"):
            ssd_ops.ssd(*targs, chunk=chunk)


# --- the CUDA wrapper's route rule (ops.route), a function of dtypes,
# shapes, strides and base addresses that needs no card: meta tensors
# stand in for the card's shapes (their base address reads as 0)

def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(B, S, H, P, N, types):
    """x, B_, C_ of a case as meta tensors (no memory)."""
    tx, _, tbc = types
    return (torch.empty((B, S, H, P), dtype=tx, device="meta"),
            torch.empty((B, S, N), dtype=tbc, device="meta"),
            torch.empty((B, S, N), dtype=tbc, device="meta"))


def _want(types):
    """x, B and C in bfloat16 take the wgmma route, anything else the
    parts route; ``route`` never names the third, "f32" (``ssd_f32_kernel``,
    run only through ``ops.launch``)."""
    return "wgmma" if types[0] == types[2] == torch.bfloat16 else "parts"


@pytest.mark.parametrize("case", SSD_CARD_CASES)
@pytest.mark.parametrize("types", list(SSD_DTYPES))
def test_route_of_the_card_cases(case, types):
    B, S, H, P, N, _ = case
    assert ssd_ops.route(*_meta(B, S, H, P, N, SSD_DTYPES[types])) == \
        _want(SSD_DTYPES[types])


@pytest.mark.parametrize("case", SSD_EDGE_CASES)
def test_route_of_the_card_edge_cases(case):
    B, S, H, P, N, _, types = case
    assert ssd_ops.route(*_meta(B, S, H, P, N, SSD_DTYPES[types])) == "wgmma"


SSD_CHECKS = _chip_smoke().SSD_CHECKS


@pytest.mark.parametrize("check", SSD_CHECKS, ids=[c[0] for c in SSD_CHECKS])
def test_route_of_the_chip_checks(check):
    """Every case of chip_smoke.py's checks, its serving-typed ones (bf16
    x/B/C, f32 dt) on the wgmma route."""
    _, B, S, H, P, N, _, types = check
    assert ssd_ops.route(*_meta(B, S, H, P, N, types)) == _want(types)


def _views(name):
    """(x, B_, C_) of a layout case, real CPU tensors (bfloat16)."""
    bf = torch.bfloat16
    x = torch.zeros((2, 16, 8, 64), dtype=bf)
    bc = torch.zeros((2, 16, 2 * 128), dtype=bf)
    B_, C_ = bc[..., :128], bc[..., 128:]
    if name == "head-strided x, B and C of one projection":
        return x[:, :, ::2], B_, C_
    if name == "x one element past an aligned base":
        buf = torch.zeros(x.numel() + 1, dtype=bf)
        return buf[1:].view(x.shape), B_, C_
    if name == "x's head stride 66 elements":
        return torch.zeros((2, 16, 8, 66), dtype=bf)[..., :64], B_, C_
    if name == "C 24 bytes past B (N = 12)":
        bc12 = torch.zeros((2, 16, 24), dtype=bf)
        return torch.zeros((2, 16, 8, 64), dtype=bf), bc12[..., :12], \
            bc12[..., 12:]
    if name == "head dim 12":
        return torch.zeros((2, 16, 8, 12), dtype=bf), B_, C_
    if name == "B and C float32":
        return x, B_.float(), C_.float()
    if name == "x float32":
        return x.float(), B_, C_
    if name == "batch of one with an odd batch stride":
        return torch.zeros((1, 16, 8, 64), dtype=bf).as_strided(
            (1, 16, 8, 64), (3, 512, 64, 1)), B_[:1], C_[:1]
    raise KeyError(name)


@pytest.mark.parametrize("name,want", [
    ("head-strided x, B and C of one projection", "wgmma"),
    ("x one element past an aligned base", "parts"),
    ("x's head stride 66 elements", "parts"),
    ("C 24 bytes past B (N = 12)", "parts"),
    ("head dim 12", "parts"),
    ("B and C float32", "parts"),
    ("x float32", "parts"),
    ("batch of one with an odd batch stride", "wgmma"),
])
def test_route_of_views(name, want):
    """Strided views TMA can read take the wgmma route; an unaligned base,
    a stride or a head dim that is not a multiple of 8 elements, or a
    float32 operand, the parts route (its split reads any strides).  A
    batch of one reads no batch stride, whatever torch reports for it."""
    assert ssd_ops.route(*_views(name)) == want
