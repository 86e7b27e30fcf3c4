"""The SSD scan's backward on the CPU: the port's plain version
``ref.ssd_bwd`` (the vjp written out, no autograd; the CUDA backward
kernels' plain version) against ``jax.vjp`` of the reference's op
``repro.kernels.ssd_scan.ops.ssd`` (its forward the Pallas kernel in
interpret mode, its backward a vjp through the plain chunked scan) and
against autograd through the port's own ``ref.ssd``, on a grid of
shapes and dtypes; and ``SSD.backward`` on CPU tensors taking
``ref.ssd_bwd`` with no launch.  Inputs come from numpy with a seed.

Tolerances: each gradient within 1e-4 of its own largest magnitude
(measured: 5.2e-5 on dA at chunk 128 against the reference, which takes
its cumulative sums in float32, the port in float64; 7.5e-6 elsewhere),
and a bfloat16 gradient besides within one bfloat16 step of itself
(2^-7: both compute in float32 from the same bfloat16 inputs and round
once, so a value on a rounding edge may go either way; a bfloat16 ddt is
the sum of its two paths, x dt and dt A, each rounded first, in both
packages).  A Mamba2 and a hybrid model's reference train state carries
across to the port leaf for leaf.

The reference's backward does not clamp the chunk as its forward does:
``jax.vjp`` of ``ssd`` at a sequence shorter than the chunk raises.  The
port keeps the forward's clamp in both directions, so it is held to the
reference's vjp at the clamped chunk.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jssd_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

torch.set_num_threads(1)

ATOL = 1e-4            # x the gradient's largest magnitude
BF16_RTOL = 2.0 ** -7  # one bfloat16 step

F32 = ("float32",) * 3
MIXED = ("bfloat16", "float32", "bfloat16")    # x and dy, dt and A, B/C
BF16 = ("bfloat16",) * 3
# (B, S, H, P, N, chunk, dtypes, nonzero dstate)
CASES = {
    "4 chunks, N != P": (2, 64, 3, 8, 16, 16, F32, True),
    "4 chunks, zero dstate": (2, 64, 3, 8, 16, 16, F32, False),
    "S < chunk (clamped to 12)": (1, 12, 2, 4, 6, 16, F32, True),
    "H = 1": (2, 48, 1, 8, 4, 16, F32, True),
    "chunk 128": (1, 256, 2, 16, 32, 128, F32, True),
    "bf16 x, B, C and dy": (2, 64, 3, 8, 16, 16, MIXED, True),
    "all bf16": (1, 32, 2, 8, 8, 16, BF16, True),
    "bf16, 3 chunks, zero dstate": (1, 96, 2, 8, 12, 32, MIXED, False),
}
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case):
    """(x, dt, A, B_, C_, dy, dstate) drawn with numpy from a seed, as
    tensors in the case's dtypes (x and dy, dt and A, B and C; dstate
    float32)."""
    Bb, S, H, P, N, _, types, nonzero = case
    g = np.random.default_rng(S + 7 * H + P)
    arrs = [g.standard_normal((Bb, S, H, P)),
            np.log1p(np.exp(g.standard_normal((Bb, S, H)))),
            -np.exp(0.3 * g.standard_normal(H)),
            g.standard_normal((Bb, S, N)), g.standard_normal((Bb, S, N)),
            g.standard_normal((Bb, S, H, P)),
            g.standard_normal((Bb, H, P, N)) if nonzero
            else np.zeros((Bb, H, P, N))]
    tx, tdt, tbc = types
    kinds = (tx, tdt, tdt, tbc, tbc, tx, "float32")
    return [torch.from_numpy(a.astype(np.float32)).to(_DT[k])
            for a, k in zip(arrs, kinds)]


def _reference_vjp(ins, chunk):
    """jax.vjp of the reference's ssd at (dy, dstate), at the chunk
    clamped to S (its backward does not clamp)."""
    x, dt, A, Bm, Cm, dy, ds = (
        jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in ins)
    chunk = min(chunk, x.shape[1])
    _, vjp = jax.vjp(lambda *a: jssd_ops.ssd(*a, chunk=chunk),
                     x, dt, A, Bm, Cm)
    return [np.asarray(w.astype(jnp.float32)) for w in vjp((dy, ds))]


def _close(got, want, name):
    """``got`` (torch) within the stated tolerance of ``want`` (numpy
    float32 or torch), in ``got``'s dtype."""
    w = want.float().numpy() if isinstance(want, torch.Tensor) else want
    g = got.float().numpy()
    tol = ATOL * np.abs(w).max() + (
        BF16_RTOL * np.abs(w) if got.dtype == torch.bfloat16 else 0.0)
    assert np.isfinite(g).all(), name
    assert (np.abs(g - w) <= tol).all(), (name, float(np.abs(g - w).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_the_references_vjp(name):
    case = CASES[name]
    ins = _inputs(case)
    got = ssd_ref.ssd_bwd(*ins, chunk=case[5])
    want = _reference_vjp(ins, case[5])
    for label, g, w, t in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                              ins):
        assert g.dtype == t.dtype and g.shape == t.shape, label
        _close(g, w, label)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_autograd_through_the_plain_scan(name):
    case = CASES[name]
    ins = _inputs(case)
    got = ssd_ref.ssd_bwd(*ins, chunk=case[5])
    leaves = [t.clone().requires_grad_() for t in ins[:5]]
    y, state = ssd_ref.ssd(*leaves, chunk=case[5])
    want = torch.autograd.grad((y, state), leaves, (ins[5], ins[6]))
    for label, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype, label
        _close(g, w, label)


def test_reference_backward_does_not_clamp_the_chunk():
    """The reference's vjp raises where S is under the chunk; the port's
    backward clamps, as both forwards do."""
    ins = _inputs(CASES["S < chunk (clamped to 12)"])
    arrs = [jnp.asarray(t.numpy()) for t in ins]
    _, vjp = jax.vjp(lambda *a: jssd_ops.ssd(*a, chunk=16), *arrs[:5])
    with pytest.raises(AssertionError):
        vjp((arrs[5], arrs[6]))
    at16 = ssd_ops.ssd_bwd(*ins, chunk=16)
    at12 = ssd_ref.ssd_bwd(*ins, chunk=12)
    assert all(torch.equal(a, b) for a, b in zip(at16, at12))


def test_ssd_backward_on_cpu_tensors_runs_the_plain_version(monkeypatch):
    case = CASES["bf16 x, B, C and dy"]
    ins = _inputs(case)
    calls = []
    plain = ssd_ref.ssd_bwd

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)
    monkeypatch.setattr(ssd_ref, "ssd_bwd", spy)
    before = (ssd_ops.ssd.launches, ssd_ops.ssd_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in ins[:5]]
    y, state = ssd_ops.ssd(*leaves, chunk=case[5])
    assert y.grad_fn is not None and state.grad_fn is not None
    torch.autograd.backward((y, state), (ins[5], ins[6]))
    assert calls == [ins[0].shape]
    assert (ssd_ops.ssd.launches, ssd_ops.ssd_bwd.launches) == before
    want = plain(*ins, chunk=case[5])
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_ssd_backward_takes_only_what_a_grad_needs():
    """Inputs that do not require a gradient get none."""
    ins = _inputs(CASES["H = 1"])
    x = ins[0].clone().requires_grad_()
    y, _ = ssd_ops.ssd(x, *ins[1:5], chunk=16)
    y.sum().backward()
    assert x.grad is not None and all(t.grad is None for t in ins[1:5])


@pytest.mark.parametrize("bad", ["dy shape", "dstate shape", "dy dtype"])
def test_ssd_backward_raises_on_bad_cotangents(bad):
    ins = _inputs(CASES["H = 1"])
    x, dt, A, Bm, Cm, dy, ds = ins
    if bad == "dy shape":
        dy = dy[:, :-1]
    elif bad == "dstate shape":
        ds = ds[..., :-1]
    else:
        dy = dy.double()
    with pytest.raises(ValueError):
        ssd_ops.ssd_bwd(x, dt, A, Bm, Cm, dy, ds, chunk=16)


@pytest.mark.parametrize("arch,mode", [("mamba2-780m", "fp32"),
                                       ("zamba2-7b", "8bit")])
def test_a_reference_train_state_with_ssm_leaves_carries_across(arch, mode):
    """``train_state_from_reference`` on a Mamba2 or hybrid model's
    reference train state (A_log, D, dt_bias, the conv and projection
    weights, their moments): the port's own state's tree, shapes and
    dtypes, every leaf bit for bit."""
    from repro.configs import registry as jreg
    from repro.distributed.sharding import init_params as jinit
    from repro.models import api as japi
    from repro.optim import adamw as jopt
    from repro.train import step as jstep
    from repro_torch.configs import registry as treg
    from repro_torch.core.interop import train_state_from_reference
    from repro_torch.distributed.sharding import init_params
    from repro_torch.models import api as tapi
    from repro_torch.optim import adamw as topt
    from repro_torch.train import step as tstep

    cj = jreg.get_smoke_config(arch)
    params = jinit(japi.param_specs(cj), jax.random.key(1))
    ocfg = jopt.AdamWConfig(mode=mode, warmup=1)
    state = jstep.init_train_state(cj, ocfg, params)
    grads = jax.tree_util.tree_map(lambda p: 0.01 * jnp.ones_like(p), params)
    _, state["opt"], _ = jax.jit(lambda p, g, o: jopt.adamw_update(
        ocfg, p, g, o))(params, grads, state["opt"])
    want = jax.tree_util.tree_map(np.asarray, state)
    got = train_state_from_reference(want)
    ct = treg.get_smoke_config(arch)
    like = tstep.init_train_state(ct, topt.AdamWConfig(mode=mode),
                                  init_params(tapi.param_specs(ct),
                                              torch.Generator()))

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], prefix + (k,))
        else:
            yield prefix, tree
    got_f, want_f, like_f = (dict(flat(t)) for t in (got, want, like))
    assert got_f.keys() == want_f.keys() == like_f.keys()
    assert any("A_log" in k for k in got_f)
    for k, w in want_f.items():
        g = got_f[k]
        assert tuple(g.shape) == tuple(like_f[k].shape) == w.shape, k
        assert g.dtype == like_f[k].dtype, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(k))


def test_backward_kernels_are_named_for_the_profilers_group():
    """Every kernel of the backward's sources (both routes) starts with
    ``ssd_bwd_``, which chip_smoke.py's training profile gathers as "SSD
    backward" (and its SSD_BWD_KERNELS names each); no forward kernel
    does."""
    csrc = pathlib.Path(ssd_ops.__file__).resolve().parents[2] / "csrc"
    pattern = r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)\("
    simt = set(re.findall(pattern, (csrc / "ssd_scan_bwd.cu").read_text()))
    assert simt == {"ssd_bwd_scan_kernel", "ssd_bwd_rows_kernel",
                    "ssd_bwd_cols_kernel", "ssd_bwd_dt_kernel",
                    "ssd_bwd_reduce_kernel"}
    names = simt | set(re.findall(
        pattern, (csrc / "ssd_scan_bwd_wgmma.cuh").read_text()))
    assert all(n.startswith("ssd_bwd_") for n in names)
    forward = set(re.findall(pattern, (csrc / "ssd_scan.cu").read_text()))
    assert forward and not any("ssd_bwd" in n for n in forward)
    smoke = (csrc.parents[2] / "chip_smoke.py").read_text()
    listed = re.search(r"SSD_BWD_KERNELS = \(([^)]*)\)", smoke).group(1)
    assert {n.split("<")[0] for n in re.findall(r'"([^"]+)"', listed)} == \
        names
