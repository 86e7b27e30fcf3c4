"""The port's Mamba2 and hybrid serving path against the JAX reference on
the CPU: the Mamba2 block's pieces (softplus, the causal conv and its
decode step, the one-token SSD step), ``mamba_apply`` in full and decode
mode, the full forward with its caches, the decode step, the cache layout
and the batching engine, on the mamba2-780m and zamba2-7b smoke configs
(zamba2 brings the shared attention block and its per-application KV
rings).  The reference runs its Pallas SSD kernel (``ssd_impl="pallas"``,
interpret mode), whose semantics the port's default route has.  Weights
are the reference's ``init_params`` draws carried across with
``params_from_reference``; other inputs are made with numpy from a seed.

Tolerances, with their reasons:
  * F32 (1e-4 absolute): both sides compute in float32; the conv caches
    are bfloat16 in both even in a float32 model, so a decode step carries
    bfloat16 rounding of values a float32 ulp apart, as the KV caches do
    in tests/test_torch_serving.py.  Measured: logits within 1.3e-5
    (decode), 1.7e-6 (prefill).  Cache entries: F32 plus one bfloat16 ulp
    (2**-7) relative (measured: SSD state 1.3e-4 at a value near 2, conv
    histories one bfloat16 ulp).
  * BF16 (0.16 absolute on logits and block outputs; cache entries 0.16
    plus 2**-6 relative): XLA fuses chains of bfloat16 elementwise ops
    (the conv's shifted products, silu, the gate) and rounds once where
    torch rounds after each op.  Measured: logits within 0.06 (zamba2,
    prefill), cache entries within 0.10 (zamba2's V ring), SSD states
    within 0.04.
  * Greedy tokens: equal to the reference's in float32; in bfloat16 a
    token may differ only at a near tie of the reference's own logits
    (its pick within BF16 of the port's pick), as for granite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import (_close, _leaves, _np, _pair, _port_engine,
                                _ref_engine_loop, _setup, _tokens)

from repro.models import api as japi
from repro.models import mamba2 as JM
from repro.serve import engine as jengine
from repro_torch.configs import registry as treg
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import mamba2 as TM
from repro_torch.serve import step as tstep

torch.set_num_threads(1)

F32, BF16 = 1e-4, 0.16
BF16_ULP = 2.0 ** -7
TOL = {"float32": F32, "bfloat16": BF16}
ARCHS = ["mamba2-780m", "zamba2-7b"]


def _caches_close(cj, ct, dtype):
    """Cache trees equal in layout, dtypes and positions; entries within
    the docstring's tolerances."""
    atol, rtol = (F32, BF16_ULP) if dtype == "float32" else (BF16,
                                                            2 * BF16_ULP)
    want, got = dict(_leaves(cj)), dict(_leaves(ct))
    assert want.keys() == got.keys()
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype) == f"torch.{w.dtype}", path
        if path[-1] == "pos":
            assert np.array_equal(g.numpy(), np.asarray(w)), path
        else:
            _close(w, g, atol, rtol=rtol)


def _block(arch, dtype):
    """Group 0's first Mamba2 block: (ref cfg, port cfg, ref, port)."""
    cj, ct, pj, pt = _setup(arch, dtype)
    bj = jax.tree_util.tree_map(lambda x: x[0], pj["groups"]["l0"])
    bt = {k: v[0] for k, v in pt["groups"]["l0"].items()}
    return cj, ct, bj, bt


# ------------------------------------------------------------- pieces


def test_softplus_is_jax_softplus_beyond_torchs_threshold():
    x = np.array([-80.0, -20.0, -1.5, 0.0, 0.3, 19.0, 21.0, 35.0, 90.0],
                 np.float32)
    want = jax.nn.softplus(jnp.asarray(x))
    _close(want, TM.softplus(torch.from_numpy(x)), 0.0, rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2 ** -6)])
def test_causal_conv_and_its_decode_step(dtype, tol):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    uj, ut = _pair((2, 9, 6), 1)
    wj, wt = _pair((4, 6), 2, 0.5)
    sj, st = _pair((2, 3, 6), 3)
    uj, ut, wj, wt = uj.astype(jdt), ut.to(tdt), wj.astype(jdt), wt.to(tdt)
    _close(JM.causal_conv(uj, wj), TM.causal_conv(ut, wt), tol * 4)
    want = JM.causal_conv_step(uj[:, 0], sj.astype(jdt), wj)
    got = TM.causal_conv_step(ut[:, 0], st.to(tdt), wt)
    for w, g in zip(want, got):
        _close(w, g, tol * 4)


def test_ssd_decode_step():
    xj, xt = _pair((2, 3, 4), 4)
    dj, dtt = _pair((2, 3), 5)
    aj, at = _pair((3,), 6)
    bj, bt = _pair((2, 5), 7)
    cj, ct = _pair((2, 5), 8)
    sj, st = _pair((2, 3, 4, 5), 9)
    dj, dtt = jax.nn.softplus(dj), TM.softplus(dtt)
    aj, at = -jnp.exp(aj), -torch.exp(at)
    want = JM.ssd_decode_step(xj, dj, aj, bj, cj, sj)
    got = TM.ssd_decode_step(xt, dtt, at, bt, ct, st)
    for w, g in zip(want, got):
        _close(w, g, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_full_and_decode(dtype):
    cj, ct, bj, bt = _block("mamba2-780m", dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = _pair((2, 32, cj.d_model), 10)
    xj, xt = xj.astype(jdt), xt.to(tdt)
    before = ssd_ops.ssd.launches
    want, cache_j = JM.mamba_apply(cj, bj, xj, ssd_impl="pallas",
                                   return_state=True)
    got, cache_t = TM.mamba_apply(ct, bt, xt, return_state=True)
    assert ssd_ops.ssd.launches == before
    _close(want, got, TOL[dtype])
    _caches_close(cache_j, cache_t, dtype)
    no_state = TM.mamba_apply(ct, bt, xt)
    assert no_state[1] is None and torch.equal(no_state[0], got)
    for t in range(2):                  # decode: the cache is updated in place
        want, cache_j = JM.mamba_apply(cj, bj, xj[:, t:t + 1], cache=cache_j)
        got, same = TM.mamba_apply(ct, bt, xt[:, t:t + 1], cache=cache_t)
        assert same is cache_t
        _close(want, got, TOL[dtype])
    _caches_close(cache_j, cache_t, dtype)


# ------------------------------------------------------ forward / decode


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_caches_and_decode_step(arch, dtype):
    cj, ct, pj, pt = _setup(arch, dtype)
    tol = TOL[dtype]
    toks = _tokens(cj, 2, 32, 7)
    cache_len = 40
    lj, _, cachej = japi.forward_logits(
        cj, pj, {"tokens": jnp.asarray(toks)}, ssd_impl="pallas",
        want_caches=True, cache_len=cache_len)
    before = fa_ops.flash_attention.launches, ssd_ops.ssd.launches
    lt, aux, cachet = tapi.forward_logits(
        ct, pt, {"tokens": torch.from_numpy(toks)}, want_caches=True,
        cache_len=cache_len)
    assert (fa_ops.flash_attention.launches, ssd_ops.ssd.launches) == before
    assert lt.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(lj, lt, tol)
    assert (lt[..., cj.vocab_size:] == -1e9).all()
    _caches_close(cachej, cachet, dtype)
    for step, tok in enumerate(([[5], [7]], [[11], [3]])):
        cur = 32 + step
        tok = np.array(tok, np.int32)
        dj, cachej = japi.decode_step(cj, pj, jnp.asarray(tok), cachej,
                                      jnp.asarray(cur, jnp.int32))
        dt, cachet = tapi.decode_step(ct, pt, torch.from_numpy(tok), cachet,
                                      cur)
        _close(dj, dt, tol)
    _caches_close(cachej, cachet, dtype)
    # and the reference's default route (``ssd_chunked``) at S=32, two chunks
    ej, _, _ = japi.forward_logits(cj, pj, {"tokens": jnp.asarray(toks)})
    _close(ej, lt, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_the_reference_layout(arch):
    cj, ct, _, _ = _setup(arch, "bfloat16")
    want = dict(_leaves(japi.init_caches(cj, 3, 13)))
    got = dict(_leaves(tapi.init_caches(ct, 3, 13)))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert np.array_equal(got[path].float().numpy(), _np(w)), path
        assert str(got[path].dtype) == f"torch.{w.dtype}", path


def test_prefill_length_must_be_a_multiple_of_the_chunk():
    """As in the reference: a round whose longest prompt is not a
    multiple of the SSD chunk (16 in the smoke config) raises."""
    _, ct, _, pt = _setup("mamba2-780m", "float32")
    toks = torch.from_numpy(_tokens(ct, 1, 24, 1))
    with pytest.raises(ValueError, match="multiple"):
        tapi.forward_logits(ct, pt, {"tokens": toks})


# ---------------------------------------------------------------- engine


# each round's longest prompt (max_batch 3) is a multiple of 16
PROMPTS = [(list(range(3, 19)), 4), (list(range(40, 45)), 3),   # padded
           (list(range(100, 132)), 4), ([7, 8, 9], 2),
           (list(range(60, 76)), 4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_loop_on_pallas_in_float32(arch):
    cj, ct, pj, pt = _setup(arch, "float32")
    want, _ = _ref_engine_loop(cj, pj, PROMPTS, 3, ssd_impl="pallas")
    before = ssd_ops.ssd.launches
    got, done = _port_engine(ct, pt, PROMPTS, 3)
    assert ssd_ops.ssd.launches == before
    assert got == want
    assert all(len(r.output) == g for r, (_, g) in zip(done, PROMPTS))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine_in_bfloat16(arch):
    cj, ct, pj, pt = _setup(arch, "bfloat16")
    eng = jengine.BatchingEngine(cj, pj, max_batch=3, temperature=0.0)
    for p, g in PROMPTS:
        eng.submit(p, gen_len=g)
    want = [r.output for r in eng.run()]
    loop, ref_logits = _ref_engine_loop(cj, pj, PROMPTS, 3)
    assert loop == want                 # the loop is the reference engine's
    got, _ = _port_engine(ct, pt, PROMPTS, 3)
    assert [len(g) for g in got] == [len(w) for w in want]
    for w, g, lgs in zip(want, got, ref_logits):
        at = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if at is not None:              # only at a near tie of the reference
            assert lgs[at][w[at]] - lgs[at][g[at]] <= BF16, (w, g, at)


def test_working_params_keep_the_float32_leaves():
    _, ct, _, pt = _setup("zamba2-7b", "bfloat16")
    w = tstep.working_params(ct, pt)
    m = w["groups"]["l0"]
    for name in ("ln", "gate_ln", "A_log", "dt_bias"):
        assert m[name].dtype == torch.float32, name
        assert torch.equal(m[name], pt["groups"]["l0"][name]), name
    for name in ("wz", "wx", "conv_x", "D", "out"):
        assert torch.equal(m[name],
                           pt["groups"]["l0"][name].to(torch.bfloat16)), name
    assert w["groups"]["l2"] == {}
    assert w["shared_attn"]["attn"]["ln"].dtype == torch.float32
    assert w["shared_attn"]["mlp"]["wi"].dtype == torch.bfloat16


def test_params_from_reference_keeps_the_hybrid_tree():
    """zamba2's tree: empty dicts at the shared-attention positions and
    the top-level ``shared_attn``, stacked over the groups, bit for bit."""
    cj, ct, pj, pt = _setup("zamba2-7b", "float32")
    assert pt["groups"]["l2"] == {} and "shared_attn" in pt
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, pj)))
    got = dict(_leaves(pt))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert np.array_equal(got[path].numpy(), w), path
    specs = dict(_leaves(tapi.param_specs(ct)))
    assert specs.keys() == got.keys()
    assert pt["groups"]["l0"]["wz"].shape[0] == ct.n_groups


def test_serve_launcher_serves_mamba2_on_the_cpu():
    summary = serve.main(["--arch", "mamba2-780m", "--prompt", "32",
                          "--device", "cpu", "--requests", "3", "--gen",
                          "2", "--batch", "2"])
    assert summary["n"] == 3 and summary["tokens_per_s"] > 0
    assert treg.get_smoke_config("mamba2-780m").ssm.chunk == 16


@pytest.mark.parametrize("arch,want", [("mamba2-780m", (48, 0)),
                                       ("zamba2-7b", (54, 27)),
                                       ("granite-3-2b", (0, 40))])
def test_all_layer_kinds_is_the_forward_order(arch, want):
    """Every layer's kind in order, as ``forward`` applies them: the
    Mamba2 layers are the ssd_scan launches of a prefill, the others
    the flash_attention launches."""
    cfg = treg.get_config(arch)
    kinds = cfg.all_layer_kinds()
    assert len(kinds) == cfg.n_layers
    assert (kinds.count("mamba"), cfg.n_layers - kinds.count("mamba")) == want
    if cfg.shared_attn:                 # the tail follows the last group
        assert cfg.replace(n_layers=4).all_layer_kinds() == (
            "mamba", "mamba", "attn", "mamba")
