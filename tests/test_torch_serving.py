"""The port's serving path against the JAX reference on the CPU: configs,
model layers, the full forward with its caches and the decode step here,
sampling and the batching engine in tests/test_torch_serving_engine.py
(with this file's helpers and tolerances), on the granite-3-2b and gemma3-27b smoke configs
(gemma3 brings local windows, ring rolls and gelu), the MoE ones
(qwen2-moe-a2.7b, llama4-scout-17b-a16e) and phi-3-vision-4.2b; the
engine also on whisper-tiny (encoder-decoder) with its frame stub, and
phi-3-vision with its patch stub.  Weights are the
reference's ``init_params`` draws carried across with
``params_from_reference``; other inputs are made with numpy from a seed.

Tolerances, with their reasons:
  * F32 (1e-4 absolute, logits of magnitude ~1.5): both sides compute in
    float32, but the decode caches are bfloat16 in both, and a K value a
    float32 ulp apart can round to neighbouring bfloat16 values; that moves
    decode logits by up to ~3e-5 (measured).  The prefill logits agree to
    ~2e-6.  Cache entries: F32 plus one bfloat16 ulp (2**-7 relative).
  * BF16 (0.08 absolute on logits, 0.16 on cache entries; about twice the
    largest differences measured, 0.043 and 0.090 on the gemma3 smoke
    config): XLA fuses chains of bfloat16 elementwise ops and rounds once
    where torch rounds after each op, and the differences grow over the
    layers.
  * MoE routing (qwen2-moe, llama4-scout): in bfloat16 a token whose
    router sits at a near tie (a kept expert's gate within ROUTE_TIE =
    1e-3 of the next one's) may go to the other expert, since the
    activations feeding the router differ by bfloat16 roundings; its
    logits then differ by far more than BF16 (0.61 measured, at a gap of
    6.3e-5 on the qwen2-moe smoke config, exact attention route).  Such
    positions, and only they, are exempt (``_close_but_at_ties``).
  * Greedy tokens: equal to the reference's in float32.  In bfloat16 the
    smoke models' top two logits are often one or two bfloat16 ulps apart
    (0.004-0.008), inside the noise above, so a token may differ there: the
    test requires every divergence to be such a near tie of the reference's
    own logits (its pick within BF16 of the port's pick).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.serve import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.core.interop import params_from_reference
from repro_torch.distributed.sharding import init_params, param_count
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

F32, BF16, BF16_CACHE = 1e-4, 0.08, 0.16
# a near tie of an MoE router's float32 gates (see _routing_ties)
ROUTE_TIE = 1e-3
BF16_ULP = 2.0 ** -7
# the decoder-only configs held here (MoE: qwen2-moe top-2 with a shared
# expert, llama4-scout top-1; phi-3-vision, served from tokens alone
# here and with its patches in tests/test_torch_encdec.py); the engine
# tests add the encoder-decoder whisper-tiny
ARCHS = ["granite-3-2b", "gemma3-27b", "qwen2-moe-a2.7b",
         "llama4-scout-17b-a16e", "phi-3-vision-4.2b"]
ENGINE_ARCHS = ARCHS + ["whisper-tiny"]
_PARAMS = {}


def _np(x):
    return np.asarray(x, np.float32)


def _close(want, got, tol, rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=tol, rtol=rtol)


def _setup(arch, dtype):
    """(reference cfg, port cfg, reference params, port params)."""
    if (arch, dtype) not in _PARAMS:
        cj = jreg.get_smoke_config(arch).replace(dtype=dtype)
        ct = treg.get_smoke_config(arch).replace(dtype=dtype)
        pj = ref_init_params(japi.param_specs(cj), jax.random.key(0))
        pt = params_from_reference(jax.tree_util.tree_map(np.asarray, pj))
        _PARAMS[arch, dtype] = (cj, ct, pj, pt)
    return _PARAMS[arch, dtype]


def _pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _caches_close(cj, ct, tol):
    """Cache trees equal in layout and positions, entries within ``tol``
    (F32 or BF16, the logits' tolerance) as the docstring sets out."""
    atol, rtol = (F32, BF16_ULP) if tol == F32 else (BF16_CACHE, 0.0)
    want, got = dict(_leaves(cj)), dict(_leaves(ct))
    assert want.keys() == got.keys()
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        if path[-1] == "pos":
            assert np.array_equal(g.numpy(), np.asarray(w)), path
        else:
            assert g.dtype == torch.bfloat16, path
            _close(w, g, atol, rtol=rtol)


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_references(smoke):
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    get = "get_smoke_config" if smoke else "get_config"
    for arch in jreg.ARCH_IDS:
        want = dataclasses.asdict(getattr(jreg, get)(arch))
        assert dataclasses.asdict(getattr(treg, get)(arch)) == want, arch


def test_params_from_reference_keeps_bits_and_stacking():
    tree = {"a": {"w": jnp.arange(12, dtype=jnp.float32).reshape(2, 3, 2) / 7},
            "b": jnp.asarray([0.1, -2.5, 3e-3], jnp.bfloat16)}
    got = params_from_reference(jax.tree_util.tree_map(np.asarray, tree))
    assert got["a"]["w"].dtype == torch.float32
    assert got["a"]["w"].shape == (2, 3, 2)
    assert np.array_equal(got["a"]["w"].numpy(), np.asarray(tree["a"]["w"]))
    assert got["b"].dtype == torch.bfloat16
    assert np.array_equal(got["b"].view(torch.int16).numpy(),
                          np.asarray(tree["b"]).view(np.int16))
    with pytest.raises(ValueError, match="dtype"):
        params_from_reference({"x": np.zeros(2, np.float64)})


def test_init_params_follows_the_specs():
    cfg = treg.get_smoke_config("gemma3-27b")
    specs = tapi.param_specs(cfg)
    ref_specs = japi.param_specs(jreg.get_smoke_config("gemma3-27b"))
    gen = torch.Generator().manual_seed(3)
    params = init_params(specs, gen)
    same = init_params(specs, torch.Generator().manual_seed(3))
    want = dict(_leaves(jax.tree_util.tree_map(
        lambda s: (s.shape, s.dtype, s.init), ref_specs,
        is_leaf=lambda x: hasattr(x, "init"))))
    got = dict(_leaves(params))
    assert want.keys() == got.keys()
    for path, (shape, dtype, init) in want.items():
        t = got[path]
        assert tuple(t.shape) == shape and str(t.dtype) == f"torch.{dtype}"
        assert torch.equal(t, dict(_leaves(same))[path])
        if init == "zeros":
            assert not t.any()
        else:                          # normal / sqrt(fan_in)
            assert abs(float(t.std()) * np.sqrt(shape[-2]) - 1) < 0.1
    assert param_count(specs) == sum(t.numel() for t in got.values())


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2 ** -7)])
def test_rms_norm_and_rope(dtype, tol):
    xj, xt = _pair((2, 5, 4, 16), 1)
    wj, wt = _pair((16,), 2, 0.1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _close(JL.rms_norm(xj.astype(jdt), wj), TL.rms_norm(xt.to(tdt), wt),
           tol * 4)
    pos = np.array([[0, 1, 2, 7, 100]] * 2)
    _close(JL.apply_rope(xj.astype(jdt), jnp.asarray(pos), 10000.0),
           TL.apply_rope(xt.to(tdt), torch.from_numpy(pos), 10000.0),
           tol * 4)


def test_attention_decode_over_a_ring():
    qj, qt = _pair((2, 1, 4, 16), 3)
    kj, kt = _pair((2, 9, 2, 16), 4)
    vj, vt = _pair((2, 9, 2, 16), 5)
    pos = np.array([9, 10, 2, 3, 4, 5, 6, 7, 8], np.int32)
    pos[3] = -1
    for window in (0, 4):
        want = JL.attention_decode(qj, kj, vj, jnp.asarray(pos),
                                   jnp.asarray(10), window=window)
        got = TL.attention_decode(qt, kt, vt, torch.from_numpy(pos), 10,
                                  window=window)
        _close(want, got, 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_attn_and_mlp_blocks(arch, dtype, tol):
    cj, ct, pj, pt = _setup(arch, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    take = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
    bj = take(pj["groups"]["l0"])
    bt = {k: {n: w[0] for n, w in v.items()}
          for k, v in pt["groups"]["l0"].items()}
    xj, xt = _pair((2, 11, cj.d_model), 6)
    xj, xt = xj.astype(jdt), xt.to(tdt)
    posj = jnp.broadcast_to(jnp.arange(11), (2, 11))
    post = torch.arange(11).expand(2, 11)
    window = 5 if cj.local_window else 0
    want, (kj, vj) = JL.attn_apply(cj, bj["attn"], xj, positions=posj,
                                   window=window, attn_impl="pallas",
                                   return_kv=True)
    got, (kt, vt) = TL.attn_apply(ct, bt["attn"], xt, positions=post,
                                  window=window, return_kv=True)
    for w, g in ((want, got), (kj, kt), (vj, vt)):
        _close(w, g, tol)
    if "moe" in bj:                 # the feed-forward half is the MoE block
        _close(JMOE.moe_apply(cj, bj["moe"], xj)[0],
               TMOE.moe_apply(ct, bt["moe"], xt)[0], tol)
    else:
        _close(JL.mlp_apply(cj, bj["mlp"], xj),
               TL.mlp_apply(ct, bt["mlp"], xt), tol)
    # decode: one token written into a 16-slot ring at position 20
    cache_j = JL.make_cache(cj, 2, 16)
    cache_t = TL.make_cache(ct, 2, 16)
    one_j, one_t = xj[:, :1], xt[:, :1]
    want, cj2 = JL.attn_apply(cj, bj["attn"], one_j,
                              positions=jnp.full((2, 1), 20), window=window,
                              cache=cache_j, cur_pos=jnp.asarray(20))
    got, ct2 = TL.attn_apply(ct, bt["attn"], one_t,
                             positions=torch.full((2, 1), 20), window=window,
                             cache=cache_t, cur_pos=20)
    _close(want, got, tol)
    _caches_close(cj2, ct2, tol)


# ------------------------------------------------------ forward / decode


@contextlib.contextmanager
def _routing_ties():
    """The (batch, position) pairs at which some MoE layer of the port's
    forward routed at a near tie: a kept choice's gate within ROUTE_TIE of
    the next expert's.  Yields the set, filled as the forward runs."""
    ties, dispatch = set(), TMOE._top_k_dispatch

    def spy(gates, top_k, capacity):
        g = torch.sort(gates, dim=-1, descending=True).values
        gap = (g[..., :top_k] - g[..., 1:top_k + 1]).min(dim=-1).values
        ties.update(map(tuple, torch.nonzero(gap < ROUTE_TIE).tolist()))
        return dispatch(gates, top_k, capacity)
    TMOE._top_k_dispatch = spy
    try:
        yield ties
    finally:
        TMOE._top_k_dispatch = dispatch


def _close_but_at_ties(want, got, tol, ties):
    """Logits (B,S,V) within ``tol``, but at the positions in ``ties``: a
    bfloat16 MoE model may route a token at a near tie of its router to
    the other expert, as the reference's own rounding could."""
    want, got = _np(want), got.float().numpy()
    off = {(b, s) for b, s in zip(*np.nonzero(
        (np.abs(want - got) > tol).any(-1)))}
    assert off <= ties, (off, ties)
    keep = np.ones(want.shape[:2], bool)
    for b, s in off:
        keep[b, s] = False
    np.testing.assert_allclose(got[keep], want[keep], atol=tol)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_forward_caches_and_decode_step(arch, dtype, tol):
    cj, ct, pj, pt = _setup(arch, dtype)
    toks = _tokens(cj, 2, 21, 7)
    cache_len = 27          # > S for global rings; local rings roll
    lj, auxj, cachej = japi.forward_logits(
        cj, pj, {"tokens": jnp.asarray(toks)}, attn_impl="pallas",
        want_caches=True, cache_len=cache_len)
    before = fa_ops.flash_attention.launches
    lt, aux, cachet = tapi.forward_logits(
        ct, pt, {"tokens": torch.from_numpy(toks)}, want_caches=True,
        cache_len=cache_len)
    assert fa_ops.flash_attention.launches == before
    assert lt.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    # the MoE layers' summed Switch loss (float32 in both; routing from
    # bfloat16 activations may differ in a near tie, so 1e-3 there), a
    # zero without them
    if cj.moe is None:
        assert float(aux) == 0.0 == float(auxj)
    else:
        assert abs(float(aux) - float(auxj)) <= (
            1e-6 if dtype == "float32" else 1e-3) * float(auxj)
    _close(lj, lt, tol)
    assert (lt[..., cj.vocab_size:] == -1e9).all()
    _caches_close(cachej, cachet, tol)
    for step, tok in enumerate(([[5], [7]], [[11], [3]])):
        cur = 21 + step
        tok = np.array(tok, np.int32)
        dj, cachej = japi.decode_step(cj, pj, jnp.asarray(tok), cachej,
                                      jnp.asarray(cur, jnp.int32))
        dt, cachet = tapi.decode_step(ct, pt, torch.from_numpy(tok), cachet,
                                      cur)
        _close(dj, dt, tol)
    _caches_close(cachej, cachet, tol)
    # the port's exact route agrees with the reference's default one
    ej, _, _ = japi.forward_logits(cj, pj, {"tokens": jnp.asarray(toks)})
    with _routing_ties() as ties:
        et, _, _ = tapi.forward_logits(ct, pt,
                                       {"tokens": torch.from_numpy(toks)},
                                       attn_impl="exact")
    _close_but_at_ties(ej, et, tol, ties if dtype == "bfloat16" else set())


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


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_every_arch_builds_the_references_param_specs(arch):
    """Every registry family has its parameter tree in the port: the same
    leaves, shapes, dtypes, logical axes and inits as the reference's."""
    spec = lambda s: (tuple(s.shape), s.dtype, tuple(s.axes), s.init,
                      s.scale)
    want = dict(_leaves(jax.tree_util.tree_map(
        spec, japi.param_specs(jreg.get_config(arch)),
        is_leaf=lambda x: hasattr(x, "init"))))
    specs = tapi.param_specs(treg.get_config(arch))
    got = {p: spec(s) for p, s in _leaves(specs)}
    assert got == want
    assert param_count(specs) == sum(np.prod(w[0]) for w in want.values())


# -------------------------------------------------------------- sampling


# ---------------------------------------------------------------- engine


PROMPTS = [(list(range(3, 12)), 4), (list(range(40, 45)), 3),   # padded
           (list(range(100, 109)), 4), ([7, 8, 9], 2), (list(range(60, 66)), 4)]


def _ref_engine_loop(cfg, params, prompts, max_batch, **impl):
    """The reference engine's round loop (greedy), with its prefill's
    routes (``attn_impl``, ``ssd_impl``) chosen.  Returns each request's
    output and its logits (V,) at every step."""
    outs, logits_of = [], []
    decode = jax.jit(jstep.make_decode_step(cfg))
    for r0 in range(0, len(prompts), max_batch):
        batch = prompts[r0:r0 + max_batch]
        max_prompt = max(len(p) for p, _ in batch)
        max_gen = max(g for _, g in batch)
        toks = np.zeros((len(batch), max_prompt), np.int32)
        for i, (p, _) in enumerate(batch):
            toks[i, max_prompt - len(p):] = p
        prefill = jax.jit(jstep.make_prefill_step(
            cfg, cache_len=max_prompt + max_gen, **impl))
        inputs = {"tokens": jnp.asarray(toks)}
        if cfg.frontend in ("frames", "patches"):    # as the reference's
            inputs[cfg.frontend] = jnp.zeros(        # engine feeds them
                (len(batch), cfg.frontend_len, cfg.d_model), jnp.bfloat16)
        logits, caches = prefill(params, inputs)
        steps = []
        for step in range(max_gen):
            if step:
                logits, caches = decode(params, token, caches,
                                        jnp.asarray(max_prompt + step - 1,
                                                    jnp.int32))
            token = jstep.greedy_sample(logits[:, 0])[:, None]
            steps.append((np.asarray(token[:, 0]), _np(logits[:, 0])))
        for i, (_, g) in enumerate(batch):
            outs.append([int(t[i]) for t, _ in steps[:g]])
            logits_of.append([lg[i] for _, lg in steps[:g]])
    return outs, logits_of


def _port_engine(ct, pt, prompts, max_batch, temperature=0.0):
    eng = tengine.BatchingEngine(ct, pt, max_batch=max_batch,
                                 temperature=temperature)
    for p, g in prompts:
        eng.submit(p, gen_len=g)
    done = eng.run()
    assert [r.rid for r in done] == list(range(len(prompts)))
    assert len(eng.round_stats) == -(-len(prompts) // max_batch)
    return [r.output for r in done], done
