"""The port's encoder-decoder model and modality front ends against the
JAX reference on the CPU: the cross-attention block, the encoder, the
whisper-tiny forward with its caches (the self rings and the bfloat16
cross K/V, bfloat16 even in a float32 model), the decode step over the
cached cross K/V and the cache layout; the phi-3-vision patch prefix
through the forward, and its engine, whose ring and decode positions do
not count the patches (the reference's, reproduced: see
``serve/engine.py``).  Weights are the reference's ``init_params`` draws
carried across with ``params_from_reference``; other inputs are made with
numpy from a seed.

Tolerances, with their reasons (those of tests/test_torch_serving.py):
  * F32 (1e-4 absolute on logits of magnitude ~1.5, block outputs and
    encoder states): float32 on both sides, GEMMs summed in other orders;
    the decode caches (self rings, cross K/V) are bfloat16 in both, so a
    value a float32 ulp apart can round to a neighbouring bfloat16 value.
    Cache entries: F32 plus one bfloat16 ulp (2**-7) relative.
    Measured: logits within 9e-7, prefill and decode, on whisper-tiny's
    and phi-3-vision's smoke configs.
  * BF16 (0.08 absolute on logits and block outputs, 0.16 on cache
    entries): XLA fuses chains of bfloat16 elementwise ops and rounds
    once where torch rounds after each op.  Measured: logits within
    0.018 (prefill) and 0.016 (decode).
  * Greedy tokens of the engines: equal in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import (F32, _caches_close, _close, _leaves, _np,
                                _pair, _port_engine, _ref_engine_loop,
                                _setup, _tokens)

from repro.models import api as japi
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.serve import engine as jengine
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api as tapi
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.serve import step as tstep

torch.set_num_threads(1)

BF16, BF16_CACHE = 0.08, 0.16
TOL = {"float32": F32, "bfloat16": BF16}
WHISPER, PHI3V = "whisper-tiny", "phi-3-vision-4.2b"


def _frames(cfg, B, seed):
    """Frame (or patch) embeddings (B, frontend_len, d_model), float32."""
    return _pair((B, cfg.frontend_len, cfg.d_model), seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_block(dtype):
    cj, ct, pj, pt = _setup(WHISPER, dtype)
    bj = jax.tree_util.tree_map(lambda x: x[1], pj["dec"]["cross"])
    bt = {k: v[1] for k, v in pt["dec"]["cross"].items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = _pair((2, 5, cj.d_model), 1)
    ej, et = _frames(cj, 2, 2)
    pos = np.tile(np.arange(5), (2, 1))
    want, none_j = JL.attn_apply(cj, bj, xj.astype(jdt),
                                 positions=jnp.asarray(pos),
                                 kv_source=ej.astype(jdt))
    before = fa_ops.flash_attention.launches
    got, none_t = TL.attn_apply(ct, bt, xt.to(tdt),
                                positions=torch.from_numpy(pos),
                                kv_source=et.to(tdt))
    assert none_j is None and none_t is None
    assert fa_ops.flash_attention.launches == before     # no kernel
    assert got.dtype == tdt
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_states(dtype):
    cj, ct, pj, pt = _setup(WHISPER, dtype)
    fj, ft = _frames(cj, 2, 3)
    want = JED.encode(cj, pj, fj.astype(jnp.bfloat16))
    got = TED.encode(ct, pt, ft.to(torch.bfloat16))
    assert got.dtype == getattr(torch, dtype)
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_forward_caches_and_decode_step(dtype):
    cj, ct, pj, pt = _setup(WHISPER, dtype)
    tol = TOL[dtype]
    toks = _tokens(cj, 2, 9, 4)
    fj, ft = _frames(cj, 2, 5)
    fj, ft = fj.astype(jnp.bfloat16), ft.to(torch.bfloat16)
    cache_len = 13
    lj, auxj, cachej = japi.forward_logits(
        cj, pj, {"tokens": jnp.asarray(toks), "frames": fj},
        want_caches=True, cache_len=cache_len)
    lt, aux, cachet = tapi.forward_logits(
        ct, pt, {"tokens": torch.from_numpy(toks), "frames": ft},
        want_caches=True, cache_len=cache_len)
    assert lt.dtype == getattr(torch, dtype)
    assert float(aux) == 0.0 == float(auxj)
    _close(lj, lt, tol)
    assert (lt[..., cj.vocab_size:] == -1e9).all()
    # the cross K/V are bfloat16 even in a float32 model, as the
    # reference casts them (and its decode reads them back up)
    for name in ("cross_k", "cross_v"):
        assert cachet[name].dtype == torch.bfloat16
        assert cachet[name].shape == (cj.n_layers, 2, cj.frontend_len,
                                      cj.n_kv_heads, cj.head_dim)
    _caches_close(cachej, cachet, tol)
    for step, tok in enumerate(([[5], [7]], [[11], [3]], [[2], [2]])):
        cur = 9 + step
        tok = np.array(tok, np.int32)
        dj, cachej = japi.decode_step(cj, pj, jnp.asarray(tok), cachej,
                                      jnp.asarray(cur, jnp.int32))
        cross = cachet["cross_k"].clone()
        dt, cachet = tapi.decode_step(ct, pt, torch.from_numpy(tok), cachet,
                                      cur)
        assert torch.equal(cachet["cross_k"], cross)   # static
        _close(dj, dt, tol)
    _caches_close(cachej, cachet, tol)


def test_encdec_init_caches_match_the_reference_layout():
    cj, ct, _, _ = _setup(WHISPER, "float32")
    want = dict(_leaves(japi.init_caches(cj, 3, 13)))
    got = dict(_leaves(tapi.init_caches(ct, 3, 13)))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert np.array_equal(got[path].float().numpy(), _np(w)), path
        assert str(got[path].dtype) == f"torch.{w.dtype}", path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_prefix_through_the_forward(dtype):
    """Patches are prepended, positions run over them, the logits are the
    tokens' only, and the rings hold the whole sequence's K/V."""
    cj, ct, pj, pt = _setup(PHI3V, dtype)
    tol = TOL[dtype]
    toks = _tokens(cj, 2, 7, 8)
    pj_, pt_ = _frames(cj, 2, 9)
    S = cj.frontend_len + 7
    lj, _, cachej = japi.forward_logits(
        cj, pj, {"tokens": jnp.asarray(toks), "patches": pj_},
        attn_impl="pallas", want_caches=True, cache_len=S + 3)
    before = fa_ops.flash_attention.launches
    lt, _, cachet = tapi.forward_logits(
        ct, pt, {"tokens": torch.from_numpy(toks), "patches": pt_},
        want_caches=True, cache_len=S + 3)
    assert fa_ops.flash_attention.launches == before
    assert lt.shape == (2, 7, cj.padded_vocab)
    _close(lj, lt, tol)
    _caches_close(cachej, cachet, tol)
    assert cachet["groups"]["l0"]["pos"][0].tolist() == \
        list(range(S)) + [-1] * 3
    # the patches change the tokens' logits
    plain, _, _ = tapi.forward_logits(ct, pt,
                                      {"tokens": torch.from_numpy(toks)})
    assert (plain - lt).abs().max() > 10 * tol


PROMPTS = [(list(range(3, 12)), 4), (list(range(40, 45)), 3),
           (list(range(100, 113)), 4), ([7, 8, 9], 2)]


def test_phi3_vision_engine_keeps_the_references_ring_and_positions():
    """The engine's ring is max_prompt + max_gen long and decode runs at
    max_prompt + step - 1, not counting the 8 smoke patches: the prefill
    (8 + 13 positions) overflows the ring (17 slots), which keeps
    positions 4..20; decode at 13..15 sees those up to its own position
    only (14..20 are masked from the first step).  The port's greedy tokens equal the reference
    engine's, fault and all (float32)."""
    cj, ct, pj, pt = _setup(PHI3V, "float32")
    eng = jengine.BatchingEngine(cj, pj, max_batch=4, temperature=0.0)
    for p, g in PROMPTS:
        eng.submit(p, gen_len=g)
    want = [r.output for r in eng.run()]
    loop, _ = _ref_engine_loop(cj, pj, PROMPTS, 4)
    assert loop == want
    got, _ = _port_engine(ct, pt, PROMPTS, 4)
    assert got == want
    # the round's prefill ring: positions 4..20 kept, rolled into place
    toks = np.zeros((4, 13), np.int64)
    for i, (p, _) in enumerate(PROMPTS):
        toks[i, 13 - len(p):] = p
    batch = tstep.model_inputs(ct, torch.from_numpy(toks))
    assert batch["patches"].shape == (4, 8, ct.d_model)
    _, _, caches = tapi.forward_logits(ct, pt, batch, want_caches=True,
                                       cache_len=13 + 4)
    pos = caches["groups"]["l0"]["pos"][0]
    assert sorted(pos.tolist()) == list(range(4, 21))
    assert int((pos > 13).sum()) == 7         # masked from the first step


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                                  WHISPER, PHI3V])
def test_serve_launcher_serves_the_new_families_on_the_cpu(arch):
    from repro_torch.launch import serve
    summary = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                          "3", "--prompt", "6", "--gen", "3", "--batch", "2"])
    assert summary["n"] == 3 and summary["tokens_per_s"] > 0
