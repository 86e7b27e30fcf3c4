"""The port's training substrate on the CPU against the JAX reference:
AdamW in both state modes, its quantizers and schedule, the synthetic
data pipeline, checkpoints (both ways across the packages, and the
reference's own checkpoint and pipeline tests mirrored on the port),
EF-int8 gradient compression, the flash-attention forward's log-sum-exp
and its backward (the plain versions against ``jnp_impl._fwd`` and
``_bwd_vjp``, and the autograd ``Function`` through ``gradcheck``), and
the SSD scan's autograd backward against the reference's custom VJP.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances, with their measured values:
  * AdamW: 1e-6 relative on floats (measured: one float32 ulp, 1.2e-7 on
    parameters near 1; the global norm sums in another order, so the
    clip factor may differ by an ulp), int8 codes within one step (one
    code flips where a moment sits on a rounding edge; none measured).
  * flash lse and backward, float32: 2e-5 absolute (measured 4.8e-7 on
    lse, 4.3e-6 on gradients of magnitude ~7).  bfloat16: 0.05 absolute on
    gradients (measured 0.031, one bf16 ulp at magnitudes 4-8: the
    reference also rounds q.k, do.v and each block's partial products to
    bf16), 0.01 on lse (measured 0.0066) and the forward's own 2e-2.
  * SSD backward, float32: 1e-4 relative to each gradient's largest
    magnitude (both are vjps through the plain float32 scan; the port's
    cumulative sums run in float64).
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpointer import Checkpointer as JCheckpointer
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.distributed import compression as jcomp
from repro.kernels.flash_attention import jnp_impl
from repro.kernels.ssd_scan import ops as jssd_ops
from repro.optim import adamw as jopt
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.core.interop import train_state_from_reference
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import compression as tcomp
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.optim import adamw as topt

torch.set_num_threads(1)

SHAPES = {"stack": (3, 8, 16), "bias": (16,), "w": (12, 40),
          "sub": {"x": (5, 7)}}


def _draw(g, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(g, v, scale) for k, v in shapes.items()}
    return (g.standard_normal(shapes) * scale).astype(np.float32)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, (tree.numpy() if isinstance(tree, torch.Tensor)
                       else np.asarray(tree))


# ------------------------------------------------------------------ AdamW


@pytest.mark.parametrize("mode", ["fp32", "8bit"])
def test_adamw_update_follows_the_reference(mode):
    g = np.random.default_rng(0)
    p0 = _draw(g, SHAPES)
    kw = dict(lr=1e-2, warmup=2, total_steps=10, mode=mode)
    pj, pt = _jax(p0), _torch(p0)
    sj = jopt.init_opt_state(jopt.AdamWConfig(**kw), pj)
    st = topt.init_opt_state(topt.AdamWConfig(**kw), pt)
    for i in range(4):
        grads = _draw(g, SHAPES, 0.5 if i % 2 else 3.0)   # clipped, then not
        pj, sj, mj = jopt.adamw_update(jopt.AdamWConfig(**kw), pj,
                                       _jax(grads), sj)
        pt, st, mt = topt.adamw_update(topt.AdamWConfig(**kw), pt,
                                       _torch(grads), st)
        assert float(mt["lr"]) == float(mj["lr"])
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
    want, got = dict(_flat({"p": pj, "s": sj})), dict(_flat({"p": pt,
                                                             "s": st}))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape
        if w.dtype == np.int8:
            assert np.abs(got[path].astype(int) - w).max() <= 1, path
        else:
            np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))


def test_quantizers_are_the_references_bit_for_bit():
    g = np.random.default_rng(1)
    for x in (g.standard_normal((6, 300)) * 50,
              np.abs(g.standard_normal((4, 3, 9))) * 1e-3,
              np.float32(-2.5), np.zeros((2, 5))):
        x = np.asarray(x, np.float32)
        for qj, qt, dj, dt in ((jopt.quantize_rowwise, topt.quantize_rowwise,
                                jopt.dequantize_rowwise,
                                topt.dequantize_rowwise),
                               (jopt.quantize_sqrt, topt.quantize_sqrt,
                                jopt.dequantize_sqrt, topt.dequantize_sqrt)):
            cj, sj = qj(jnp.asarray(x))
            ct, s_t = qt(torch.from_numpy(np.array(x)))
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
            np.testing.assert_array_equal(dt(ct, s_t).numpy(),
                                          np.asarray(dj(cj, sj)))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 57, 100, 140])
def test_cosine_schedule_is_the_references(step):
    want = jopt.cosine_schedule(3e-4, 10, 100)(jnp.asarray(step))
    got = topt.cosine_schedule(3e-4, 10, 100)(step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=2e-7)


def test_opt_state_specs_match_init_opt_state():
    from repro_torch.distributed.sharding import ParamSpec
    specs = {"w": ParamSpec((4, 6), axes=("a", "b")),
             "b": ParamSpec((6,), axes=("b",))}
    for mode in ("fp32", "8bit"):
        cfg = topt.AdamWConfig(mode=mode)
        st = topt.init_opt_state(cfg, {"w": torch.zeros(4, 6),
                                       "b": torch.zeros(6)})
        sp = topt.opt_state_specs(cfg, specs)
        got = {p: (tuple(s.shape), s.dtype) for p, s in _flat_specs(sp)}
        want = {p: (a.shape, str(a.dtype)) for p, a in _flat(st)}
        assert got == want


def _flat_specs(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_specs(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_8bit_adamw_tracks_fp32_on_a_quadratic():
    """The reference's own check (tests/test_optim.py) on the port."""
    target = torch.from_numpy(np.random.default_rng(2).normal(
        size=(16, 256)).astype(np.float32))
    results = {}
    for mode in ("fp32", "8bit"):
        cfg = topt.AdamWConfig(lr=5e-2, warmup=1, total_steps=200, mode=mode,
                               weight_decay=0.0)
        p = {"w": torch.zeros((16, 256))}
        state = topt.init_opt_state(cfg, p)
        for _ in range(60):
            grad = {"w": 2 * (p["w"] - target) / target.numel()}
            p, state, _ = topt.adamw_update(cfg, p, grad, state)
        results[mode] = float(((p["w"] - target) ** 2).mean())
    assert results["8bit"] < results["fp32"] * 3 + 1e-3
    assert results["8bit"] < 0.5


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("n_shards,shard_id", [(1, 0), (2, 0), (2, 1)])
def test_batches_are_the_references_bit_for_bit(n_shards, shard_id):
    kw = dict(vocab_size=512, seq_len=64, global_batch=8, seed=3,
              n_shards=n_shards, shard_id=shard_id)
    ref, port = JPipeline(JDataConfig(**kw)), SyntheticPipeline(
        DataConfig(**kw))
    for step in (0, 1, 5, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


CFG = DataConfig(vocab_size=512, seq_len=64, global_batch=8, seed=3)


def test_determinism_and_skip_ahead():
    p1, p2 = SyntheticPipeline(CFG), SyntheticPipeline(CFG)
    for step in (0, 5, 1000):
        assert torch.equal(p1.batch_at(step)["tokens"],
                           p2.batch_at(step)["tokens"])
    assert not torch.equal(p1.batch_at(1)["tokens"],
                           p1.batch_at(2)["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticPipeline(CFG).batch_at(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_shards_are_disjoint_streams():
    a = SyntheticPipeline(DataConfig(**{**CFG.__dict__, "n_shards": 2,
                                        "shard_id": 0})).batch_at(0)
    b = SyntheticPipeline(DataConfig(**{**CFG.__dict__, "n_shards": 2,
                                        "shard_id": 1})).batch_at(0)
    assert a["tokens"].shape[0] == 4
    assert not torch.equal(a["tokens"], b["tokens"])


def test_zipf_skew():
    toks = SyntheticPipeline(CFG).batch_at(0)["tokens"].ravel()
    assert (toks < 32).float().mean() > (toks >= 256).float().mean() * 2


def test_front_end_stub_embeddings():
    cfg = DataConfig(**{**CFG.__dict__, "frontend": "patches",
                        "frontend_len": 16, "d_model": 64})
    b = SyntheticPipeline(cfg).batch_at(0)
    x = b["patches"].float()
    assert b["patches"].dtype == torch.bfloat16 and x.shape == (8, 16, 64)
    assert torch.isfinite(x).all()
    assert abs(float(x.std()) - 0.02) < 2e-3 and abs(float(x.mean())) < 2e-3


# ------------------------------------------------------------ checkpoints


def _ref_state(g):
    """A reference train state in both optimizer modes, with ef_err."""
    params = _jax(_draw(g, SHAPES))
    out = {}
    for mode in ("fp32", "8bit"):
        cfg = jopt.AdamWConfig(mode=mode, warmup=1)
        opt = jopt.init_opt_state(cfg, params)
        _, opt, _ = jopt.adamw_update(cfg, params, _jax(_draw(g, SHAPES)),
                                      opt)
        out[mode] = {"params": params, "opt": opt,
                     "ef_err": _jax(_draw(g, SHAPES, 1e-3))}
    return out


def _equal_trees(want, got):
    want, got = dict(_flat(want)), dict(_flat(got))
    assert want.keys() == got.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


@pytest.mark.parametrize("mode", ["fp32", "8bit"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, mode):
    state = _ref_state(np.random.default_rng(4))[mode]
    JCheckpointer(str(tmp_path), async_write=False).save(state, 7)
    like = train_state_from_reference(
        jax.tree_util.tree_map(lambda a: np.zeros_like(np.asarray(a)),
                               state))
    restored, step = Checkpointer(str(tmp_path)).restore(like)
    assert step == 7
    _equal_trees(jax.tree_util.tree_map(np.asarray, state), restored)


@pytest.mark.parametrize("mode", ["fp32", "8bit"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, mode):
    state = _ref_state(np.random.default_rng(5))[mode]
    port = train_state_from_reference(jax.tree_util.tree_map(np.asarray,
                                                             state))
    _equal_trees(jax.tree_util.tree_map(np.asarray, state), port)
    ck = Checkpointer(str(tmp_path))
    ck.save(port, 12)
    ck.wait()
    restored, step = JCheckpointer(str(tmp_path)).restore(
        jax.tree_util.tree_map(jnp.zeros_like, state))
    assert step == 12
    _equal_trees(jax.tree_util.tree_map(np.asarray, state),
                 jax.tree_util.tree_map(np.asarray, restored))


def test_bfloat16_leaf_round_trips_bit_for_bit(tmp_path):
    x = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save({"p": x}, 1)
    restored, _ = ck.restore({"p": torch.zeros_like(x)})
    assert restored["p"].dtype == torch.bfloat16
    assert torch.equal(restored["p"].view(torch.int16), x.view(torch.int16))


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": {"0": torch.ones((2,)), "1": torch.zeros((3,))}}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    state = _state()
    ck.save(state, 10)
    restored, step = ck.restore(_zeros_like(state))
    assert step == 10
    _equal_trees(state, restored)


def test_snapshot_is_taken_at_save(tmp_path):
    """The port's optimizer writes in place: the async save must not see
    a later update."""
    ck = Checkpointer(str(tmp_path), async_write=True)
    state = _state()
    ck.save(state, 3)
    state["params"]["w"].add_(100.0)
    ck.wait()
    restored, _ = ck.restore(_zeros_like(state))
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))


def test_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ck.save(_state(), s)
    assert ck.completed_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_crash_safety_ignores_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(_state(), 5)
    os.makedirs(tmp_path / "step_9.tmp")          # simulated torn write
    assert ck.latest_step() == 5


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(_state(), 3)
    ck.wait()
    assert ck.latest_step() == 3


# ------------------------------------------------------------ compression


def test_ef_int8_transform_is_the_references():
    g = np.random.default_rng(6)
    params = _draw(g, SHAPES)
    sj = {"ef_err": jcomp.init_error_state(_jax(params))}
    st = {"ef_err": tcomp.init_error_state(_torch(params))}
    for _ in range(3):
        grads = _draw(g, SHAPES)
        gj, sj = jcomp.ef_int8_transform(_jax(grads), sj)
        gt, st = tcomp.ef_int8_transform(_torch(grads), st)
        _equal_trees(jax.tree_util.tree_map(np.asarray, gj), gt)
        _equal_trees(jax.tree_util.tree_map(np.asarray, sj["ef_err"]),
                     st["ef_err"])
    assert tcomp.compression_ratio() == jcomp.compression_ratio()


# ------------------------------------------------ flash forward / backward

# (B, S, H, KV, Dh, causal, window, block): GQA groups 1, 4, 5 and 12;
# causal, window, non-causal; S not a multiple of the reference's block
# (its jnp_impl then runs one block of S); nemotron-4-340b's head dim 192
# and the largest, 256 (the parts kernels' bfloat16 head dims)
FA_CASES = [(2, 64, 4, 4, 16, True, 0, 16), (1, 96, 8, 2, 32, True, 24, 32),
            (2, 48, 5, 1, 16, False, 0, 16), (1, 70, 10, 2, 24, True, 0, 70),
            (1, 40, 4, 1, 64, False, 12, 40),
            (1, 48, 12, 1, 192, True, 0, 16),
            (1, 40, 4, 2, 256, False, 8, 40)]
FA_TOL = {"float32": (2e-5, 2e-5, 2e-5), "bfloat16": (0.01, 2e-2, 0.05)}
# bfloat16 gradients past head dim 128 reach magnitudes of 8 and more,
# where one bf16 step (2**-7 relative: the reference rounds q.k and do.v
# to bf16, the port keeps them in f32) exceeds the absolute tolerance
FA_WIDE_GRAD_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_forward_and_backward_match_jnp_impl(case, dtype):
    B, S, H, KV, Dh, causal, window, blk = case
    g = np.random.default_rng(S + H)
    arrs = [g.standard_normal((B, S, n, Dh)).astype(np.float32)
            for n in (H, KV, KV, H)]
    jdt, tdt = DT[dtype]
    qj, kj, vj, doj = (jnp.asarray(a).astype(jdt) for a in arrs)
    qt, kt, vt, dot = (torch.from_numpy(a).to(tdt) for a in arrs)
    out_j, lse_j = jnp_impl._fwd(qj, kj, vj, causal, window, blk, blk)
    want = jnp_impl._bwd_vjp(causal, window, blk, blk,
                             (qj, kj, vj, out_j, lse_j), doj)
    out_t, lse_t = fa_ops.flash_attention_fwd(qt, kt, vt, causal=causal,
                                              window=window)
    lse_tol, out_tol, grad_tol = FA_TOL[dtype]
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B, H, S)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=lse_tol, rtol=0)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=out_tol,
                               rtol=out_tol)
    wrappers = (fa_ops.fa_bwd_delta, fa_ops.fa_bwd_dkdv, fa_ops.fa_bwd_dq,
                fa_ops.fa_bwd_dq_wgmma, fa_ops.fa_bwd_dkdv_wgmma,
                fa_ops.fa_bwd_prep, fa_ops.fa_bwd_dq_parts,
                fa_ops.fa_bwd_dkdv_parts)
    before = [w.launches for w in wrappers]
    got = fa_ops.flash_attention_bwd(qt, kt, vt, out_t, lse_t, dot,
                                     causal=causal, window=window)
    assert [w.launches for w in wrappers] == before   # no kernel
    rtol = FA_WIDE_GRAD_RTOL[dtype] if Dh > 128 else 0.0
    for w, t, x in zip(want, got, (qt, kt, vt)):
        assert t.dtype == x.dtype and t.shape == x.shape
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(w, np.float32), atol=grad_tol,
                                   rtol=rtol)


@pytest.mark.parametrize("causal,window,G", [(True, 0, 1), (True, 5, 4),
                                             (False, 0, 5), (False, 4, 2)])
def test_flash_autograd_function_passes_gradcheck(causal, window, G):
    g = np.random.default_rng(G + window)
    q, k, v = (torch.from_numpy(g.standard_normal((1, 9, n, 8))
                                ).requires_grad_()
               for n in (2 * G, 2, 2))
    assert q.dtype == torch.float64

    def f(q, k, v):
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        assert out.grad_fn is not None
        return out

    assert torch.autograd.gradcheck(f, (q, k, v))


def test_serving_forward_takes_no_lse_and_keeps_its_values():
    g = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(g.standard_normal((2, 33, n, 16)).astype(
        np.float32)) for n in (6, 3, 3))
    with torch.no_grad():
        plain = fa_ops.flash_attention(q, k, v, causal=True, window=7)
    assert plain.grad_fn is None
    assert torch.equal(plain, fa_ref.flash_attention(q, k, v, causal=True,
                                                     window=7))
    q.requires_grad_()
    assert torch.equal(fa_ops.flash_attention(q, k, v, causal=True,
                                              window=7).detach(), plain)


# ------------------------------------------------------------- SSD autograd


def test_ssd_backward_is_the_references_vjp():
    g = np.random.default_rng(9)
    Bb, S, H, P, N, chunk = 2, 32, 3, 8, 8, 16
    arrs = [g.standard_normal((Bb, S, H, P)),
            g.uniform(0.05, 0.5, (Bb, S, H)), -g.uniform(0.5, 2.0, (H,)),
            g.standard_normal((Bb, S, N)), g.standard_normal((Bb, S, N))]
    arrs = [a.astype(np.float32) for a in arrs]
    dy = g.standard_normal((Bb, S, H, P)).astype(np.float32)
    ds = g.standard_normal((Bb, H, P, N)).astype(np.float32)

    def f(*xs):
        return jssd_ops.ssd(*xs, chunk=chunk)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, state = ssd_ops.ssd(*ins, chunk=chunk)
    assert y.grad_fn is not None and state.grad_fn is not None
    got = torch.autograd.grad((y, state), ins,
                              (torch.from_numpy(dy), torch.from_numpy(ds)))
    for w, t in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), rtol=0)
    assert math.isfinite(float(sum(t.sum() for t in got)))
