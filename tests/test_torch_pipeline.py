"""The port's GPipe pipeline (``distributed/pipeline.py``) against the JAX
reference and against sequential execution on the CPU, mirroring
tests/test_pipeline.py: the (stages, microbatches) cases (2, 4), (4, 8)
and (3, 3), gradients through the pipeline, ``pipeline_stats``; and a
pipeline whose stages are a transformer's layer groups (granite-3-2b's
smoke config at 4 layers, 2 stages of 2) against the reference's pipeline
on the same weights.  Weights and inputs are made with numpy from a seed.

Tolerances: the reference's own, 2e-5 on outputs and 5e-4 on gradients,
against the port's sequential run and the reference's pipeline (float32
matmuls summed in other orders; measured: outputs equal to the sequential
run, 2.8e-7 from the reference's; gradients 4.8e-7 from the sequential
run's, 1.8e-6 from the reference's).  The transformer stages: 1e-4
absolute on the float32 hidden states (the serving tests' F32; measured
4.8e-6), and the port's pipeline bit-identical to its own stages applied
one after another, since each microbatch meets the same stage calls at
the same shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.registry import get_smoke_config as jsmoke
from repro.distributed import pipeline as JP
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import api as japi
from repro.models import transformer as JT
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core.interop import params_from_reference
from repro_torch.distributed.pipeline import (PipelineConfig,
                                              merge_microbatches,
                                              pipeline_forward,
                                              pipeline_stats,
                                              split_microbatches,
                                              stack_stage_params)
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 2e-5, 5e-4


def _setup(S=4, M=8, mb=2, d=16, seed=0):
    g = np.random.default_rng(seed)
    per_stage = tuple({"w": (g.standard_normal((d, d)) * 0.3).astype(
                           np.float32),
                       "b": (g.standard_normal(d) * 0.1).astype(np.float32)}
                      for _ in range(S))
    x = g.standard_normal((M * mb, d)).astype(np.float32)
    return per_stage, x


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _ref_stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _sequential(per_stage, x):
    for p in per_stage:
        x = _stage_fn(p, x)
    return x


@pytest.mark.parametrize("S,M", [(2, 4), (4, 8), (3, 3)])
def test_pipeline_matches_sequential_and_the_reference(S, M):
    per_stage, x = _setup(S=S, M=M)
    cfg = PipelineConfig(n_stages=S, n_microbatches=M)
    tps = tuple(_torch(p) for p in per_stage)
    out = merge_microbatches(pipeline_forward(
        _stage_fn, stack_stage_params(tps),
        split_microbatches(torch.from_numpy(x), M), cfg))
    seq = _sequential(tps, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)
    jps = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in per_stage)
    want = JP.merge_microbatches(JP.pipeline_forward(
        _ref_stage_fn, JP.stack_stage_params(jps),
        JP.split_microbatches(jnp.asarray(x), M),
        JP.PipelineConfig(n_stages=S, n_microbatches=M)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)


def test_pipeline_gradients_match_sequential_and_the_reference():
    per_stage, x = _setup(S=3, M=6, mb=2)
    cfg = PipelineConfig(n_stages=3, n_microbatches=6)
    xt = torch.from_numpy(x)
    stacked = {k: v.requires_grad_() for k, v in stack_stage_params(
        tuple(_torch(p) for p in per_stage)).items()}
    (merge_microbatches(pipeline_forward(
        _stage_fn, stacked, split_microbatches(xt, 6), cfg)) ** 2
     ).sum().backward()
    per = tuple({k: v.requires_grad_() for k, v in _torch(p).items()}
                for p in per_stage)
    (_sequential(per, xt) ** 2).sum().backward()
    jstacked = JP.stack_stage_params(tuple(
        {k: jnp.asarray(v) for k, v in p.items()} for p in per_stage))
    jcfg = JP.PipelineConfig(n_stages=3, n_microbatches=6)
    g_ref = jax.grad(lambda sp: (JP.merge_microbatches(JP.pipeline_forward(
        _ref_stage_fn, sp, JP.split_microbatches(jnp.asarray(x), 6), jcfg))
        ** 2).sum())(jstacked)
    for k, g in stacked.items():
        seq = torch.stack([p[k].grad for p in per])
        np.testing.assert_allclose(g.grad.numpy(), seq.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(g_ref[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("S,M", [(4, 12), (4, 8), (1, 5), (3, 3)])
def test_pipeline_stats_are_the_references(S, M):
    got = pipeline_stats(PipelineConfig(n_stages=S, n_microbatches=M))
    assert got == JP.pipeline_stats(JP.PipelineConfig(n_stages=S,
                                                      n_microbatches=M))
    assert got["ticks"] == M + S - 1
    assert got["bubble_fraction"] == pytest.approx((S - 1) / (M + S - 1))


def test_microbatch_shapes_and_refusals():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    got = split_microbatches(torch.from_numpy(x), 3)
    assert np.array_equal(got.numpy(),
                          np.asarray(JP.split_microbatches(jnp.asarray(x), 3)))
    assert torch.equal(merge_microbatches(got), torch.from_numpy(x))
    with pytest.raises(ValueError):
        split_microbatches(torch.from_numpy(x), 4)
    with pytest.raises(ValueError):
        pipeline_forward(_stage_fn, {}, got,
                         PipelineConfig(n_stages=2, n_microbatches=2))


def test_transformer_stages_match_the_references_pipeline():
    """granite-3-2b's smoke config at 4 layers, float32: the embeddings of
    4 microbatches through 2 stages of 2 layer groups each
    (``transformer.apply_block_full``, the forward's own layer), against
    the reference's pipeline over its ``_apply_block_full`` on the same
    weights, and against the stages applied one after another."""
    cj = jsmoke("granite-3-2b").replace(n_layers=4, dtype="float32")
    ct = tsmoke("granite-3-2b").replace(n_layers=4, dtype="float32")
    pj = ref_init_params(japi.param_specs(cj), jax.random.key(0))
    pt = params_from_reference(jax.tree_util.tree_map(np.asarray, pj))
    n_stages, M, mb, S = 2, 4, 1, 12
    per = cj.n_groups // n_stages
    kinds = ct.layer_kinds()
    toks = np.random.default_rng(5).integers(
        0, cj.vocab_size, (M * mb, S)).astype(np.int64)
    x = pt["embed"][torch.from_numpy(toks)]
    pos_t = torch.arange(S).expand(mb, S)

    def stage(sp, h):
        for gp in TT.unbind(sp, per):
            for i, kind in enumerate(kinds):
                h = TT.apply_block_full(ct, kind, gp[f"l{i}"], None, h,
                                        pos_t)[0]
        return h

    split = lambda t: {k: split(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.reshape((n_stages, per) + t.shape[1:])
    stacked = split(pt["groups"])
    cfg = PipelineConfig(n_stages=n_stages, n_microbatches=M)
    mbs = split_microbatches(x, M)
    got = pipeline_forward(stage, stacked, mbs, cfg)
    stages = TT.unbind(stacked, n_stages)
    for m in range(M):
        h = mbs[m]
        for sp in stages:
            h = stage(sp, h)
        assert torch.equal(got[m], h), m

    pos_j = jnp.broadcast_to(jnp.arange(S), (mb, S))

    def ref_stage(sp, h):
        def body(h, gp):
            for i, kind in enumerate(kinds):
                h = JT._apply_block_full(cj, kind, gp[f"l{i}"], None, h,
                                         pos_j, attn_impl="pallas",
                                         ssd_impl="auto",
                                         want_cache=False)[0]
            return h, None
        return lax.scan(body, h, sp)[0]

    jstacked = jax.tree_util.tree_map(
        lambda t: t.reshape((n_stages, per) + t.shape[1:]), pj["groups"])
    want = JP.pipeline_forward(
        ref_stage, jstacked, jnp.asarray(mbs.numpy()),
        JP.PipelineConfig(n_stages=n_stages, n_microbatches=M))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
