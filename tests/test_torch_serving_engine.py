"""The port's sampling and batching engine against the JAX reference on
the CPU: greedy ties, categorical draws, and the engine on every decoder
config of ``tests/test_torch_serving.py`` and on whisper-tiny
(encoder-decoder) with its frame stub.  These tests were moved here from
``tests/test_torch_serving.py`` unchanged, so that the two files take
about equal time; the tolerances and their reasons are that file's
docstring's, and its helpers are shared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import (BF16, ENGINE_ARCHS, F32, PROMPTS, _close,
                                _port_engine, _ref_engine_loop, _setup)

from repro.serve import engine as jengine
from repro.serve import step as jstep
from repro_torch import rng
from repro_torch.serve import engine as tengine
from repro_torch.serve import step as tstep

torch.set_num_threads(1)


def test_greedy_ties_go_to_the_first_index():
    logits = torch.tensor([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]],
                          dtype=torch.bfloat16)
    got = tstep.greedy_sample(logits)
    want = jstep.greedy_sample(jnp.asarray(logits.float().numpy(),
                                           jnp.bfloat16))
    assert got.tolist() == [1, 0] == np.asarray(want).tolist()
    assert got.dtype == torch.int32


def test_categorical_equals_jax_on_separated_logits():
    g = np.random.default_rng(9)
    logits = (g.standard_normal((8, 64)) * 3).astype(np.float32)
    for seed in (0, 1, 12345):
        kj, kt = jax.random.key(seed), rng.key(seed)
        for _ in range(3):
            kj, sj = jax.random.split(kj)
            kt, st = rng.split(kt)
            for temp in (1.0, 0.7):
                want = jstep.sample_token(jnp.asarray(logits), sj, temp)
                got = tstep.sample_token(torch.from_numpy(logits), st, temp)
                assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_matches_reference_loop_on_pallas_in_float32(arch):
    cj, ct, pj, pt = _setup(arch, "float32")
    want, ref_logits = _ref_engine_loop(cj, pj, PROMPTS, 3, attn_impl="pallas")
    got, done = _port_engine(ct, pt, PROMPTS, 3)
    assert got == want
    assert all(len(r.output) == g for r, (_, g) in zip(done, PROMPTS))
    summ = tengine.BatchingEngine.summarize(done)
    assert summ["n"] == len(PROMPTS) and summ["tokens_per_s"] > 0
    # the first-step logits of the left-padded first round
    batch = PROMPTS[:3]
    S = max(len(p) for p, _ in batch)
    toks = np.zeros((3, S), np.int64)
    for i, (p, _) in enumerate(batch):
        toks[i, S - len(p):] = p
    inputs = tstep.model_inputs(ct, torch.from_numpy(toks))
    prefill = tstep.make_prefill_step(ct, cache_len=S + 4)
    logits, _ = prefill(tstep.working_params(ct, pt), inputs)
    _close(np.stack([lg[0] for lg in ref_logits[:3]])[:, None], logits, F32)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_matches_reference_engine_in_bfloat16(arch):
    cj, ct, pj, pt = _setup(arch, "bfloat16")
    eng = jengine.BatchingEngine(cj, pj, max_batch=3, temperature=0.0)
    for p, g in PROMPTS:
        eng.submit(p, gen_len=g)
    want = [r.output for r in eng.run()]
    loop, ref_logits = _ref_engine_loop(cj, pj, PROMPTS, 3, attn_impl="auto")
    assert loop == want                 # the loop is the reference engine's
    got, _ = _port_engine(ct, pt, PROMPTS, 3)
    assert [len(g) for g in got] == [len(w) for w in want]
    for w, g, lgs in zip(want, got, ref_logits):
        at = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if at is not None:              # only at a near tie of the reference
            assert lgs[at][w[at]] - lgs[at][g[at]] <= BF16, (w, g, at)


def test_engine_samples_as_the_reference_at_temperature():
    cj, ct, pj, pt = _setup("granite-3-2b", "float32")
    eng = jengine.BatchingEngine(cj, pj, max_batch=2, temperature=0.8,
                                 seed=5)
    for p, g in PROMPTS[:4]:
        eng.submit(p, gen_len=g)
    want = [r.output for r in eng.run()]
    port = tengine.BatchingEngine(ct, pt, max_batch=2, temperature=0.8,
                                  seed=5)
    for p, g in PROMPTS[:4]:
        port.submit(p, gen_len=g)
    assert [r.output for r in port.run()] == want


def test_working_params_round_once_and_keep_norms():
    cj, ct, pj, pt = _setup("granite-3-2b", "bfloat16")
    w = tstep.working_params(ct, pt)
    assert w["embed"].dtype == torch.bfloat16
    assert w["final_ln"].dtype == torch.float32
    assert w["groups"]["l0"]["attn"]["ln"].dtype == torch.float32
    assert torch.equal(w["groups"]["l0"]["mlp"]["wi"],
                       pt["groups"]["l0"]["mlp"]["wi"].to(torch.bfloat16))
