"""The port's DiLoCo cross-pod training (``distributed/diloco.py``) against
the JAX reference on the CPU: ``outer_update`` on the same arrays, a
2-pod, 3-step, 3-round run on granite-3-2b's smoke config mirroring
tests/test_compression_diloco.py::test_diloco_round_and_resync, the same
run in float32 against the reference's, and the aliasing the port's
in-place train step forbids.  Weights are the reference's ``init_params``
draws carried across with ``params_from_reference``; the pods' batches are
the synthetic Zipf stream (the port's bit-identical to the reference's),
other inputs numpy draws from a seed.

Tolerances, with their reasons:
  * ``outer_update``: bit-identical to the reference's at 2 and 3 pods
    (the same float32 operations in the same order: XLA computes
    ``jnp.mean`` as the sum times 1/n, and so does the port).
  * The float32 run (2 rounds): each round's loss within 1e-5 relative of
    the reference's, the final anchor within 1e-5 absolute (weights
    ~0.02, AdamW steps of ~1e-3; measured: losses 7.7e-8 relative, anchor
    3.8e-6, where a gradient near zero turns AdamW's m / sqrt(v) on a
    float32 rounding).
  * Re-sync: every pod's parameters bit-identical to the anchor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.data.pipeline import pipeline_for_model as ref_pipeline
from repro.distributed import diloco as JD
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import api as japi
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core.interop import params_from_reference
from repro_torch.data.pipeline import pipeline_for_model
from repro_torch.distributed.diloco import (DiLoCoConfig, init_outer_state,
                                            make_diloco_round, outer_update,
                                            pod_slice, replicate_for_pods)
from repro_torch.distributed.sharding import map_tree
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(1)

SEEDS = (10, 11)                # the pods' streams, the reference test's
N_PODS, K, ROUNDS = 2, 3, 3


def _tree(g, shapes, dtype=np.float32, scale=1.0):
    return {k: (g.standard_normal(s) * scale).astype(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("n_pods", [2, 3])
def test_outer_update_matches_the_reference(n_pods):
    g = np.random.default_rng(n_pods)
    shapes = {"w": (5, 7), "stack": (3, 4, 6), "b": (9,)}
    anchor = _tree(g, shapes, scale=0.02)
    momentum = _tree(g, shapes, scale=1e-3)
    pods = {k: (anchor[k] + g.standard_normal((n_pods,) + a.shape)
                * 1e-3).astype(np.float32) for k, a in anchor.items()}
    cfg = DiLoCoConfig(n_pods=n_pods)
    j_outer, j_pods = JD.outer_update(
        JD.DiLoCoConfig(n_pods=n_pods),
        {"anchor": {k: jnp.asarray(v) for k, v in anchor.items()},
         "momentum": {k: jnp.asarray(v) for k, v in momentum.items()}},
        {k: jnp.asarray(v) for k, v in pods.items()})
    t = lambda tree: {k: torch.tensor(v) for k, v in tree.items()}
    outer = {"anchor": t(anchor), "momentum": t(momentum)}
    pod_params = t(pods)
    got_outer, got_pods = outer_update(cfg, outer, pod_params)
    assert got_outer is outer and got_pods is pod_params     # in place
    for part in ("anchor", "momentum"):
        for k, w in j_outer[part].items():
            assert np.array_equal(outer[part][k].numpy(), np.asarray(w)), k
    for k, w in j_pods.items():
        assert np.array_equal(pod_params[k].numpy(), np.asarray(w)), k
        for p in range(n_pods):
            assert torch.equal(pod_params[k][p], outer["anchor"][k])


def test_outer_update_keeps_a_bfloat16_anchor_bfloat16():
    """The arithmetic runs in float32 and the new anchor is cast to the
    anchor's dtype, as the reference's: bit-identical on bfloat16 leaves."""
    g = np.random.default_rng(7)
    a = (g.standard_normal((4, 8)) * 0.02).astype(np.float32)
    pods = (a + g.standard_normal((2, 4, 8)) * 1e-3).astype(np.float32)
    ja, jp = jnp.asarray(a, jnp.bfloat16), jnp.asarray(pods, jnp.bfloat16)
    j_outer, j_pods = JD.outer_update(
        JD.DiLoCoConfig(), {"anchor": {"w": ja},
                            "momentum": {"w": jnp.zeros((4, 8))}},
        {"w": jp})
    outer = {"anchor": {"w": torch.tensor(a).to(torch.bfloat16)},
             "momentum": {"w": torch.zeros(4, 8)}}
    pp = {"w": torch.tensor(pods).to(torch.bfloat16)}
    outer_update(DiLoCoConfig(), outer, pp)
    assert outer["anchor"]["w"].dtype == torch.bfloat16
    assert outer["momentum"]["w"].dtype == torch.float32
    for got, want in ((outer["anchor"]["w"], j_outer["anchor"]["w"]),
                      (outer["momentum"]["w"], j_outer["momentum"]["w"]),
                      (pp["w"], j_pods["w"])):
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}


def _port_run(dtype, rounds=ROUNDS):
    """The reference test's run on the port: (round losses, pod states,
    outer state, the initial params)."""
    cfg = tsmoke("granite-3-2b").replace(dtype=dtype)
    pj = ref_init_params(japi.param_specs(jsmoke("granite-3-2b")),
                         jax.random.key(0))
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, pj))
    opt = AdamWConfig(lr=1e-3, total_steps=50, warmup=2)
    pod_states = replicate_for_pods(init_train_state(cfg, opt, params),
                                    N_PODS)
    outer = init_outer_state(params)
    pipes = [pipeline_for_model(cfg, global_batch=4, seq_len=32, seed=s,
                                device="cpu") for s in SEEDS]

    def batch_fn(r):
        return {name: torch.stack([torch.stack(
            [pipes[p].batch_at(r * K + i)[name] for i in range(K)])
            for p in range(N_PODS)]) for name in ("tokens", "labels")}

    round_fn = make_diloco_round(DiLoCoConfig(n_pods=N_PODS, inner_steps=K,
                                              outer_lr=0.7),
                                 make_train_step(cfg, opt), batch_fn)
    losses = []
    for r in range(rounds):
        pod_states, outer, m = round_fn(pod_states, outer, r)
        losses.append(float(m["loss"]))
        for leaf, anchor in zip(tree_leaves(pod_states["params"]),
                                tree_leaves(outer["anchor"])):
            for p in range(N_PODS):
                assert torch.equal(leaf[p], anchor)
    return losses, pod_states, outer, params


def test_diloco_round_and_resync():
    """tests/test_compression_diloco.py's run (bfloat16 compute): the pods
    re-synced bit for bit after every outer update, the loss falling, and
    each pod's optimizer state its own (the step count K a round)."""
    losses, pod_states, _, _ = _port_run("bfloat16")
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert pod_states["opt"]["step"].tolist() == [K * ROUNDS] * N_PODS
    m0, m1 = (pod_slice(pod_states["opt"]["mv"], p) for p in range(2))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(m0),
                                                     tree_leaves(m1)))


def test_float32_rounds_match_the_references():
    losses, _, outer, _ = _port_run("float32", rounds=2)
    cj = jsmoke("granite-3-2b").replace(dtype="float32")
    opt = JAdamWConfig(lr=1e-3, total_steps=50, warmup=2)
    params = ref_init_params(japi.param_specs(cj), jax.random.key(0))
    pod_states = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (N_PODS,) + x.shape).copy(),
        ref_init_train_state(cj, opt, params))
    j_outer = JD.init_outer_state(params)
    pipes = [ref_pipeline(cj, global_batch=4, seq_len=32, seed=s)
             for s in SEEDS]

    def batch_fn(r):
        per_pod = [jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs),
            *[pipes[p].batch_at(r * K + i) for i in range(K)])
            for p in range(N_PODS)]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_pod)

    round_fn = JD.make_diloco_round(
        JD.DiLoCoConfig(n_pods=N_PODS, inner_steps=K, outer_lr=0.7),
        jax.jit(ref_make_train_step(cj, opt)), batch_fn)
    want = []
    for r in range(2):
        pod_states, j_outer, m = round_fn(pod_states, j_outer, r)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=0)
    flat = jax.tree_util.tree_flatten_with_path(j_outer["anchor"])[0]
    got = dict(_leaves(outer["anchor"]))
    for path, w in flat:
        key = tuple(p.key for p in path)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_nothing_a_step_writes_aliases_the_anchor():
    """The train step writes parameters and moments in place: the anchor
    shares no storage with the parameters it was made from or with any
    pod, the pods share none with each other or with the state they were
    replicated from, and the anchor is unchanged by the inner steps until
    the outer update."""
    cfg = tsmoke("granite-3-2b")
    params = params_from_reference(jax.tree_util.tree_map(
        np.asarray, ref_init_params(japi.param_specs(jsmoke("granite-3-2b")),
                                    jax.random.key(0))))
    opt = AdamWConfig(lr=1e-3, total_steps=50, warmup=2)
    state = init_train_state(cfg, opt, params)
    pods = replicate_for_pods(state, N_PODS)
    outer = init_outer_state(params)
    anchor = _storages(outer["anchor"])
    assert not anchor & _storages(params)
    assert not anchor & _storages(pods)
    assert not _storages(pods) & _storages(state)
    for a, p in zip(tree_leaves(outer["anchor"]), tree_leaves(params)):
        assert torch.equal(a, p)
    before = map_tree(torch.clone, outer["anchor"])
    pipe = pipeline_for_model(cfg, global_batch=4, seq_len=32, seed=10,
                              device="cpu")
    step = make_train_step(cfg, opt)
    mine = pod_slice(pods, 0)
    step(mine, pipe.batch_at(0))
    changed = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(pods["params"]), tree_leaves(before))]
    assert any(changed)                       # pod 0 stepped in place
    for a, b in zip(tree_leaves(outer["anchor"]), tree_leaves(before)):
        assert torch.equal(a, b)
    for leaf, b in zip(tree_leaves(pods["params"]), tree_leaves(before)):
        assert torch.equal(leaf[1], b)        # pod 1 untouched
