"""The port's training loss and its gradients against
``jax.value_and_grad`` of the reference's ``train.step.loss_fn`` on the
CPU, with the reference's weights carried across
(``params_from_reference``), on the smoke configs of granite-3-2b (dense
GQA), gemma3-27b (local windows), qwen2-moe-a2.7b (MoE with its aux loss),
mamba2-780m (the SSD scan) and zamba2-7b (the SSD scan and the shared
attention), in float32 and bfloat16 activations.
The reference runs its Pallas kernels in interpret mode
(``attn_impl="pallas"``, ``ssd_impl="pallas"``): its flash backward is
the jnp ``_bwd_vjp``, its SSD backward a vjp through the plain scan.  The
port runs its plain versions (a CPU tensor; ``ref.ssd_bwd`` for the SSD
backward) through the same autograd ``Function``s that launch the
kernels on the card, and remat (on in every smoke config) through
``torch.utils.checkpoint``.

Tolerances, with their measured values (gradients relative to each
leaf's largest magnitude):
  * float32: loss 1e-5 absolute (measured 9.5e-7), gradients 2e-5
    (measured 2.3e-6).
  * bfloat16: loss 5e-3 (measured 1.2e-3, gemma3), gradients 0.06
    (measured 0.034, mamba2's dt_bias): XLA rounds to bfloat16 at other
    places than torch (its einsums return bf16, its jnp flash backward
    rounds each block's partial products), and the differences grow over
    the layers.
  * bfloat16 MoE: the smoke router is untrained, so its gates are near
    uniform and most tokens route at a near tie (gaps of 3.5e-5), where
    either package's rounding may pick the other expert: a direct
    comparison measured 0.33 on the experts' ``wi_e``.  So each leaf is
    held to the float32 gradients instead: the port's bfloat16 error
    against them must stay within twice the reference's own (measured:
    up to 1.10 times it, on layer 0's ``wk``; both packages' errors are
    bfloat16 noise of the same size).
  * bfloat16 zamba2-7b (two Mamba2 blocks and the shared attention):
    each package's own bfloat16 gradients lie up to 0.12 (the reference's,
    layer 1's ``wC``) from the float32 ones, so the 0.06 of a direct
    comparison cannot hold (measured 0.087, layer 1's ``conv_B``).  It is
    held to the float32 gradients as the MoE is (measured: up to 1.74
    times the reference's own error).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import api as japi
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.core.interop import params_from_reference
from repro_torch.distributed.sharding import init_params
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api as tapi
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ARCHS = ["granite-3-2b", "gemma3-27b", "qwen2-moe-a2.7b", "mamba2-780m",
         "zamba2-7b"]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 0.06}
# bfloat16 gradients held to the float32 ones, against the reference's own
# error (see above)
TO_FLOAT32 = ("qwen2-moe-a2.7b", "zamba2-7b")
B, S = 2, 32                    # S: a multiple of the smoke SSD chunk
_CACHE = {}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), (tree.float().numpy()
                                 if isinstance(tree, torch.Tensor)
                                 else np.asarray(tree, np.float32))


def _both(arch, dtype):
    """(reference (loss, aux, grads), port (loss, aux, grads)), cached."""
    if (arch, dtype) in _CACHE:
        return _CACHE[arch, dtype]
    cj = jreg.get_smoke_config(arch).replace(dtype=dtype)
    ct = treg.get_smoke_config(arch).replace(dtype=dtype)
    assert ct.remat
    pj = ref_init_params(japi.param_specs(cj), jax.random.key(0))
    pt = params_from_reference(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.default_rng(1).integers(
        1, cj.vocab_size, (B, S + 1)).astype(np.int32)
    toks[0, 5] = 0                                  # a document boundary
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1                             # masked positions
    bj = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    bt = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(labels)}
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jstep.loss_fn(cj, p, bj, attn_impl="pallas",
                                ssd_impl="pallas"), has_aux=True)(pj)
    (lt, mt), gt = tstep.value_and_grad(ct, pt, bt)
    _CACHE[arch, dtype] = ((float(lj), float(mj["aux_loss"]), dict(_flat(gj))),
                           (float(lt), float(mt["aux_loss"]), dict(_flat(gt))))
    return _CACHE[arch, dtype]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_leaf_match_jax(arch, dtype):
    (lj, aj, gj), (lt, at, gt) = _both(arch, dtype)
    assert np.isfinite(lt) and abs(lt - lj) <= LOSS_TOL[dtype]
    assert abs(at - aj) <= 1e-3 * max(1.0, abs(aj))
    assert (aj > 0) == (arch == "qwen2-moe-a2.7b")
    assert gj.keys() == gt.keys()
    to_float32 = dtype == "bfloat16" and arch in TO_FLOAT32
    if to_float32:
        truth = _both(arch, "float32")[0][2]
    for path, w in gj.items():
        g = gt[path]
        assert g.shape == w.shape and np.isfinite(g).all(), path
        if to_float32:
            ref_err = np.abs(w - truth[path]).max()
            assert np.abs(g - truth[path]).max() <= 2 * ref_err, path
        else:
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(g - w).max() <= GRAD_TOL[dtype] * scale, path


def test_remat_changes_no_gradient_bit():
    cfg = treg.get_smoke_config("gemma3-27b").replace(dtype="float32")
    params = init_params(tapi.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 25)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in (True, False):
        (loss, _), grads = tstep.value_and_grad(cfg.replace(remat=remat),
                                                params, batch)
        out[remat] = (float(loss), dict(_flat(grads)))
    assert out[True][0] == out[False][0]
    for path, g in out[True][1].items():
        assert np.array_equal(g, out[False][1][path]), path


def test_remat_recomputes_each_group_forward_once():
    """Under remat the backward replays each group's forward: the flash
    forward runs twice per attention layer (on the CPU its plain version,
    counted here at the ``FlashAttention`` forward)."""
    cfg = treg.get_smoke_config("granite-3-2b").replace(dtype="float32")
    params = init_params(tapi.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = []
    forward = fa_ops.FlashAttention.forward

    def spy(ctx, *args):
        calls.append(1)
        return forward(ctx, *args)
    fa_ops.FlashAttention.forward = staticmethod(spy)
    try:
        for remat in (False, True):
            calls.clear()
            tstep.value_and_grad(cfg.replace(remat=remat), params, batch)
            assert len(calls) == cfg.n_layers * (2 if remat else 1)
    finally:
        fa_ops.FlashAttention.forward = staticmethod(forward)


def test_cross_entropy_matches_the_reference_with_padded_vocab():
    g = np.random.default_rng(5)
    V, Vp = 50, 64
    logits = g.standard_normal((2, 7, Vp)).astype(np.float32) * 3
    logits[..., V:] = -1e9
    labels = g.integers(0, V, (2, 7)).astype(np.int32)
    labels[0, :2] = -1
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                          (jnp.bfloat16, torch.bfloat16, 1e-3)):
        want = jstep.cross_entropy(jnp.asarray(logits).astype(jdt),
                                   jnp.asarray(labels))
        got = tstep.cross_entropy(torch.from_numpy(logits).to(tdt),
                                  torch.from_numpy(labels))
        assert abs(float(got) - float(want)) <= tol
