"""The port's MoE block against the JAX reference on the CPU: the routing
(``_top_k_dispatch``: experts, capacity slots, dropped tokens, combine
weights and the Switch aux loss, ties going to the first index),
``moe_apply`` in float32 and bfloat16 with top-k 1 (llama4-scout) and 2
(qwen2-moe), a router rigged to overflow one expert, the chunked route
(``_SEQ_CHUNK`` patched small in both packages) and a one-token decode;
then the decoder-only MoE models whole (forward with its caches, decode
steps, the engine) through ``tests/test_torch_serving.py``'s ARCHS.
Weights are the reference's ``init_params`` draws carried across with
``params_from_reference``; other inputs are made with numpy from a seed.

Tolerances, with their reasons:
  * The routing is exact: the same gates give the same experts, slots and
    drops, and combine weights within 1e-7 (float32 division and a sum of
    at most top-k terms, in the reference's order).
  * F32 (1e-5 absolute on block outputs of magnitude ~3; aux 1e-6
    relative): the router logits and the expert products are float32
    GEMMs summed in other orders by XLA and by torch.  Measured: 9.5e-7.
  * BF16 (one bfloat16 ulp at the output's magnitude, 2**-7 relative plus
    2**-6 absolute): the expert products round to bfloat16 in both, from
    float32 sums in other orders.  Measured: 0.031 at |out| ~ 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import _close, _leaves, _pair

from repro.configs import registry as jreg
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import moe as JMOE
from repro_torch.configs import registry as treg
from repro_torch.core.interop import params_from_reference
from repro_torch.distributed.sharding import init_params
from repro_torch.models import api as tapi
from repro_torch.models import moe as TMOE
from repro_torch.serve import step as tstep

torch.set_num_threads(1)

F32, BF16_REL, BF16_ABS = 1e-5, 2.0 ** -7, 2.0 ** -6
ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"]   # top-k 2 and 1
_BLOCKS = {}
# the reference block, compiled once per config and shape (eager JAX
# dispatches each small op on its own); a test that patches _SEQ_CHUNK
# traces its own copy
ref_moe_apply = jax.jit(JMOE.moe_apply, static_argnums=0)
ref_dispatch = jax.jit(JMOE._top_k_dispatch, static_argnums=(1, 2))


def _block(arch, dtype):
    """(reference cfg, port cfg, reference MoE params, port MoE params)."""
    if (arch, dtype) not in _BLOCKS:
        cj = jreg.get_smoke_config(arch).replace(dtype=dtype)
        ct = treg.get_smoke_config(arch).replace(dtype=dtype)
        pj = ref_init_params(JMOE.moe_specs(cj), jax.random.key(3))
        pt = params_from_reference(jax.tree_util.tree_map(np.asarray, pj))
        _BLOCKS[arch, dtype] = (cj, ct, pj, pt)
    return _BLOCKS[arch, dtype]


def _dense(expert, slot, keep, weight, E, C):
    """The port's routing as the reference's (B,S,E,C) dispatch and
    combine tensors."""
    B, S, K = expert.shape
    dispatch = np.zeros((B, S, E, C), bool)
    combine = np.zeros((B, S, E, C), np.float32)
    for b, s, k in np.ndindex(B, S, K):
        if keep[b, s, k]:
            e, c = int(expert[b, s, k]), int(slot[b, s, k])
            dispatch[b, s, e, c] = True
            combine[b, s, e, c] += float(weight[b, s, k])
    return dispatch, combine


def _check_routing(gates, top_k, capacity):
    """Port routing equals the reference's on these gates; returns the
    number of dropped choices."""
    dj, cj, aj = ref_dispatch(jnp.asarray(gates), top_k, capacity)
    expert, slot, keep, weight, aux = TMOE._top_k_dispatch(
        torch.from_numpy(gates), top_k, capacity)
    assert expert.dtype == torch.int64 and keep.dtype == torch.bool
    E = gates.shape[-1]
    dispatch, combine = _dense(expert.numpy(), slot.numpy(), keep.numpy(),
                               weight.numpy(), E, capacity)
    assert np.array_equal(dispatch, np.asarray(dj))
    np.testing.assert_allclose(combine, np.asarray(cj), atol=1e-7, rtol=0)
    np.testing.assert_allclose(float(aux), float(aj), rtol=1e-6)
    assert (weight.numpy()[~keep.numpy()] == 0).all()
    return int((~keep).sum())


def _gates(B, S, E, seed, scale=2.0):
    logits = np.random.default_rng(seed).standard_normal((B, S, E)) * scale
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("top_k,capacity", [(1, 3), (2, 4), (4, 2), (2, 40)])
def test_top_k_dispatch_matches_the_reference(top_k, capacity):
    dropped = _check_routing(_gates(3, 17, 8, top_k + capacity), top_k,
                             capacity)
    # small capacities drop choices, the roomy one none
    assert (dropped == 0) == (capacity == 40)


def test_routing_ties_go_to_the_first_index():
    gates = np.full((2, 6, 4), 0.25, np.float32)
    gates[1, :, 1:3] = [0.375, 0.375]
    gates[1, :, 0] = gates[1, :, 3] = 0.125
    expert, slot, keep, _, _ = TMOE._top_k_dispatch(
        torch.from_numpy(gates), 2, 3)
    assert expert[0].tolist() == [[0, 1]] * 6
    assert expert[1].tolist() == [[1, 2]] * 6
    # first come, first slotted: tokens 3.. overflow both experts
    assert slot[0, :, 0].tolist() == [0, 1, 2, 2, 2, 2]
    assert keep[0, :, 0].tolist() == [True] * 3 + [False] * 3
    _check_routing(gates, 2, 3)
    _check_routing(gates, 3, 5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [11, 1])              # a prefill, a decode
def test_moe_apply_matches_the_reference(arch, dtype, S):
    cj, ct, pj, pt = _block(arch, dtype)
    xj, xt = _pair((3, S, cj.d_model), S + 7)
    xj, xt = xj.astype(getattr(jnp, dtype)), xt.to(getattr(torch, dtype))
    want, aux_j = ref_moe_apply(cj, pj, xj)
    got, aux_t = TMOE.moe_apply(ct, pt, xt)
    assert got.dtype == xt.dtype and aux_t.dtype == torch.float32
    if dtype == "float32":
        _close(want, got, F32)
    else:
        _close(want, got, BF16_ABS, rtol=BF16_REL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


def _rigged(pj, pt):
    """The router sends every token to expert 0 first: its column is a
    large positive constant and the inputs are positive."""
    pj = dict(pj, router=pj["router"].at[:, 0].set(5.0))
    pt = dict(pt, router=pt["router"].clone())
    pt["router"][:, 0] = 5.0
    return pj, pt


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_overflowing_expert_drops_tokens_as_the_reference(arch, dtype):
    cj, ct, pj, pt = _block(arch, dtype)
    pj, pt = _rigged(pj, pt)
    x = np.abs(np.random.default_rng(5).standard_normal(
        (2, 13, cj.d_model))).astype(np.float32) + 0.5
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    m = ct.moe
    capacity = max(1, int(13 * m.top_k * m.capacity_factor / m.n_experts))
    h = TMOE.rms_norm(xt, pt["ln"], ct.norm_eps)
    gates = torch.softmax(h.float() @ pt["router"], dim=-1)
    assert (gates.argmax(-1) == 0).all()
    # 13 tokens a row into `capacity` slots of expert 0
    assert _check_routing(gates.numpy(), m.top_k, capacity) >= \
        2 * (13 - capacity)
    want, aux_j = ref_moe_apply(cj, pj, xj)
    got, aux_t = TMOE.moe_apply(ct, pt, xt)
    if dtype == "float32":
        _close(want, got, F32)
    else:
        _close(want, got, BF16_ABS, rtol=BF16_REL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_chunked_route_matches_the_reference(arch, monkeypatch):
    """S = 16 in chunks of 4 (S >= 4 chunks and a multiple): per-chunk
    capacity, in both packages."""
    monkeypatch.setattr(JMOE, "_SEQ_CHUNK", 4)
    monkeypatch.setattr(TMOE, "_SEQ_CHUNK", 4)
    ref = jax.jit(lambda p, x: JMOE.moe_apply(cj, p, x))
    cj, ct, pj, pt = _block(arch, "float32")
    xj, xt = _pair((2, 16, cj.d_model), 9)
    want, aux_j = ref(pj, xj)
    got, aux_t = TMOE.moe_apply(ct, pt, xt)
    _close(want, got, F32)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    # not chunked at 12 (not 4 chunks) and at 18 (not a multiple)
    for S in (12, 18):
        xj, xt = _pair((2, S, cj.d_model), S)
        _close(ref(pj, xj)[0], TMOE.moe_apply(ct, pt, xt)[0], F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_specs_are_the_references(arch):
    cj = jreg.get_smoke_config(arch)
    want = jax.tree_util.tree_map(
        lambda s: (s.shape, s.dtype, s.axes, s.init, s.scale),
        JMOE.moe_specs(cj, (3,)), is_leaf=lambda x: hasattr(x, "init"))
    got = {k: (s.shape, s.dtype, s.axes, s.init, s.scale)
           for k, s in TMOE.moe_specs(treg.get_smoke_config(arch),
                                      (3,)).items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS + ["whisper-tiny"])
def test_working_init_equals_working_params_of_init_params(arch):
    """init_working_params builds working_params(init_params(...)) bit for
    bit, a layer at a time, with the router and the norms in float32."""
    for dtype in ("bfloat16", "float32"):
        cfg = treg.get_smoke_config(arch).replace(dtype=dtype)
        want = tstep.working_params(cfg, init_params(
            tapi.param_specs(cfg), torch.Generator().manual_seed(4)))
        got = tstep.init_working_params(cfg,
                                        torch.Generator().manual_seed(4))
        flat_w = dict(_leaves(want))
        flat_g = dict(_leaves(got))
        assert flat_w.keys() == flat_g.keys()
        for path, w in flat_w.items():
            g = flat_g[path]
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert torch.equal(g, w), path
            want_dt = (torch.float32 if path[-1] in tstep.FLOAT32_LEAVES
                       else getattr(torch, dtype))
            assert g.dtype == want_dt, path
    if arch != "whisper-tiny":
        assert flat_g[("groups", "l0", "moe", "router")].dtype == \
            torch.float32


@pytest.mark.parametrize("arch", ARCHS + ["whisper-tiny"])
def test_params_from_reference_carries_the_tree_bit_for_bit(arch):
    from repro.models import api as japi
    cj = jreg.get_smoke_config(arch)
    pj = ref_init_params(japi.param_specs(cj), jax.random.key(2))
    if arch == "llama4-scout-17b-a16e":     # its full config's bf16 leaves
        pj = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), pj)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, pj)))
    got = dict(_leaves(params_from_reference(
        jax.tree_util.tree_map(np.asarray, pj))))
    assert want.keys() == got.keys()
    specs = dict(_leaves(tapi.param_specs(treg.get_smoke_config(arch))))
    assert specs.keys() == got.keys()
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape == specs[path].shape, path
        bits = (g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
                else g.numpy())
        assert np.array_equal(bits, w.view(np.int16)
                              if w.dtype.name == "bfloat16" else w), path
