"""The port's two-buffer decode cache against the JAX reference on the CPU
(``tests/test_two_buffer_decode.py`` run on both packages): a read-only
main cache filled by the prefill, a recent ring each decoded token is
written into, and one-token attention as the merge of a partial softmax
over each.  Weights are the reference's ``init_params`` draws carried
across with ``params_from_reference``; tokens, frames and patches are made
with numpy from a seed.

Tolerances, with their reasons:
  * Decode logits within 5e-2 (the reference's own bound for two buffers
    against one ring, its "bf16 noise band"), and the greedy tokens equal,
    both for the port's two buffers against the reference's two buffers
    and against the port's own single ring.  Measured on these smoke
    configs (bfloat16): two buffers against one ring 7.8e-3 to 1.6e-2 in
    either package; the port's two buffers against the reference's up to
    3.9e-2 (zamba2-7b), the bfloat16 noise the serving tests bound by 0.08
    (tests/test_torch_serving.py).
  * The pieces (``_attention_partial``, ``_merge_partials``) in float32
    within 1e-5 of the reference's (both sum the same terms in float32;
    measured ~1e-7), in bfloat16 within one bfloat16 ulp (2**-8) relative
    of the accumulator, whose p.V product rounds p to bfloat16 in both.
  * The main buffers of a two-buffer cache: bitwise unchanged by decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.distributed.sharding import init_params as ref_init_params
from repro.models import api as japi
from repro.models import layers as JL
from repro.serve.step import make_prefill_step as ref_prefill
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core.interop import params_from_reference
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.serve import step as tstep

torch.set_num_threads(1)

ARCHS = ["granite-3-2b", "gemma3-27b", "zamba2-7b", "whisper-tiny",
         "llama4-scout-17b-a16e"]
LOGIT_TOL = 5e-2
S, B, CACHE, RECENT, STEPS = 16, 2, 24, 4, 3


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _ref_copy_into(two_buf, prefill_caches):
    """tests/test_two_buffer_decode.py's ``_copy_into``: each leaf of the
    two-buffer layout that the prefill's caches have at the same path and
    shape takes the prefill's."""
    flat = jax.tree_util.tree_flatten_with_path(prefill_caches)[0]
    cmap = {tuple(str(p) for p in path): leaf for path, leaf in flat}

    def fill(path, leaf):
        src = cmap.get(tuple(str(p) for p in path))
        return src if src is not None and src.shape == leaf.shape else leaf

    return jax.tree_util.tree_map_with_path(fill, two_buf)


def _copy_into(two_buf, prefill_caches):
    """The same on the port's trees: copied into the layout's own tensors
    (the single ring's decode then writes the prefill's in place)."""
    src = dict(_leaves(prefill_caches))
    for path, leaf in _leaves(two_buf):
        s = src.get(path)
        if s is not None and s.shape == leaf.shape:
            leaf.copy_(s)
    return two_buf


def _main_buffers(caches):
    """Clones of the main k/v/pos of every two-buffer cache in a tree."""
    out = {}

    def walk(tree, prefix):
        if "rk" in tree:
            out.update({prefix + (k,): tree[k].clone()
                        for k in ("k", "v", "pos")})
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
    walk(caches, ())
    return out


def _logits(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_two_buffer_matches_reference_and_single_ring(arch):
    cj, ct = jsmoke(arch), tsmoke(arch)
    pj = ref_init_params(japi.param_specs(cj), jax.random.key(1))
    pt = params_from_reference(jax.tree_util.tree_map(np.asarray, pj))
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cj.vocab_size, (B, S)).astype(np.int32)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cj.frontend in ("frames", "patches"):
        f = (rng.standard_normal((B, cj.frontend_len, cj.d_model)) * 0.02
             ).astype(np.float32)
        bj[cj.frontend] = jnp.asarray(f, jnp.bfloat16)
        bt[cj.frontend] = torch.from_numpy(f).to(torch.bfloat16)

    _, one_j = ref_prefill(cj, cache_len=CACHE)(pj, bj)
    two_j = _ref_copy_into(japi.init_caches(cj, B, CACHE, recent_len=RECENT),
                           one_j)
    _, one_t = tstep.make_prefill_step(ct, cache_len=CACHE)(pt, bt)
    two_t = _copy_into(tapi.init_caches(ct, B, CACHE, recent_len=RECENT),
                       one_t)
    main = _main_buffers(two_t)
    assert main, "no cache took the two-buffer layout"

    tok_j, tok_one, tok_two = (toks[:, -1:],) * 3
    for i in range(STEPS):
        cur = S + i
        lj, two_j = japi.decode_step(cj, pj, jnp.asarray(tok_j), two_j,
                                     jnp.array(cur, jnp.int32))
        l_one, one_t = tapi.decode_step(ct, pt, torch.from_numpy(tok_one),
                                        one_t, cur)
        l_two, two_t = tapi.decode_step(ct, pt, torch.from_numpy(tok_two),
                                        two_t, cur)
        want, one, got = _logits(lj), _logits(l_one), _logits(l_two)
        assert np.abs(got - want).max() < LOGIT_TOL, (arch, i)
        assert np.abs(got - one).max() < LOGIT_TOL, (arch, i)
        assert (got.argmax(-1) == want.argmax(-1)).all(), (arch, i)
        assert (got.argmax(-1) == one.argmax(-1)).all(), (arch, i)
        tok_j, tok_one, tok_two = (x.argmax(-1).astype(np.int32)
                                   for x in (want, one, got))
    for path, before in main.items():
        assert torch.equal(dict(_leaves(two_t))[path], before), path
    # every decoded position sits in the recent rings, none in the main
    for path, rpos in _leaves(two_t):
        if path[-1] == "rpos":
            assert sorted(set(rpos.flatten().tolist()) - {-1}) == \
                list(range(S, S + STEPS)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_two_buffer_layout_is_the_references(arch):
    """Keys, shapes, dtypes and values of ``init_caches(recent_len=)``:
    windowed layers keep one ring, Mamba2 caches are unchanged, whisper's
    self ring is stacked with its recent buffers over the layers."""
    cj, ct = jsmoke(arch), tsmoke(arch)
    want = dict(_leaves(japi.init_caches(cj, 3, 13, recent_len=5)))
    got = dict(_leaves(tapi.init_caches(ct, 3, 13, recent_len=5)))
    assert want.keys() == got.keys()
    assert any(p[-1] == "rk" for p in got)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype) == f"torch.{w.dtype}", path
        assert np.array_equal(got[path].float().numpy(),
                              np.asarray(w, np.float32)), path
    assert not any(p[-1] == "rk" for p, _ in _leaves(
        tapi.init_caches(ct, 3, 13)))


def _source(rng, Sk, KV, Dh, valid):
    k = rng.standard_normal((B, Sk, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, Dh)).astype(np.float32)
    return k, v, np.asarray(valid, bool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partials_and_merge_match_the_references(dtype):
    rng = np.random.default_rng(3)
    H, KV, Dh = 8, 2, 16
    q = rng.standard_normal((B, 1, H, Dh)).astype(np.float32)
    sources = [_source(rng, 11, KV, Dh, rng.random(11) < 0.6),
               _source(rng, 4, KV, Dh, [True, False, True, True]),
               _source(rng, 5, KV, Dh, [False] * 5)]       # no valid slot
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    parts_j, parts_t = [], []
    for k, v, valid in sources:
        pj = JL._attention_partial(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                   jnp.asarray(v, jd), jnp.asarray(valid))
        pt = TL._attention_partial(torch.from_numpy(q).to(td),
                                   torch.from_numpy(k).to(td),
                                   torch.from_numpy(v).to(td),
                                   torch.from_numpy(valid))
        for a, b in zip(pj, pt):
            assert b.dtype == torch.float32
            rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=1e-5 * np.abs(np.asarray(a)).max())
        parts_j.append(pj)
        parts_t.append(pt)
    want = np.asarray(JL._merge_partials(parts_j))
    got = TL._merge_partials(parts_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # on the reference's own partials the merge is the same arithmetic
    same = TL._merge_partials([tuple(torch.tensor(np.asarray(x))
                                     for x in p) for p in parts_j]).numpy()
    np.testing.assert_allclose(same, want, rtol=1e-6, atol=1e-7)


def test_a_source_with_no_valid_slot_weighs_nothing():
    """A source whose slots are all masked: finite NEG_INF logits give it
    the weight exp(NEG_INF - m) = 0 beside a valid source, so the merge is
    the valid source's softmax alone; two empty sources give no NaN (the
    1e-37 floor under the sum)."""
    rng = np.random.default_rng(4)
    H, KV, Dh = 4, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, 1, H, Dh)).astype(
        np.float32))
    k, v, _ = (torch.from_numpy(x) for x in _source(rng, 6, KV, Dh, []))
    ek, ev, _ = (torch.from_numpy(x) for x in _source(rng, 3, KV, Dh, []))
    full = torch.ones(6, dtype=torch.bool)
    empty = torch.zeros(3, dtype=torch.bool)
    merged = TL._merge_partials([TL._attention_partial(q, k, v, full),
                                 TL._attention_partial(q, ek, ev, empty)])
    alone = TL.attention_decode(q, k, v, torch.arange(6), 5)[:, 0]
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, alone, rtol=1e-5, atol=1e-6)
    both_empty = TL._merge_partials([
        TL._attention_partial(q, k, v, torch.zeros(6, dtype=torch.bool)),
        TL._attention_partial(q, ek, ev, empty)])
    assert torch.isfinite(both_empty).all()
