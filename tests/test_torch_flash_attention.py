"""The port's flash attention on the CPU (its plain version, which a CPU
tensor takes) against the reference: the Pallas kernel in interpret mode
on the reference's own cases, ``attention_exact`` at ragged sequence
lengths the Pallas kernel cannot take, the arithmetic of the card's
bfloat16 kernel (emulated here) against both, and the wrapper's input
checks.  Inputs are made with numpy from a seed and handed to both."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import FA_CASES

from repro.kernels.flash_attention import kernel as fa_kernel
from repro.models.layers import attention_exact as ref_attention_exact
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models.layers import attention_exact

# the reference's tolerances (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, B, S, H, KV, Dh, dtype):
    g = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [g.standard_normal((B, S, n, Dh)).astype(np.float32)
            for n in (H, KV, KV)]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(case, dtype):
    B, S, H, KV, Dh, causal, window, blk = case
    (qj, kj, vj), (qt, kt, vt) = _qkv(S + H + Dh, B, S, H, KV, Dh, dtype)
    want = fa_kernel.flash_attention_fwd(
        qj, kj, vj, causal=causal, window=window, block_q=blk, block_k=blk,
        interpret=True)
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert fa_ops.flash_attention.launches == before   # no kernel on a CPU
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(want, got, TOL[dtype])


# ragged S (not a multiple of any block), GQA, causal/window/non-causal
RAGGED = [(2, 77, 8, 2, 64, True, 0), (1, 100, 4, 4, 80, True, 24),
          (2, 33, 6, 3, 16, False, 0), (1, 129, 4, 1, 32, False, 40)]


@pytest.mark.parametrize("case", RAGGED)
def test_plain_matches_exact_attention_at_ragged_lengths(case):
    B, S, H, KV, Dh, causal, window = case
    (qj, kj, vj), (qt, kt, vt) = _qkv(S, B, S, H, KV, Dh, "float32")
    want = ref_attention_exact(qj, kj, vj, causal=causal, window=window)
    _close(want, fa_ops.flash_attention(qt, kt, vt, causal=causal,
                                        window=window), TOL["float32"])
    _close(want, attention_exact(qt, kt, vt, causal=causal, window=window),
           TOL["float32"])


def _wgmma_arithmetic(q, k, v, *, causal, window, block_k=None):
    """What the card's bfloat16 kernel computes, in plain torch: f32
    logits of the bf16 inputs in log2 units (times log2(e)/sqrt(Dh)), an
    online softmax over tiles of ``block_k`` keys (the kernel's: 128 up
    to Dh 64, else 64) with the finite NEG_INF and exp2, p rounded to
    bf16 as the A operand of P.V (f32 accumulation), l summed from the
    unrounded p, out = acc / max(l, 1e-37) in bf16.  Visiting every tile
    from key 0 matches the kernel, which skips tiles outside its rows'
    band: a tile all masked for a row before its live keys is wiped by
    corr = 0, one after them adds p = 0."""
    B, S, H, Dh = q.shape
    block_k = block_k or (128 if Dh <= 64 else 64)
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)                               # B,H,S,Dh
    kf, vf = (x.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for x in (k, v))
    band = fa_ref.band_mask(S, causal, window)
    m = torch.full((B, H, S), fa_ref.NEG_INF)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, Dh))
    for k0 in range(0, S, block_k):
        ks = slice(k0, k0 + block_k)
        s = (qf @ kf[:, :, ks].transpose(-1, -2)) * (math.log2(math.e)
                                                     / math.sqrt(Dh))
        s = s.masked_fill(~band[:, ks], fa_ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.bfloat16().float() @ vf[:, :, ks]
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("case", FA_CASES)
def test_wgmma_rounding_within_tolerance_of_pallas_kernel(case):
    """The bf16 kernel rounds P to bf16 where the reference keeps it in
    f32 (relative error 2^-9 on weights that sum to one): its arithmetic
    stays within the reference's bf16 tolerance of the Pallas kernel."""
    B, S, H, KV, Dh, causal, window, blk = case
    (qj, kj, vj), (qt, kt, vt) = _qkv(S + H + Dh, B, S, H, KV, Dh,
                                      "bfloat16")
    want = fa_kernel.flash_attention_fwd(
        qj, kj, vj, causal=causal, window=window, block_q=blk, block_k=blk,
        interpret=True)
    got = _wgmma_arithmetic(qt, kt, vt, causal=causal, window=window)
    _close(want, got, TOL["bfloat16"])


@pytest.mark.parametrize("case", RAGGED)
def test_wgmma_rounding_within_tolerance_at_ragged_lengths(case):
    """The same at ragged S, GQA and windows, against the reference's
    exact attention on the same bf16 inputs, with 128- and 64-key
    tiles."""
    B, S, H, KV, Dh, causal, window = case
    (qj, kj, vj), (qt, kt, vt) = _qkv(S, B, S, H, KV, Dh, "bfloat16")
    want = ref_attention_exact(qj, kj, vj, causal=causal, window=window)
    for block_k in (128, 64):
        _close(want, _wgmma_arithmetic(qt, kt, vt, causal=causal,
                                       window=window, block_k=block_k),
               TOL["bfloat16"])


def test_masked_rows_never_see_masked_keys():
    """A key outside the band gets exactly zero weight: changing it leaves
    the output unchanged."""
    _, (q, k, v) = _qkv(5, 1, 40, 2, 2, 16, "float32")
    out = fa_ref.flash_attention(q, k, v, causal=True, window=8)
    v2 = v.clone()
    v2[:, 30:] = 1e6                      # only rows >= 30 may see these
    out2 = fa_ref.flash_attention(q, k, v2, causal=True, window=8)
    assert torch.equal(out[:, :30], out2[:, :30])
    assert torch.isfinite(out).all()


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,match", [
    ((_t((1, 8, 4, 12)), _t((1, 8, 2, 12)), _t((1, 8, 2, 12))), "head dim"),
    ((_t((1, 8, 2, 264)), _t((1, 8, 2, 264)), _t((1, 8, 2, 264))),
     "head dim"),
    ((_t((1, 8, 6, 16)), _t((1, 8, 4, 16)), _t((1, 8, 4, 16))), "kv heads"),
    ((_t((1, 8, 4, 16)), _t((1, 9, 2, 16)), _t((1, 9, 2, 16))),
     "do not match"),
    ((_t((1, 8, 4, 16), torch.float16),) * 3, "float32 or bfloat16"),
    ((_t((1, 8, 4, 16)), _t((1, 8, 2, 16), torch.bfloat16),
      _t((1, 8, 2, 16))), "one device and dtype"),
    ((_t((8, 4, 16)),) * 3, "B,S,H,Dh"),
    ((_t((1, 4, 8, 16)).transpose(1, 3),) * 3, "contiguous"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        fa_ops.flash_attention(*args)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tma_check_rejects_a_misaligned_base():
    q = _bf16(8 * 2 * 64 + 8)[1:1 + 8 * 2 * 64].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa_ops._check_tma(q)


def test_tma_check_rejects_strides_off_16_bytes():
    q = _bf16((1, 8, 2, 68))[..., :64]        # heads 136 bytes apart
    with pytest.raises(ValueError, match="multiples of 16"):
        fa_ops._check_tma(q)
    fa_ops._check_tma(_bf16((1, 8, 2, 72))[..., :64])     # 144 bytes


def test_tma_strides_ignore_dims_of_size_one():
    """A dim of size 1 gets its contiguous stride, whatever torch reports:
    it never multiplies a nonzero index."""
    x = torch.as_strided(_bf16(64), (1, 1, 1, 64), (3, 5, 7, 1))
    assert fa_ops._strides(x) == [64, 64, 64]
    fa_ops._check_tma(x)
    assert fa_ops._strides(_bf16((2, 9, 3, 16))) == [9 * 3 * 16, 48, 16]


def test_wrapper_rejects_other_devices_and_negative_windows():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        fa_ops.flash_attention(q, q, q)
    z = _t((1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        fa_ops.flash_attention(z, z, z, window=-1)
