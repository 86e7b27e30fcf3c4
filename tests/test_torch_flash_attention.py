"""The port's flash attention on the CPU (its plain version, which a CPU
tensor takes) against the reference: the Pallas kernel in interpret mode
on the reference's own cases, ``attention_exact`` at ragged sequence
lengths the Pallas kernel cannot take, and the wrapper's input checks.
Inputs are made with numpy from a seed and handed to both."""
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


def test_wrapper_rejects_other_devices_and_negative_windows():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        fa_ops.flash_attention(q, q, q)
    z = _t((1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        fa_ops.flash_attention(z, z, z, window=-1)
