"""Plain PyTorch versions of the ``flash_attention`` kernels, forward and
backward.

``flash_attention``: materialized softmax attention in float32 with the
kernel's masks (causal ``kpos <= qpos``, window ``kpos > qpos -
window``), its finite ``NEG_INF`` for masked logits, its GQA mapping (q
head ``h`` reads kv head ``h // (H // KV)``) and its final cast to q's
dtype.  The kernel's online softmax reaches the same values up to float32
rounding.  ``flash_attention_fwd`` also returns each row's log-sum-exp
(B, H, S) in natural-log units, what the reference's ``jnp_impl._fwd``
saves for its backward.  ``split_parts`` is the plain version of the
float32 wgmma route's split pass.

``flash_attention_bwd`` is the counterpart of the reference's
``jnp_impl._bwd_vjp`` (what its ``_block_grads`` computes), materialized:
``p = exp(logits - lse)``, ``ds = p * (dp - delta) * scale`` with
``delta = rowsum(dout * out)``, both zero outside the band; p and ds are
rounded to q's dtype before their products (``p.astype(q.dtype)``), every
sum is float32.  The reference's einsums also round q.k, dout.v and each
block's partial products to q's dtype; this version and the kernels keep
those in float32.  Float64 inputs compute in float64 (the autograd checks).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def band_mask(S: int, causal: bool, window: int,
              device=None) -> torch.Tensor:
    """(S, S) bool: key ``j`` is visible from query ``i``."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _logits(q, k, causal, window):
    """(B,KV,G,S,S) scaled logits, masked to NEG_INF, and the mask."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    acc = _acc(q.dtype)
    qg = q.to(acc).reshape(B, S, KV, H // KV, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(acc))
    logits = logits * (1.0 / math.sqrt(Dh))
    mask = band_mask(S, causal, window, q.device)
    return logits.masked_fill(~mask, NEG_INF), mask


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B,S,H,Dh); k/v: (B,S,KV,Dh) -> (out (B,S,H,Dh) in q's dtype,
    lse (B,H,S) float32)."""
    B, S, H, Dh = q.shape
    logits, _ = _logits(q, k, causal, window)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(probs.dtype))
    lse = torch.logsumexp(logits, dim=-1).reshape(B, H, S)
    return (out.reshape(B, S, H, Dh).to(q.dtype),
            lse.to(_acc(q.dtype)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,Dh); k/v: (B,S,KV,Dh) -> (B,S,H,Dh) in q's dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]


def split_parts(x: torch.Tensor) -> torch.Tensor:
    """The split pass's plain version: float32 ``x`` (B,S,n,Dh) as three
    bfloat16 parts (B,S,n,3 DP), DP = Dh rounded up to 64: hi = x rounded
    to bf16 in columns [0, DP), mid = the rest rounded in [DP, 2 DP), lo =
    what mid leaves in [2 DP, 3 DP), zeros past Dh.  8 + 8 + 8 bits: the
    three parts sum to ``x`` exactly where |x| >= 2^-110 or x = 0 (below,
    mid and lo fall among the subnormals and lose bits)."""
    B, S, n, Dh = x.shape
    DP = -(-Dh // 64) * 64
    out = torch.zeros((B, S, n, 3, DP), dtype=torch.bfloat16,
                      device=x.device)
    rest = x.float()
    for p in range(3):
        out[..., p, :Dh] = rest.to(torch.bfloat16)
        rest = rest - out[..., p, :Dh].float()
    return out.reshape(B, S, n, 3 * DP)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of q, k and v, from the forward's
    ``out`` and ``lse`` (B,H,S) and the output's gradient ``dout``."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    acc = _acc(q.dtype)
    scale = 1.0 / math.sqrt(Dh)
    logits, mask = _logits(q, k, causal, window)
    p = torch.exp(logits - lse.to(acc).reshape(B, KV, G, S)[..., None])
    dog = dout.to(acc).reshape(B, S, KV, G, Dh)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dog,
                         out.to(acc).reshape(B, S, KV, G, Dh))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.to(acc))
    ds = (p * (dp - delta[..., None]) * scale).masked_fill(~mask, 0.0)
    p = p.to(q.dtype).to(acc)
    ds = ds.to(q.dtype).to(acc)
    qg = q.to(acc).reshape(B, S, KV, G, Dh)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(acc))
    return (dq.reshape(B, S, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
