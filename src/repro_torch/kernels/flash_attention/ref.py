"""Plain PyTorch version of the ``flash_attention`` kernel.

Materialized softmax attention in float32 with the kernel's masks
(causal ``kpos <= qpos``, window ``kpos > qpos - window``), its finite
``NEG_INF`` for masked logits, its GQA mapping (q head ``h`` reads kv head
``h // (H // KV)``) and its final cast to q's dtype.  The kernel's online
softmax reaches the same values up to float32 rounding.
"""
from __future__ import annotations

import math

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,Dh); k/v: (B,S,KV,Dh) -> (B,S,H,Dh) in q's dtype."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    logits = logits * (1.0 / math.sqrt(Dh))
    logits = logits.masked_fill(~band_mask(S, causal, window, q.device),
                                NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, S, H, Dh).to(q.dtype)
