"""Transformer building blocks on torch tensors: norms, rope, attention
(full and one-token decode over a ring cache) and the MLP.

Parameters are plain dicts of tensors described by ``ParamSpec`` trees
(``distributed.sharding``), with the reference's names and layouts.  Every
matmul casts its weight to the activation dtype, as the reference's
``p["wq"].astype(h.dtype)`` does; a bf16 working copy made once
(``serve.step.working_params``) gives the same bits, and the cast is then a
no-op.

Full self-attention goes through ``kernels.flash_attention.ops``: the
hand-written kernels for a CUDA tensor, their plain versions for a CPU
tensor (the reference's ``attn_impl="pallas"``), differentiable through
its autograd ``Function`` (the forward saves lse, the backward runs the
flash backward kernels).  ``attn_impl="exact"`` is ``attention_exact``,
the reference's einsum oracle.  The reference sends a long training
sequence (S > 2048, a multiple of 1024) to its jnp flash attention with
its custom VJP, for the memory; that is what every sequence takes here.

A decode cache is one ring, or (``make_cache(recent=)``) the reference's
two buffers: the prefill's main cache, only read while decoding, and a
small ring of the recent tokens, the two attended as partial softmaxes
merged (``_attention_partial``, ``_merge_partials``).  The reference's
serving engine never folds the ring into the main cache, and the port
adds no fold either.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import DTYPES, ParamSpec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Norms / activations / rope
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(dt)


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


_FREQS: Dict[tuple, torch.Tensor] = {}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (i / half)``, computed once per (head_dim, theta,
    device) on the CPU and copied over: every device gets the same bits,
    and a decode step makes no host-to-device copy (a synchronizing one
    per layer would stall the host's run-ahead)."""
    key = (head_dim, float(theta), str(torch.device(device or "cpu")))
    if key not in _FREQS:
        half = head_dim // 2
        exps = torch.arange(half, dtype=torch.float32) / half
        freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                                exps)
        _FREQS[key] = freqs.to(device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None, None].float() * freqs        # (...,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# --------------------------------------------------------------------------
# Attention — exact / decode
# --------------------------------------------------------------------------

def _gqa_expand(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,KV,Dh) -> (B,S,H,Dh) by repeating each kv head."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def attention_exact(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Reference attention. q:(B,Sq,H,Dh) k,v:(B,Sk,KV,Dh).  As in the
    reference, the logits and probabilities round to q's dtype."""
    n_heads = q.shape[-2]
    k = _gqa_expand(k, n_heads)
    v = _gqa_expand(v, n_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _valid_slots(positions: torch.Tensor, cur_pos: int,
                 window: int) -> torch.Tensor:
    """The cache slots a one-token query at ``cur_pos`` attends: written
    (position >= 0), not ahead of it and, in a window, inside it."""
    valid = (positions >= 0) & (positions <= cur_pos)
    return valid & (positions > cur_pos - window) if window else valid


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_positions: torch.Tensor,
                     cur_pos: int, *, window: int = 0) -> torch.Tensor:
    """One-token attention over a (ring-buffered) cache.

    q: (B,1,H,Dh); caches: (B,Sc,KV,Dh); cache_positions: (Sc,) absolute
    positions per slot (-1 = unwritten); cur_pos: the current position.
    GQA via grouped einsums (no repeat-expansion of the cache).
    """
    B, _, H, Dh = q.shape
    KV = k_cache.shape[-2]
    qg = q[:, 0].reshape(B, KV, H // KV, Dh)
    scale = 1.0 / math.sqrt(Dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    logits = logits.masked_fill(
        ~_valid_slots(cache_positions, cur_pos, window), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache)
    return out.reshape(B, 1, H, Dh)


# --------------------------------------------------------------------------
# Attention block (params + apply)
# --------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig, prefix: Tuple[int, ...] = ()) -> Params:
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    pd = cfg.param_dtype
    lead = prefix
    ax = ("layers",) * len(prefix)
    return {
        "ln": ParamSpec(lead + (D,), "float32", ax + ("embed",), init="zeros"),
        "wq": ParamSpec(lead + (D, Q), pd, ax + ("embed", "heads_merged")),
        "wk": ParamSpec(lead + (D, KV), pd, ax + ("embed", "heads_merged")),
        "wv": ParamSpec(lead + (D, KV), pd, ax + ("embed", "heads_merged")),
        "wo": ParamSpec(lead + (Q, D), pd, ax + ("heads_merged", "embed")),
    }


def cross_attn_specs(cfg: ModelConfig,
                     prefix: Tuple[int, ...] = ()) -> Params:
    return attn_specs(cfg, prefix)


def make_cache(cfg: ModelConfig, batch: int, length: int,
               recent: int = 0) -> Params:
    """Decode KV cache, on torch's default device: one bf16 ring of
    ``length`` slots (pos -1 = unwritten).  With ``recent > 0`` it is the
    reference's two buffers: ``k/v/pos``, the prefill's cache, which
    decode only reads, and ``rk/rv/rpos``, a ring of ``recent`` slots
    that each decoded token is written into."""
    def ring(n):
        shape = (batch, n, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=torch.bfloat16),
                torch.zeros(shape, dtype=torch.bfloat16),
                torch.full((n,), -1, dtype=torch.int32))

    c = dict(zip(("k", "v", "pos"), ring(length)))
    if recent > 0:
        c.update(zip(("rk", "rv", "rpos"), ring(recent)))
    return c


def _attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor):
    """Unnormalized one-token attention over one KV source.

    q: (B,1,H,Dh); k/v: (B,S,KV,Dh); valid: (S,) bool.  Returns (acc
    (B,H,Dh), m (B,H), l (B,H)) float32 partial-softmax stats.  GQA by
    grouped einsums (no repeat-expansion of the cache); the logits are
    float32 and the weights are cast to v's dtype before p.V, as in the
    reference.  A source with no valid slot has m = NEG_INF, which is
    finite, so ``_merge_partials`` weighs it by exp(NEG_INF - m) = 0."""
    B, _, H, Dh = q.shape
    KV = k.shape[-2]
    qg = q[:, 0].reshape(B, KV, H // KV, Dh)
    scale = 1.0 / math.sqrt(Dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k).float() * scale
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1)                                   # (B,KV,G)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).float()
    return acc.reshape(B, H, Dh), m.reshape(B, H), p.sum(dim=-1).reshape(B, H)


def _merge_partials(parts) -> torch.Tensor:
    """Combine partial-softmax (acc, m, l) triples into the normalized
    output (B,H,Dh), float32."""
    m = parts[0][1]
    for _, m_i, _ in parts[1:]:
        m = torch.maximum(m, m_i)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for acc_i, m_i, l_i in parts:
        corr = torch.exp(m_i - m)
        acc = acc + acc_i * corr[..., None]
        l = l + l_i * corr
    return acc / torch.clamp_min(l, 1e-37)[..., None]


def attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
               positions: torch.Tensor, window: int = 0, causal: bool = True,
               cache: Optional[Params] = None, cur_pos: Optional[int] = None,
               kv_source: Optional[torch.Tensor] = None,
               attn_impl: str = "auto", return_kv: bool = False):
    """Self- or cross-attention block with pre-norm and residual.

    Modes:
      * full (train / prefill): ``cache is None``; optionally
        ``return_kv`` to hand back roped K/V for cache construction.
      * decode: ``cache`` given -- one-token query written into the ring
        at slot ``cur_pos % length``; in a two-buffer cache (``"rk"`` in
        it) into the recent ring at ``cur_pos % recent``, the main
        ``k/v/pos`` only read, and the attention is the merge of one
        partial softmax over each.  The port updates the ring's tensors in
        place (the reference returns new arrays): no copy of the cache
        per token.  Returns the same dict.
      * cross: ``kv_source`` given (encoder states) -- K/V from it without
        rope, exact non-causal attention (the reference's einsum oracle,
        no kernel); returns ``(x + out, None)``.
    """
    B = x.shape[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"].to(h.dtype)).reshape(B, -1, cfg.n_heads, cfg.head_dim)
    if kv_source is not None:                        # cross attention
        src = kv_source.to(h.dtype)
        k = (src @ p["wk"].to(h.dtype)).reshape(B, -1, cfg.n_kv_heads,
                                                cfg.head_dim)
        v = (src @ p["wv"].to(h.dtype)).reshape(B, -1, cfg.n_kv_heads,
                                                cfg.head_dim)
        out = attention_exact(q, k, v, causal=False)
        return x + out.reshape(B, -1, cfg.q_dim) @ p["wo"].to(h.dtype), None
    q = apply_rope(q, positions, cfg.rope_theta)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, -1, cfg.n_kv_heads,
                                          cfg.head_dim)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, -1, cfg.n_kv_heads,
                                          cfg.head_dim)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:                                # full self-attention
        S = q.shape[1]
        if attn_impl == "auto":
            out = fa_ops.flash_attention(q, k, v, causal=causal,
                                         window=window)
        elif attn_impl == "exact":
            out = attention_exact(q, k, v, causal=causal, window=window)
        else:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        out = out.reshape(B, S, cfg.q_dim) @ p["wo"].to(h.dtype)
        return x + out, ((k, v) if return_kv else None)

    # ---- decode: single token --------------------------------------------
    # the token goes into the ring: the recent one of a two-buffer cache,
    # whose main k/v/pos are only read, else the cache itself
    assert cur_pos is not None
    cur_pos = int(cur_pos)
    ring = ("rk", "rv", "rpos") if "rk" in cache else ("k", "v", "pos")
    slot = cur_pos % cache[ring[0]].shape[1]
    cache[ring[0]][:, slot] = k[:, 0].to(cache[ring[0]].dtype)
    cache[ring[1]][:, slot] = v[:, 0].to(cache[ring[1]].dtype)
    cache[ring[2]][slot] = cur_pos
    if "rk" in cache:
        out = _merge_partials([
            _attention_partial(q, cache[kk].to(h.dtype),
                               cache[vk].to(h.dtype),
                               _valid_slots(cache[pk], cur_pos, window))
            for kk, vk, pk in (("k", "v", "pos"), ring)]).to(h.dtype)
    else:
        out = attention_decode(q, cache["k"].to(h.dtype),
                               cache["v"].to(h.dtype), cache["pos"], cur_pos,
                               window=window)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"].to(h.dtype)
    return x + out, cache


# --------------------------------------------------------------------------
# MLP block
# --------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None,
              prefix: Tuple[int, ...] = ()) -> Params:
    D = cfg.d_model
    F_ = d_ff if d_ff is not None else cfg.d_ff
    pd = cfg.param_dtype
    lead, ax = prefix, ("layers",) * len(prefix)
    wi_cols = 2 * F_ if cfg.gated_mlp else F_
    return {
        "ln": ParamSpec(lead + (D,), "float32", ax + ("embed",), init="zeros"),
        "wi": ParamSpec(lead + (D, wi_cols), pd, ax + ("embed", "mlp")),
        "wo": ParamSpec(lead + (F_, D), pd, ax + ("mlp", "embed")),
    }


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    hi = h @ p["wi"].to(h.dtype)
    if cfg.gated_mlp:
        gate, up = torch.chunk(hi, 2, dim=-1)
        hi = act(gate) * up
    else:
        hi = act(hi)
    return x + hi @ p["wo"].to(h.dtype)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]
