"""Encoder-decoder backbone (whisper-tiny) on torch tensors, the
reference's ``models/encdec.py``.  The conv/mel front end is a stub: the
inputs are precomputed frame embeddings (B, frames, d_model); the
transformer encoder and decoder and the cross-attention are real.

The encoder's self-attention is non-causal, with rope, through the
flash kernel; the decoder's self-attention is causal through it; the
cross-attention is the reference's exact einsum (no kernel).  Decode
caches: each decoder layer's self-attention ring (updated in place, as
the decoder-only models' are) and the encoder's cross K/V, computed once
in the prefill and cast to bfloat16 whatever the activation dtype, as the
reference does.  The reference's ``lax.scan`` over the stacked layers is
a Python loop over the leading axis here; under ``cfg.remat`` and
autograd each encoder layer, and each decoder layer of a forward without
caches, runs under ``transformer.remat`` (whole-layer recompute, the
reference's ``nothing_saveable``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_embed, _kv_to_ring,
                                            _logits_from_hidden, _stack,
                                            remat, unbind)

Params = Dict[str, Any]


def param_specs(cfg: ModelConfig) -> Params:
    V, D = cfg.padded_vocab, cfg.d_model
    enc_prefix, dec_prefix = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": ParamSpec((V, D), cfg.param_dtype, ("vocab", "embed")),
        "enc": {
            "attn": L.attn_specs(cfg, enc_prefix),
            "mlp": L.mlp_specs(cfg, prefix=enc_prefix),
        },
        "dec": {
            "self": L.attn_specs(cfg, dec_prefix),
            "cross": L.cross_attn_specs(cfg, dec_prefix),
            "mlp": L.mlp_specs(cfg, prefix=dec_prefix),
        },
        "enc_ln": ParamSpec((D,), "float32", ("embed",), init="zeros"),
        "final_ln": ParamSpec((D,), "float32", ("embed",), init="zeros"),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           attn_impl: str = "auto") -> torch.Tensor:
    """frames: (B, F, D) precomputed frame embeddings -> encoder states."""
    B, F, _ = frames.shape
    h = frames.to(L.compute_dtype(cfg))
    positions = torch.arange(F, device=h.device).expand(B, F)

    def body(h, p):
        h, _ = L.attn_apply(cfg, p["attn"], h, positions=positions,
                            causal=False, attn_impl=attn_impl)
        return L.mlp_apply(cfg, p["mlp"], h)

    body = remat(cfg, body)
    for p in unbind(params["enc"], cfg.n_enc_layers):
        h = body(h, p)
    return L.rms_norm(h, params["enc_ln"], cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, p: Params, enc: torch.Tensor):
    """A layer's static cross K/V over the encoder states, in bfloat16."""
    B = enc.shape[0]
    shape = (B, -1, cfg.n_kv_heads, cfg.head_dim)
    return [(enc @ p[w].to(enc.dtype)).reshape(shape).to(torch.bfloat16)
            for w in ("wk", "wv")]


def forward(cfg: ModelConfig, params: Params, frames: torch.Tensor,
            tokens: torch.Tensor, *, attn_impl: str = "auto",
            want_caches: bool = False, cache_len: int = 0):
    """Full encoder-decoder forward.  Returns (logits, aux (a zero),
    caches|None)."""
    enc = encode(cfg, params, frames, attn_impl=attn_impl)
    emb = params["embed"]
    h = _embed(cfg, emb, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    cache_len = cache_len or S
    def body(h, p):
        h, kv = L.attn_apply(cfg, p["self"], h, positions=positions,
                             attn_impl=attn_impl, return_kv=want_caches)
        h, _ = L.attn_apply(cfg, p["cross"], h, positions=positions,
                            kv_source=enc)
        return L.mlp_apply(cfg, p["mlp"], h), kv

    if not want_caches:
        body = remat(cfg, body)
    caches = []
    for p in unbind(params["dec"], cfg.n_layers):
        h, kv = body(h, p)
        if want_caches:
            ck, cv = _cross_kv(cfg, p["cross"], enc)
            caches.append({"self": _kv_to_ring(cfg, "global", kv, cache_len),
                           "cross_k": ck, "cross_v": cv})
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = _logits_from_hidden(cfg, h, emb)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return logits, aux, (_stack(caches) if want_caches else None)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                recent_len: int = 0) -> Params:
    """Zero decode caches (self ring pos = -1 -> masked, with a recent
    ring of ``recent_len`` slots beside it if that is > 0; cross K/V over
    ``frontend_len`` frames), on torch's default device."""
    cross = (batch, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim)
    return _stack([{"self": L.make_cache(cfg, batch, cache_len,
                                         recent=recent_len),
                    "cross_k": torch.zeros(cross, dtype=torch.bfloat16),
                    "cross_v": torch.zeros(cross, dtype=torch.bfloat16)}
                   for _ in range(cfg.n_layers)])


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                caches: Params, cur_pos: int):
    """One decoder step with the cached cross K/V.  token: (B,1) int;
    cur_pos: the position being written.  Returns (logits (B,1,V),
    caches): the self rings are updated in place."""
    emb = params["embed"]
    h = _embed(cfg, emb, token)
    B = h.shape[0]
    cur_pos = int(cur_pos)
    positions = torch.full((B, 1), cur_pos, device=h.device)
    for p, c in zip(unbind(params["dec"], cfg.n_layers),
                    unbind(caches, cfg.n_layers)):
        h, _ = L.attn_apply(cfg, p["self"], h, positions=positions,
                            cache=c["self"], cur_pos=cur_pos)
        # cross attention over the static cached K/V
        pc = p["cross"]
        hq = L.rms_norm(h, pc["ln"], cfg.norm_eps)
        q = (hq @ pc["wq"].to(hq.dtype)).reshape(B, 1, cfg.n_heads,
                                                 cfg.head_dim)
        out = L.attention_exact(q, c["cross_k"].to(hq.dtype),
                                c["cross_v"].to(hq.dtype), causal=False)
        h = h + out.reshape(B, 1, cfg.q_dim) @ pc["wo"].to(hq.dtype)
        h = L.mlp_apply(cfg, p["mlp"], h)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _logits_from_hidden(cfg, h, emb), caches
