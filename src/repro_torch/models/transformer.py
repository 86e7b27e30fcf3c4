"""Decoder-LM assembly for the ``dense``, ``ssm`` (Mamba2) and ``hybrid``
(Zamba2: Mamba2 blocks and one shared attention block) families, on torch
tensors.

Layers are organized in repeating groups (``cfg.layer_kinds()``), with the
reference's parameter tree: ``groups`` holds each group position's
parameters stacked along a leading axis of ``n_groups`` (when there is more
than one group), ``tail`` the layers that do not fill a group.  A hybrid
group's ``attn`` position has no parameters of its own: every application
uses the top-level ``shared_attn`` tree, and each application keeps its own
KV ring.  The reference's ``lax.scan`` over the stacked groups is a Python
loop over the leading axis here; remat has no forward effect and is
dropped.  MoE models, encoder-decoder models and the modality front ends
raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model families later slices of the port bring."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet; they are the next "
            "model family (ROADMAP Queue 1, MoE)")
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models and the patches/frames "
            "front ends are not ported yet; they come after MoE (ROADMAP "
            "Queue 1, Encoder-decoder)")


def _scale_embeddings(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    # the reference multiplies by a Python float, which JAX rounds to the
    # activation dtype first (bf16: sqrt(2048) -> 45.25)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
    return h * scale


def _embed(cfg: ModelConfig, emb: torch.Tensor,
           tokens: torch.Tensor) -> torch.Tensor:
    h = emb[tokens.long()].to(L.compute_dtype(cfg))
    return _scale_embeddings(cfg, h) if cfg.tie_embeddings else h


def _logits_from_hidden(cfg: ModelConfig, h: torch.Tensor,
                        emb: torch.Tensor) -> torch.Tensor:
    """Unembedding with vocab-pad masking."""
    logits = torch.einsum("bsd,vd->bsv", h, emb.to(h.dtype))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    return logits


# --------------------------------------------------------------------------
# Param specs
# --------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, kind: str, prefix) -> Params:
    if kind == "mamba":
        return M.mamba_specs(cfg, prefix)
    if kind == "attn" and cfg.shared_attn:
        return {}       # parameters live in the top-level shared_attn entry
    return {"attn": L.attn_specs(cfg, prefix),
            "mlp": L.mlp_specs(cfg, prefix=prefix)}


def param_specs(cfg: ModelConfig) -> Params:
    check_supported(cfg)
    D = cfg.d_model
    kinds = cfg.layer_kinds()
    ng = cfg.n_groups
    specs: Params = {
        "embed": ParamSpec((cfg.padded_vocab, D), cfg.param_dtype,
                           ("vocab", "embed")),
        "final_ln": ParamSpec((D,), "float32", ("embed",), init="zeros"),
    }
    stacked_prefix = (ng,) if ng > 1 else ()
    specs["groups"] = {f"l{i}": _block_specs(cfg, kind, stacked_prefix)
                       for i, kind in enumerate(kinds)}
    if cfg.n_tail_layers:
        specs["tail"] = {f"l{i}": _block_specs(cfg, kind, ())
                         for i, kind in enumerate(kinds[: cfg.n_tail_layers])}
    if cfg.shared_attn:
        specs["shared_attn"] = {"attn": L.attn_specs(cfg, ()),
                                "mlp": L.mlp_specs(cfg, prefix=())}
    return specs


# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------

def _layer_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.local_window if kind == "local" else 0


def _index(tree, g: int):
    """Group ``g`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _groups(cfg: ModelConfig, tree):
    """The per-group slices of a ``groups`` tree, in order."""
    if cfg.n_groups > 1:
        return [_index(tree, g) for g in range(cfg.n_groups)]
    return [tree]


def _kv_to_ring(cfg: ModelConfig, kind: str, kv, cache_len: int):
    """Convert prefill K/V into the decode ring-buffer cache layout."""
    k, v = kv
    S = k.shape[1]
    window = _layer_window(cfg, kind)
    length = min(window, cache_len) if window else cache_len
    pos = torch.arange(S, dtype=torch.int32, device=k.device)
    if S >= length:
        shift = (S - length) % length
        k_r = torch.roll(k[:, S - length:], shift, dims=1)
        v_r = torch.roll(v[:, S - length:], shift, dims=1)
        p_r = torch.roll(pos[S - length:], shift, dims=0)
    else:
        padlen = length - S
        k_r = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, padlen))
        v_r = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, padlen))
        p_r = torch.cat([pos, torch.full((padlen,), -1, dtype=torch.int32,
                                         device=k.device)])
    return {"k": k_r.to(torch.bfloat16), "v": v_r.to(torch.bfloat16),
            "pos": p_r}


def _stack(caches):
    """List of per-group cache trees -> one tree stacked on a new axis 0."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: _stack([c[k] for c in caches]) for k in first}
    return torch.stack(caches)


def _attn_params(cfg: ModelConfig, kind: str, bp: Params,
                 shared: Optional[Params]) -> Params:
    """The attention and MLP parameters a layer of ``kind`` uses."""
    return shared if kind == "attn" and cfg.shared_attn else bp


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            attn_impl: str = "auto", want_caches: bool = False,
            cache_len: int = 0):
    """Full forward.  Returns (logits, aux_loss, caches|None); the ported
    families have no auxiliary loss (a zero).  ``want_caches``
    additionally returns decode caches: Mamba2 states and conv histories,
    and KV rings of length ``cache_len`` (defaults to the sequence
    length)."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()
    emb = params["embed"]
    h = _embed(cfg, emb, tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    cache_len = cache_len or S
    shared = params.get("shared_attn")

    def layer(h, kind, bp):
        if kind == "mamba":
            return M.mamba_apply(cfg, bp, h, return_state=want_caches)
        ap = _attn_params(cfg, kind, bp, shared)
        h, kv = L.attn_apply(cfg, ap["attn"], h, positions=positions,
                             window=_layer_window(cfg, kind),
                             attn_impl=attn_impl, return_kv=want_caches)
        h = L.mlp_apply(cfg, ap["mlp"], h)
        return h, (_kv_to_ring(cfg, kind, kv, cache_len)
                   if want_caches else None)

    group_caches = []
    for gp in _groups(cfg, params["groups"]):
        caches = {}
        for i, kind in enumerate(kinds):
            h, caches[f"l{i}"] = layer(h, kind, gp[f"l{i}"])
        group_caches.append(caches)
    tail_caches = {}
    for i, kind in enumerate(kinds[: cfg.n_tail_layers]):
        h, tail_caches[f"l{i}"] = layer(h, kind, params["tail"][f"l{i}"])

    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = _logits_from_hidden(cfg, h, emb)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if not want_caches:
        return logits, aux, None
    groups = _stack(group_caches) if cfg.n_groups > 1 else group_caches[0]
    return logits, aux, {"groups": groups, "tail": tail_caches}


# --------------------------------------------------------------------------
# Decode (one token, ring-buffer caches)
# --------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, cache_len: int) -> Params:
    """Zero-initialized decode caches (pos = -1 -> masked), on torch's
    default device."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()

    def one(kind: str) -> Params:
        if kind == "mamba":
            return M.make_mamba_cache(cfg, batch)
        window = _layer_window(cfg, kind)
        length = min(window, cache_len) if window else cache_len
        return L.make_cache(cfg, batch, length)

    groups = [{f"l{i}": one(kind) for i, kind in enumerate(kinds)}
              for _ in range(cfg.n_groups)]
    tail = {f"l{i}": one(kind)
            for i, kind in enumerate(kinds[: cfg.n_tail_layers])}
    return {"groups": _stack(groups) if cfg.n_groups > 1 else groups[0],
            "tail": tail}


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                caches: Params, cur_pos: int):
    """One decode step.  token: (B,1) int; cur_pos: the position being
    written.  Returns (logits (B,1,V), caches): the caches are updated in
    place and returned."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()
    emb = params["embed"]
    h = _embed(cfg, emb, token)
    B = h.shape[0]
    cur_pos = int(cur_pos)
    positions = torch.full((B, 1), cur_pos, device=h.device)
    shared = params.get("shared_attn")

    def layer(h, kind, bp, cache):
        if kind == "mamba":
            return M.mamba_apply(cfg, bp, h, cache=cache)[0]
        ap = _attn_params(cfg, kind, bp, shared)
        h, _ = L.attn_apply(cfg, ap["attn"], h, positions=positions,
                            window=_layer_window(cfg, kind), cache=cache,
                            cur_pos=cur_pos)
        return L.mlp_apply(cfg, ap["mlp"], h)

    for gp, gc in zip(_groups(cfg, params["groups"]),
                      _groups(cfg, caches["groups"])):
        for i, kind in enumerate(kinds):
            h = layer(h, kind, gp[f"l{i}"], gc[f"l{i}"])
    for i, kind in enumerate(kinds[: cfg.n_tail_layers]):
        h = layer(h, kind, params["tail"][f"l{i}"], caches["tail"][f"l{i}"])

    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _logits_from_hidden(cfg, h, emb), caches
