"""Decoder-LM assembly for the ``dense``, ``moe``, ``ssm`` (Mamba2),
``hybrid`` (Zamba2: Mamba2 blocks and one shared attention block) and
``vlm`` (patch embeddings prepended to the tokens) families, on torch
tensors.

Layers are organized in repeating groups (``cfg.layer_kinds()``), with the
reference's parameter tree: ``groups`` holds each group position's
parameters stacked along a leading axis of ``n_groups`` (when there is more
than one group), ``tail`` the layers that do not fill a group.  A hybrid
group's ``attn`` position has no parameters of its own: every application
uses the top-level ``shared_attn`` tree, and each application keeps its own
KV ring.  The reference's ``lax.scan`` over the stacked groups is a Python
loop over the leading axis here, over views that ``unbind`` makes once per
forward (under autograd a stacked leaf's gradient is then one stack of
its groups' gradients).

Remat: where ``cfg.remat`` is set and autograd records, each layer group
runs under ``torch.utils.checkpoint`` (non-reentrant), as the reference
wraps its group body in ``jax.checkpoint``: the backward recomputes the
group's forward from its input.  Both of the reference's policies map to
that whole-group recompute (``proj_outs``, which also saves the attention
and MLP projection outputs, is kept as a name only).  The values do not
change, only the memory: one group's activations at a time instead of
every layer's.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

Params = Dict[str, Any]


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
    block: Params = {"attn": L.attn_specs(cfg, prefix)}
    if cfg.moe is not None:
        block["moe"] = MOE.moe_specs(cfg, prefix)
    else:
        block["mlp"] = L.mlp_specs(cfg, prefix=prefix)
    return block


def _ffn(cfg: ModelConfig, bp: Params, h: torch.Tensor):
    """The block's feed-forward half: (h, aux loss or None)."""
    if "moe" in bp:
        return MOE.moe_apply(cfg, bp["moe"], h)
    return L.mlp_apply(cfg, bp["mlp"], h), None


def param_specs(cfg: ModelConfig) -> Params:
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


def unbind(tree, n: int) -> list:
    """The ``n`` slices of a tree stacked along its leading axis, in order
    (views, no copy).  Each leaf is unbound once: under autograd its
    gradient is one stack of the slices' gradients, where indexing slice
    by slice would add a full-size zero tensor per slice."""
    if isinstance(tree, dict):
        parts = {k: unbind(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in parts.items()} for g in range(n)]
    return tree.unbind(0)


def _groups(cfg: ModelConfig, tree):
    """The per-group slices of a ``groups`` tree, in order."""
    if cfg.n_groups > 1:
        return unbind(tree, cfg.n_groups)
    return [tree]


def remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` under non-reentrant activation checkpointing where
    ``cfg.remat`` is set and autograd records, else ``fn`` itself."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


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


def apply_block_full(cfg: ModelConfig, kind: str, bp: Params,
                     shared: Optional[Params], h: torch.Tensor,
                     positions: torch.Tensor, *, attn_impl: str = "auto",
                     want_cache: bool = False):
    """One layer of ``kind`` in full (train / prefill) mode, the
    reference's ``_apply_block_full``: (h, aux loss or None, cache or
    None), the cache a Mamba2 layer's state or an attention layer's roped
    (K, V).  ``shared`` is the top-level ``shared_attn`` tree (hybrid
    models), ``positions`` (B, S)."""
    if kind == "mamba":
        h, state = M.mamba_apply(cfg, bp, h, return_state=want_cache)
        return h, None, state
    ap = _attn_params(cfg, kind, bp, shared)
    h, kv = L.attn_apply(cfg, ap["attn"], h, positions=positions,
                         window=_layer_window(cfg, kind),
                         attn_impl=attn_impl, return_kv=want_cache)
    h, aux = _ffn(cfg, ap, h)
    return h, aux, kv


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            extra_embeds: Optional[torch.Tensor] = None,
            attn_impl: str = "auto", want_caches: bool = False,
            cache_len: int = 0):
    """Full forward.  Returns (logits, aux_loss, caches|None): the aux
    loss sums the MoE layers' (a zero without them).  ``extra_embeds``
    (B, P, D): modality-stub embeddings prepended to the token embeddings
    (vlm patches); positions run over the whole sequence and the logits
    are the tokens' only.  ``want_caches`` additionally returns decode
    caches: Mamba2 states and conv histories, and KV rings of length
    ``cache_len`` (defaults to the sequence length, patches included)."""
    kinds = cfg.layer_kinds()
    emb = params["embed"]
    h = _embed(cfg, emb, tokens)
    n_extra = 0
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
        n_extra = extra_embeds.shape[1]
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    cache_len = cache_len or S
    shared = params.get("shared_attn")
    zero = torch.zeros((), dtype=torch.float32, device=h.device)

    def layer(h, kind, bp):
        """(h, aux or None, cache or None)."""
        h, aux, cache = apply_block_full(cfg, kind, bp, shared, h, positions,
                                         attn_impl=attn_impl,
                                         want_cache=want_caches)
        if want_caches and kind != "mamba":
            cache = _kv_to_ring(cfg, kind, cache, cache_len)
        return h, aux, cache

    def group(h, gp, caches):
        """(h, the group's aux loss); the group's caches into ``caches``."""
        aux_g = zero
        for i, kind in enumerate(kinds):
            h, aux, caches[f"l{i}"] = layer(h, kind, gp[f"l{i}"])
            if aux is not None:
                aux_g = aux_g + aux
        return h, aux_g

    # the caches are returned, not recomputed: remat only without them
    body = group if want_caches else remat(cfg, group)
    group_caches, group_aux = [], []
    for gp in _groups(cfg, params["groups"]):
        caches = {}
        h, aux_g = body(h, gp, caches)
        group_caches.append(caches)
        group_aux.append(aux_g)
    aux_total = (torch.stack(group_aux).sum() if cfg.n_groups > 1
                 else group_aux[0])
    tail_caches = {}
    for i, kind in enumerate(kinds[: cfg.n_tail_layers]):
        h, aux, tail_caches[f"l{i}"] = layer(h, kind,
                                             params["tail"][f"l{i}"])
        if aux is not None:
            aux_total = aux_total + aux

    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    if n_extra:
        h = h[:, n_extra:]
    logits = _logits_from_hidden(cfg, h, emb)
    if not want_caches:
        return logits, aux_total, None
    groups = _stack(group_caches) if cfg.n_groups > 1 else group_caches[0]
    return logits, aux_total, {"groups": groups, "tail": tail_caches}


# --------------------------------------------------------------------------
# Decode (one token, ring-buffer caches)
# --------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                recent_len: int = 0) -> Params:
    """Zero-initialized decode caches (pos = -1 -> masked), on torch's
    default device.  ``recent_len > 0`` gives the full-length caches the
    two-buffer layout (``layers.make_cache``); windowed local caches stay
    single small rings, Mamba2 caches are unchanged."""
    kinds = cfg.layer_kinds()

    def one(kind: str) -> Params:
        if kind == "mamba":
            return M.make_mamba_cache(cfg, batch)
        window = _layer_window(cfg, kind)
        length = min(window, cache_len) if window else cache_len
        return L.make_cache(cfg, batch, length,
                            recent=0 if window else recent_len)

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
        return _ffn(cfg, ap, h)[0]

    for gp, gc in zip(_groups(cfg, params["groups"]),
                      _groups(cfg, caches["groups"])):
        for i, kind in enumerate(kinds):
            h = layer(h, kind, gp[f"l{i}"], gc[f"l{i}"])
    for i, kind in enumerate(kinds[: cfg.n_tail_layers]):
        h = layer(h, kind, params["tail"][f"l{i}"], caches["tail"][f"l{i}"])

    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return _logits_from_hidden(cfg, h, emb), caches
