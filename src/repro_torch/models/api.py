"""Family-dispatched model API: one entry point per operation, for every
family of the registry (decoder-only ``dense``, ``moe``, ``ssm``,
``hybrid`` and ``vlm``, and the ``audio`` encoder-decoder)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer

Params = Dict[str, Any]


def param_specs(cfg: ModelConfig) -> Params:
    if cfg.is_encoder_decoder:
        return encdec.param_specs(cfg)
    return transformer.param_specs(cfg)


def forward_logits(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], *,
                   attn_impl: str = "auto", want_caches: bool = False,
                   cache_len: int = 0):
    """Returns (logits, aux_loss, caches|None) for any family.

    batch keys: ``tokens`` (B, S) always; ``patches`` (vlm) / ``frames``
    (audio) are the modality-stub embeddings (B, frontend_len, d_model).
    """
    if cfg.is_encoder_decoder:
        return encdec.forward(cfg, params, batch["frames"], batch["tokens"],
                              attn_impl=attn_impl, want_caches=want_caches,
                              cache_len=cache_len)
    return transformer.forward(cfg, params, batch["tokens"],
                               extra_embeds=batch.get("patches"),
                               attn_impl=attn_impl, want_caches=want_caches,
                               cache_len=cache_len)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                recent_len: int = 0) -> Params:
    if cfg.is_encoder_decoder:
        return encdec.init_caches(cfg, batch, cache_len,
                                  recent_len=recent_len)
    return transformer.init_caches(cfg, batch, cache_len,
                                   recent_len=recent_len)


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                caches: Params, cur_pos: int):
    if cfg.is_encoder_decoder:
        return encdec.decode_step(cfg, params, token, caches, cur_pos)
    return transformer.decode_step(cfg, params, token, caches, cur_pos)
