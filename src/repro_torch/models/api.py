"""Family-dispatched model API: one entry point per operation.  The port
has the dense, ssm (Mamba2) and hybrid (Zamba2) decoder families; MoE and
encoder-decoder models and the ``patches``/``frames`` front ends raise
``NotImplementedError``."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

Params = Dict[str, Any]


def param_specs(cfg: ModelConfig) -> Params:
    return transformer.param_specs(cfg)


def forward_logits(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], *,
                   attn_impl: str = "auto", want_caches: bool = False,
                   cache_len: int = 0):
    """Returns (logits, aux_loss, caches|None).  ``batch`` holds
    ``tokens`` (B, S)."""
    extra = sorted(set(batch) - {"tokens"})
    if extra:
        raise NotImplementedError(
            f"batch keys {extra}: modality front ends are not ported yet")
    return transformer.forward(cfg, params, batch["tokens"],
                               attn_impl=attn_impl, want_caches=want_caches,
                               cache_len=cache_len)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int) -> Params:
    return transformer.init_caches(cfg, batch, cache_len)


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                caches: Params, cur_pos: int):
    return transformer.decode_step(cfg, params, token, caches, cur_pos)
