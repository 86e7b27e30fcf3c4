"""Serving steps: prefill (builds caches) and decode (one token)."""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch import rng
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import DTYPES, init_params
from repro_torch.models import api
from repro_torch.models.layers import compute_dtype

Params = Dict[str, Any]


# the leaves the reference uses in float32 and never casts to the
# activation dtype: norm scales (``ln``, ``final_ln``, the encoder's
# ``enc_ln``, Mamba2's ``gate_ln``), Mamba2's ``A_log`` (A = -exp(A_log)
# in f32) and ``dt_bias`` (added to dt in f32), and the MoE ``router``
# (its logits are ``h.float() @ router``)
FLOAT32_LEAVES = ("ln", "final_ln", "enc_ln", "gate_ln", "A_log", "dt_bias",
                  "router")


def working_params(cfg: ModelConfig, params: Params) -> Params:
    """The parameters as the steps use them: every weight but
    ``FLOAT32_LEAVES`` cast once to the activation dtype.  The reference
    casts those other weights at every use (``w.astype(h.dtype)``); a
    cast made once gives the same bits, and the model code's own casts
    then copy nothing."""
    dt = compute_dtype(cfg)

    def cast(tree):
        return {k: v if k in FLOAT32_LEAVES else
                (cast(v) if isinstance(v, dict) else v.to(dt))
                for k, v in tree.items()}
    return cast(params)


def init_working_params(cfg: ModelConfig,
                        generator: torch.Generator) -> Params:
    """``working_params(cfg, init_params(api.param_specs(cfg), generator))``
    built directly on the generator's device, bit for bit, without the
    full-precision tree: each leaf is drawn a layer at a time and cast at
    once into its working dtype (``sharding.init_params``'s ``hold``).
    qwen2-moe-a2.7b's 14.0 B float32 parameters do not fit on one 80 GB
    card beside their bfloat16 copy; its working tree alone is ~28 GB."""
    dt = compute_dtype(cfg)
    return init_params(
        api.param_specs(cfg), generator,
        hold=lambda name, s: DTYPES[s.dtype] if name in FLOAT32_LEAVES
        else dt)


def model_inputs(cfg: ModelConfig,
                 tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A prefill's batch: the tokens (B, S) and, for an audio
    (``frames``) or vision (``patches``) model, the reference engine's
    front-end stub, zeros of (B, frontend_len, d_model) in bfloat16 on the
    tokens' device."""
    batch = {"tokens": tokens}
    if cfg.frontend in ("frames", "patches"):
        batch[cfg.frontend] = torch.zeros(
            (tokens.shape[0], cfg.frontend_len, cfg.d_model),
            dtype=torch.bfloat16, device=tokens.device)
    return batch


def make_prefill_step(cfg: ModelConfig, *, cache_len: int = 0) -> Callable:
    def prefill(params: Params, batch: Dict[str, torch.Tensor]):
        logits, _, caches = api.forward_logits(
            cfg, params, batch, want_caches=True, cache_len=cache_len)
        return logits[:, -1:], caches
    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode(params: Params, token: torch.Tensor, caches: Params,
               cur_pos: int):
        return api.decode_step(cfg, params, token, caches, cur_pos)
    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """First index of the maximum over the last axis (ties go to the
    smaller index, as ``jnp.argmax`` does)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    if temperature == 0.0:
        return greedy_sample(logits)
    return rng.categorical(key, logits.float() / temperature).to(torch.int32)
