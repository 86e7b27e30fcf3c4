"""Deterministic, randomly-addressable synthetic data pipeline: the
reference's ``data.pipeline`` on the port's threefry (``rng``).

Every batch is a pure function of (seed, step, shard), with no iterator
state: a restarted worker asks for ``batch_at(resume_step)`` and gets the
same stream.  Tokens follow a Zipf distribution (exponent ``zipf_a``),
with document boundaries (token 0) at rate ``1 / doc_len_mean``.

The draws are ``jax.random``'s bits: the key is ``fold_in(fold_in(
key(seed), step), shard_id)``, split in three; tokens are the Zipf CDF
(numpy float64, cast to float32) searched (left side, as
``jnp.searchsorted``) at ``uniform`` draws, and a boundary is ``uniform <
1 / doc_len_mean`` (``jax.random.bernoulli``).  So tokens and labels equal
the reference's bit for bit.  The front-end stub embeddings (``patches``
/ ``frames``) are ``sqrt(2) * erfinv(u) * 0.02`` from float32 uniforms
(the algorithm of ``jax.random.normal``), rounded to bfloat16 at the end,
where the reference draws them in bfloat16: their bits differ.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import rng


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    doc_len_mean: int = 512
    n_shards: int = 1
    shard_id: int = 0
    frontend: str = "none"        # none | patches | frames
    frontend_len: int = 0
    d_model: int = 0

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class SyntheticPipeline:
    """``batch_at(step)`` on ``device`` (default the CPU)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = torch.device(device or "cpu")
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        probs /= probs.sum()
        self._cdf = torch.from_numpy(
            np.cumsum(probs).astype(np.float32)).to(self.device)

    def _tokens(self, k: torch.Tensor, shape) -> torch.Tensor:
        u = rng.uniform(k, shape)
        return torch.searchsorted(self._cdf, u).to(torch.int32)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        k = rng.fold_in(rng.fold_in(rng.key(cfg.seed, self.device), step),
                        cfg.shard_id)
        kt, kd, kf = rng.split(k, 3).unbind(0)
        B, S = cfg.shard_batch, cfg.seq_len
        toks = self._tokens(kt, (B, S + 1))
        bound = rng.uniform(kd, (B, S + 1)) < 1.0 / cfg.doc_len_mean
        toks = torch.where(bound, torch.zeros_like(toks), toks)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend in ("patches", "frames"):
            shape = (B, cfg.frontend_len, cfg.d_model)
            lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
            u = torch.clamp_min(rng.uniform(kf, shape) * 2.0 - 1.0,
                                float(lo))
            emb = (math.sqrt(2.0) * torch.erfinv(u) * 0.02).to(torch.bfloat16)
            batch["patches" if cfg.frontend == "patches" else "frames"] = emb
        return batch


def pipeline_for_model(model_cfg, global_batch: int, seq_len: int,
                       seed: int = 0, n_shards: int = 1, shard_id: int = 0,
                       device=None) -> SyntheticPipeline:
    return SyntheticPipeline(DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed, n_shards=n_shards,
        shard_id=shard_id, frontend=model_cfg.frontend,
        frontend_len=model_cfg.frontend_len, d_model=model_cfg.d_model),
        device=device)
