"""Batched serving engine.

Round-based batching: up to ``max_batch`` queued requests are prefetched
into one prefill, then decoded together until every sequence reaches its
generation budget.  The engine records per-request latency, and per round
the prefill time and the decode time per step (``round_stats``).

As in the reference: prompts are left-padded with token 0 and the pads are
attended to (positions start at the pad); an audio (``frames``) or vision
(``patches``) model gets its front-end stub, zeros of (B, frontend_len,
d_model) in bfloat16; the prefill builds caches of ``max_prompt +
max_gen`` slots; ``max_gen - 1`` decode steps follow at ``cur =
max_prompt + step - 1``; outputs are cut per request at its ``gen_len``;
the sampling key is split once per sampled token (on the host: a split is
a few words of threefry).  Each step's tokens are read back once
(``tolist``), and the time stamps follow that synchronizing read.

The reference's ring size and decode positions do not count the patches
a vision model prepends, and the port keeps them so.  When the patches
make the prefill longer than the ring, the ring keeps the prefill's last
positions, and those past a decode step's position are masked from it.
At phi-3-vision's full size (576 patches, 32 generated tokens) the ring
keeps positions 544 and up, and a decode step at position ``cur`` sees
those up to ``cur``: no prompt token while ``cur < 576``, which holds at
every step for a prompt of up to 545 tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import ModelConfig
from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                    model_inputs, sample_token,
                                    working_params)


@dataclass
class Request:
    rid: int
    tokens: List[int]
    gen_len: int
    submit_s: float = 0.0
    start_s: float = 0.0
    finish_s: float = 0.0
    output: List[int] = field(default_factory=list)

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.submit_s


class BatchingEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *, max_batch: int = 8,
                 temperature: float = 0.0, seed: int = 0):
        self.cfg = cfg
        self.params = working_params(cfg, params)
        self.device = self.params["embed"].device
        self.max_batch = max_batch
        self.temperature = temperature
        self._decode = make_decode_step(cfg)
        self._queue: List[Request] = []
        self._done: List[Request] = []
        self._key = rng.key(seed)
        self._next_rid = 0
        self.round_stats: List[Dict[str, float]] = []

    def submit(self, tokens: List[int], gen_len: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, tokens=list(tokens),
                                   gen_len=gen_len, submit_s=time.time()))
        return rid

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        self._key, k = rng.split(self._key)
        return sample_token(logits[:, 0], k, self.temperature)[:, None]

    def _run_round(self) -> None:
        batch = self._queue[: self.max_batch]
        self._queue = self._queue[self.max_batch:]
        t0 = time.time()
        for r in batch:
            r.start_s = t0
        max_prompt = max(len(r.tokens) for r in batch)
        max_gen = max(r.gen_len for r in batch)
        B = len(batch)
        toks = np.zeros((B, max_prompt), np.int64)
        for i, r in enumerate(batch):                 # left-pad to align ends
            toks[i, max_prompt - len(r.tokens):] = r.tokens
        inputs = model_inputs(self.cfg,
                              torch.from_numpy(toks).to(self.device))

        # prefill must leave room for generated tokens in the ring caches
        prefill = make_prefill_step(self.cfg, cache_len=max_prompt + max_gen)
        logits, caches = prefill(self.params, inputs)
        token = self._sample(logits)
        for r, t in zip(batch, token[:, 0].tolist()):
            r.output.append(t)
        t1 = time.time()
        for step in range(1, max_gen):
            cur = max_prompt + step - 1
            logits, caches = self._decode(self.params, token, caches, cur)
            token = self._sample(logits)
            for r, t in zip(batch, token[:, 0].tolist()):
                if len(r.output) < r.gen_len:
                    r.output.append(t)
        now = time.time()
        self.round_stats.append({
            "batch": B, "prompt_len": max_prompt, "prefill_s": t1 - t0,
            "decode_steps": max_gen - 1,
            "decode_s_per_step": (now - t1) / max(max_gen - 1, 1)})
        for r in batch:
            r.finish_s = now
            self._done.append(r)

    def run(self) -> List[Request]:
        while self._queue:
            self._run_round()
        done, self._done = self._done, []
        return done

    @staticmethod
    def summarize(requests: List[Request]) -> Dict[str, float]:
        lats = np.array([r.latency_s for r in requests])
        toks = sum(len(r.output) for r in requests)
        span = (max(r.finish_s for r in requests)
                - min(r.submit_s for r in requests))
        return {"n": len(requests), "mean_latency_s": float(lats.mean()),
                "p95_latency_s": float(np.percentile(lats, 95)),
                "tokens_per_s": toks / max(span, 1e-9)}
