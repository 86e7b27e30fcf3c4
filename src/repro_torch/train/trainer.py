"""Trainer: checkpoint/restart, preemption, optional gradient compression,
the reference's ``train.trainer`` on one device.

The reference jit-compiles its step; this one runs eagerly, and on a CUDA
device each step's wall time is taken after a synchronize, so it covers
the step's device work.  Parameters are drawn by the port's
``init_params`` from a generator seeded with ``seed`` on the device (not
``jax.random``'s draws; ``core.interop.train_state_from_reference``
carries a reference state across instead).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import pipeline_for_model
from repro_torch.distributed.compression import (ef_int8_transform,
                                                 init_error_state)
from repro_torch.distributed.fault import PreemptionHandler
from repro_torch.distributed.sharding import init_params
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    compress_grads: bool = False
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    """Trains ``model_cfg`` on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"``)."""

    def __init__(self, model_cfg: ModelConfig, tc: TrainerConfig,
                 device=None):
        self.model_cfg = model_cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.pipeline = pipeline_for_model(
            model_cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
            device=self.device)
        grad_transform = ef_int8_transform if tc.compress_grads else None
        self._step_fn = make_train_step(
            model_cfg, tc.opt, microbatches=tc.microbatches,
            grad_transform=grad_transform)
        self.ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None
        self.preemption = PreemptionHandler().install()
        self.history: List[Dict[str, float]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ api
    def init_state(self) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(api.param_specs(self.model_cfg), gen)
        state = init_train_state(self.model_cfg, self.tc.opt, params)
        if self.tc.compress_grads:
            state["ef_err"] = init_error_state(params)
        return state

    def restore_or_init(self):
        state = self.init_state()
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            state, start = self.ckpt.restore(state)
        return state, start

    def run(self, state=None, start_step: Optional[int] = None):
        if state is None:
            state, start_step = self.restore_or_init()
        start_step = start_step or 0
        for step in range(start_step, self.tc.steps):
            self._sync()
            t0 = time.perf_counter()
            batch = self.pipeline.batch_at(step)      # skip-ahead-safe
            state, metrics = self._step_fn(state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, step_time_s=dt)
            self.history.append(rec)
            if self.tc.log_every and step % self.tc.log_every == 0:
                print(f"[train] step={step} loss={rec['loss']:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if self.ckpt and (step + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(state, step + 1)
            if self.preemption.preempted():
                if self.ckpt:
                    self.ckpt.save(state, step + 1, block=True)
                print(f"[train] preempted at step {step + 1}; "
                      f"checkpointed and exiting", flush=True)
                return state, step + 1
        if self.ckpt:
            self.ckpt.save(state, self.tc.steps, block=True)
            self.ckpt.wait()
        return state, self.tc.steps

    def losses(self) -> np.ndarray:
        return np.array([h["loss"] for h in self.history])
