"""GPipe-style pipeline parallelism with the stages stacked on one device:
the reference's ``distributed.pipeline`` on torch tensors.

Stage parameters are stacked along a leading ``stages`` axis
(``stack_stage_params``).  The skew schedule runs ``M + S - 1`` ticks; at
tick t stage 0 takes microbatch t (zeros once the microbatches run out),
every other stage takes what the stage before it gave at tick t - 1, and
the last stage's output is kept from tick ``S - 1`` on:

    tick t:  buf[s] <- stage_s(buf[s-1]),   buf[0] <- microbatch_t

The reference runs the stages of a tick at once (``jax.vmap`` over the
stage axis, sharded over a mesh axis); here one device runs them one after
another inside the tick.  As in the reference every stage runs at every
tick, the bubble slots on zeros or on what earlier bubbles gave, so a tick
costs S stage calls.  ``torch.func.vmap`` is not used: it cannot trace
through the ctypes-bound kernels a stage may launch.  Gradients flow
through autograd.  Bubble fraction = (S - 1) / (M + S - 1), reported by
``pipeline_stats``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.models.transformer import _stack, unbind

Params = Any


@dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int

    @property
    def n_ticks(self) -> int:
        return self.n_microbatches + self.n_stages - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.n_ticks


def pipeline_forward(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                     stacked_params: Params, microbatches: torch.Tensor,
                     cfg: PipelineConfig) -> torch.Tensor:
    """Run microbatches through the stage pipeline.

    stage_fn: (stage_params, x) -> y for ONE stage, y shaped as x.
    stacked_params: tree with a leading (n_stages,) axis.
    microbatches: (M, mb, ...) inputs.
    Returns (M, mb, ...) outputs of the last stage, in order.
    """
    S, M = cfg.n_stages, cfg.n_microbatches
    if microbatches.shape[0] != M:
        raise ValueError(f"{microbatches.shape[0]} microbatches, the "
                         f"config has {M}")
    stages = unbind(stacked_params, S)
    zeros = microbatches.new_zeros(microbatches.shape[1:])
    buf = [zeros] * S
    outs = []
    for t in range(cfg.n_ticks):
        inflow = [microbatches[t] if t < M else zeros] + buf[:-1]
        buf = [stage_fn(p, x) for p, x in zip(stages, inflow)]
        if t >= S - 1:              # microbatch t - S + 1 leaves the pipe
            outs.append(buf[-1])
    return torch.stack(outs)


def split_microbatches(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} is not a multiple of {n_microbatches} "
                         "microbatches")
    return x.reshape((n_microbatches, B // n_microbatches) + x.shape[1:])


def merge_microbatches(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + x.shape[2:])


def stack_stage_params(per_stage: Tuple[Params, ...]) -> Params:
    """One tree whose leaves stack the stages' leaves (a copy)."""
    return _stack(per_stage)


def pipeline_stats(cfg: PipelineConfig) -> dict:
    return {"ticks": cfg.n_ticks, "bubble_fraction": cfg.bubble_fraction,
            "efficiency": 1.0 - cfg.bubble_fraction}
