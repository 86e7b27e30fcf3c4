"""Training step: loss, gradients, optimizer update, with microbatch
gradient accumulation: the reference's ``train.step`` on torch tensors.

The reference differentiates ``loss_fn`` with ``jax.value_and_grad`` and
accumulates microbatches under ``lax.scan``; here autograd takes the
gradient (``torch.autograd.grad`` with respect to detached copies of the
parameters, so the parameters themselves never carry autograd state) and
a Python loop accumulates.  Every model kernel on the path is
differentiable: flash attention through ``FlashAttention`` (the
hand-written backward kernels on the card), the SSD scan through ``SSD``
(its hand-written backward kernels on the card).  ``adamw_update`` then
writes the new parameters and moments in place (``optim.adamw``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import map_tree
from repro_torch.models import api
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     init_opt_state, tree_leaves)

Params = Dict[str, Any]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0.  The max is taken without
    gradient, as the reference's ``stop_gradient``; the picked logit is
    read by index, which equals the reference's one-hot contraction (every
    other term is zero) without its (B, S, V) one-hot.  The padded vocab's
    ``-1e9`` logits add ``exp(-1e9 - m) = 0`` to the sum."""
    lab = torch.clamp_min(labels, 0).long()
    m = logits.detach().amax(dim=-1)
    shifted = logits - m[..., None].to(logits.dtype)
    lse = torch.log(torch.sum(torch.exp(shifted.float()), dim=-1))
    picked = torch.gather(shifted, -1, lab[..., None])[..., 0].float()
    ll = picked - lse
    mask = (labels >= 0).float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss": the CE, "aux_loss"}): the CE plus the MoE layers'
    aux loss at ``cfg.moe.aux_loss_weight``."""
    logits, aux, _ = api.forward_logits(cfg, params, batch,
                                        attn_impl=attn_impl)
    ce = cross_entropy(logits, batch["labels"])
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return ce + aux_w * aux, {"loss": ce, "aux_loss": aux}


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def value_and_grad(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], *,
                   attn_impl: str = "auto"):
    """((loss, metrics), grads): ``jax.value_and_grad(loss_fn,
    has_aux=True)`` by autograd; each gradient in its parameter's dtype (a
    parameter the loss does not reach gets zeros)."""
    live = map_tree(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, live, batch, attn_impl=attn_impl)
        flat = tree_leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = (torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), _unflatten(params, grads)


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    return [{n: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
             for n, x in batch.items()} for i in range(k)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, attn_impl: str = "auto",
                    grad_transform: Optional[Callable] = None) -> Callable:
    """``step(state, batch) -> (state, metrics)``.  ``grad_transform(grads,
    state) -> (grads, state)`` is where gradient compression plugs in
    (``distributed.compression``).  The parameters and moments of
    ``state`` are updated in place."""
    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if microbatches > 1:
            grads = map_tree(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = aux_sum = torch.zeros((), dtype=torch.float32)
            for one in _split_microbatches(batch, microbatches):
                (_, m), g = value_and_grad(cfg, params, one,
                                           attn_impl=attn_impl)
                grads = _add(grads, g)
                loss_sum = loss_sum + m["loss"].cpu()
                aux_sum = aux_sum + m["aux_loss"].cpu()
            grads = map_tree(lambda g: g / microbatches, grads)
            metrics = {"loss": loss_sum / microbatches,
                       "aux_loss": aux_sum / microbatches}
        else:
            (_, metrics), grads = value_and_grad(cfg, params, batch,
                                                 attn_impl=attn_impl)
        if grad_transform is not None:
            grads, state = grad_transform(grads, state)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, state["opt"])
        metrics.update(opt_metrics)
        new_state = dict(state)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, metrics

    return step


def _add(a, b):
    """The leaf-by-leaf sum of two trees."""
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     params: Params) -> Dict[str, Any]:
    return {"params": params, "opt": init_opt_state(opt_cfg, params)}
