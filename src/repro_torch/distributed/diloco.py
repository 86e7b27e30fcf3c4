"""DiLoCo-style cross-pod training: the reference's ``distributed.diloco``
on torch tensors.

Each pod runs K local AdamW steps on its own shard of the stream, and the
pods synchronize every K steps with an OUTER Nesterov-momentum update on
the average parameter delta (Douillard et al., DiLoCo):

    delta   = anchor - mean_p(params_p)
    m'      = beta * m + delta
    anchor' = anchor - lr_outer * (beta * m' + delta)    (Nesterov)
    params_p <- anchor'   (re-sync)

Pods are stacked along a leading axis of every leaf of their state, as in
the reference; its ``jax.vmap`` over pods and ``lax.scan`` over the inner
steps are loops here, over views of each pod's slice.

The port's train step (``train.step.make_train_step``) writes parameters
and moments in place, so nothing here may alias what a step writes:
``replicate_for_pods`` copies, ``init_outer_state`` keeps a copy of the
parameters as the anchor (the reference keeps ``params`` itself, which is
safe only with immutable arrays), each pod's state stays its own slice
across rounds, and ``outer_update`` writes the new anchor and momentum in
place and the new anchor into every pod's parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed.sharding import map_tree
from repro_torch.optim.adamw import tree_leaves

Params = Any


@dataclass(frozen=True)
class DiLoCoConfig:
    n_pods: int = 2
    inner_steps: int = 8
    outer_lr: float = 0.7
    outer_beta: float = 0.9


def replicate_for_pods(params: Params, n_pods: int) -> Params:
    """Every leaf stacked ``n_pods`` times along a new leading axis (a
    copy: no pod shares storage with ``params`` or another pod)."""
    return map_tree(lambda p: torch.stack([p.detach()] * n_pods), params)


def init_outer_state(params: Params) -> Dict[str, Params]:
    """The anchor (a copy of ``params``) and a float32 zero momentum."""
    return {"anchor": map_tree(lambda p: p.detach().clone(), params),
            "momentum": map_tree(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)}


@torch.no_grad()
def outer_update(cfg: DiLoCoConfig, outer: Dict[str, Params],
                 pod_params: Params) -> Tuple[Dict[str, Params], Params]:
    """pod_params: tree with a leading (n_pods,) axis.  Returns (the new
    outer state, the re-synced pod params): the arithmetic in float32 as
    the reference's, the new anchor cast to the anchor's dtype; anchor,
    momentum and pod params are written in place and returned."""
    for a, m, pp in zip(tree_leaves(outer["anchor"]),
                        tree_leaves(outer["momentum"]),
                        tree_leaves(pod_params)):
        n = pp.shape[0]
        a32 = a.float()
        # XLA computes the reference's jnp.mean as the sum times 1/n
        delta = a32 - pp.float().sum(dim=0) * (1.0 / n)
        m_new = cfg.outer_beta * m + delta
        step = cfg.outer_beta * m_new + delta          # Nesterov
        new_anchor = (a32 - cfg.outer_lr * step).to(a.dtype)
        m.copy_(m_new)
        a.copy_(new_anchor)
        pp.copy_(new_anchor.expand_as(pp))
    return outer, pod_params


def pod_slice(tree, p: int):
    """Pod ``p``'s slice of a pod-stacked tree (views)."""
    return map_tree(lambda x: x[p], tree)


def make_diloco_round(cfg: DiLoCoConfig, train_step: Callable,
                      batch_fn: Callable) -> Callable:
    """Returns ``round(pod_states, outer, round_idx) -> (pod_states, outer,
    metrics)``: each pod's inner steps, one outer update.

    ``batch_fn(round_idx)`` returns the round's batches, a tree with
    (n_pods, K, ...) leaves (pods consume disjoint shards).  The loss is
    the mean over pods of each pod's mean over its K steps."""

    def round_fn(pod_states, outer, round_idx):
        batches = batch_fn(round_idx)
        n_pods, K = tree_leaves(batches)[0].shape[:2]
        losses = []
        for p in range(n_pods):
            mine = pod_slice(pod_states, p)
            state, pod_losses = mine, []
            for k in range(K):
                state, metrics = train_step(
                    state, map_tree(lambda x: x[p, k], batches))
                pod_losses.append(metrics["loss"])
            # a leaf the step replaced rather than wrote in place (the
            # optimizer's step count) goes back into the pod's slice
            for dst, src in zip(tree_leaves(mine), tree_leaves(state)):
                if src is not dst:
                    dst.copy_(src)
            losses.append(torch.stack(pod_losses).mean())
        outer, _ = outer_update(cfg, outer, pod_states["params"])
        return pod_states, outer, {"loss": torch.stack(losses).mean()}

    return round_fn
