"""AdamW, the reference's ``optim.adamw`` on torch tensors.

Two state modes, as in the reference:
  * ``fp32``: m and v in float32.
  * ``8bit``: m and v stored as int8 codes with per-row (last-dim) absmax
    scales (v through its square root, ``quantize_sqrt``), plus a float32
    master copy of the parameters.

All update math runs in float32, in the reference's order of operations.
The state tree has the reference's layout (``step``, ``mv`` with ``m``/
``v`` or ``m_q``/``m_s``/``v_q``/``v_s`` per parameter, ``master`` in
8-bit mode), so checkpoints and ``core.interop`` carry it across.

Unlike the reference, ``adamw_update`` writes the new parameters, moments
and master copy into the tensors it is given (the reference returns new
arrays): at granite-3-2b's full size the float32 state is 40 GB, and a
second copy would not fit one card beside it.  A stacked leaf (its first
axis the layer groups) is updated one group at a time, so the float32
temporaries stay a slice's size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from repro_torch.distributed.sharding import ParamSpec, map_tree

Params = Any
F32 = torch.float32


# --------------------------------------------------------------------------
# Shape-preserving int8 quantization (per last-dim row absmax)
# --------------------------------------------------------------------------

def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 tensor -> (int8 codes of the same shape, scales of
    shape[:-1])."""
    if x.dim() == 0:
        scale = torch.clamp_min(x.abs(), 1e-12) / 127.0
        return (torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8),
                scale)
    scale = torch.clamp_min(x.abs().amax(dim=-1) / 127.0, 1e-12)
    codes = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_rowwise(codes: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    if codes.dim() == 0:
        return codes.to(F32) * scale
    return codes.to(F32) * scale[..., None]


def quantize_sqrt(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantizer for non-negative, high-dynamic-range values (Adam's
    second moment): the codes store sqrt(x), so a row spans 127^2 : 1."""
    r = torch.sqrt(torch.clamp_min(x, 0.0))
    if x.dim() == 0:
        scale = torch.clamp_min(r, 1e-12) / 127.0
        return (torch.clamp(torch.round(r / scale), 0, 127).to(torch.int8),
                scale)
    scale = torch.clamp_min(r.amax(dim=-1), 1e-12) / 127.0
    codes = torch.clamp(torch.round(r / scale[..., None]), 0, 127)
    return codes.to(torch.int8), scale


def dequantize_sqrt(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.square(dequantize_rowwise(codes, scale))


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Any], torch.Tensor]:
    """``lr(step)``: linear warm-up then cosine decay to ``min_frac``, in
    float32 (a 0-dim tensor)."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    mode: str = "fp32"            # fp32 | 8bit
    warmup: int = 100
    total_steps: int = 10000


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, keys in sorted order (the
    order the reference flattens a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_opt_state(cfg: AdamWConfig, params: Params) -> Dict[str, Any]:
    """Zero moments on each parameter's device (and, in 8-bit mode, a
    float32 master copy)."""
    def zeros_mv(p):
        if cfg.mode == "8bit":
            return {"m_q": torch.zeros(p.shape, dtype=torch.int8,
                                       device=p.device),
                    "m_s": torch.zeros(p.shape[:-1], dtype=F32,
                                       device=p.device),
                    "v_q": torch.zeros(p.shape, dtype=torch.int8,
                                       device=p.device),
                    "v_s": torch.zeros(p.shape[:-1], dtype=F32,
                                       device=p.device)}
        return {"m": torch.zeros(p.shape, dtype=F32, device=p.device),
                "v": torch.zeros(p.shape, dtype=F32, device=p.device)}

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "mv": map_tree(zeros_mv, params)}
    if cfg.mode == "8bit":
        state["master"] = map_tree(
            lambda p: p.detach().to(F32, copy=True), params)
    return state


def _parts(t: torch.Tensor, stacked: bool) -> Iterable[torch.Tensor]:
    """Views of a leaf to update one at a time: a stacked leaf's groups,
    else the leaf.  A parameter of 3 axes or more is split along its first
    (its codes and scales with it): every quantization row stays whole."""
    return t.unbind(0) if stacked else (t,)


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in float32 (a 0-dim tensor on
    the leaves' device)."""
    total = 0.0
    for leaf in tree_leaves(tree):
        for part in _parts(leaf, leaf.dim() >= 3):
            total = total + torch.sum(torch.square(part.to(F32)))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def _update(cfg: AdamWConfig, lr: float, bc1: float, bc2: float,
            clip: torch.Tensor, p, g, mv, master) -> None:
    """One part of one leaf, written in place: p (and master), the
    moments."""
    g = g.to(F32) * clip
    if cfg.mode == "8bit":
        m = dequantize_rowwise(mv["m_q"], mv["m_s"])
        v = dequantize_sqrt(mv["v_q"], mv["v_s"])
    else:
        m, v = mv["m"], mv["v"]
    m_new = cfg.b1 * m + (1 - cfg.b1) * g
    v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mhat, vhat = m_new / bc1, v_new / bc2
    base = master.to(F32)
    new_master = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                              + cfg.weight_decay * base)
    if cfg.mode == "8bit":
        for key, (codes, scale) in (("m", quantize_rowwise(m_new)),
                                    ("v", quantize_sqrt(v_new))):
            mv[f"{key}_q"].copy_(codes)
            mv[f"{key}_s"].copy_(scale)
        master.copy_(new_master)
    else:
        m.copy_(m_new)
        v.copy_(v_new)
    p.copy_(new_master.to(p.dtype))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: Dict[str, Any]
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}).  The
    parameters, moments and master copy are updated in place (module
    docstring) and returned; ``state["step"]`` is a new tensor."""
    step = state["step"] + 1
    n = int(step)
    lr = float(cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)(n))
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    stepf = torch.tensor(n, dtype=F32)
    bc1 = float(1 - cfg.b1 ** stepf)
    bc2 = float(1 - cfg.b2 ** stepf)
    masters = state.get("master", params)
    flat = zip(_with_moments(params, state["mv"]), tree_leaves(grads),
               tree_leaves(masters))
    for (p, mv), g, master in flat:
        stacked = p.dim() >= 3
        mvs = {k: list(_parts(t, stacked)) for k, t in mv.items()}
        for i, (pp, gg, ma) in enumerate(zip(_parts(p, stacked),
                                             _parts(g, stacked),
                                             _parts(master, stacked))):
            _update(cfg, lr, bc1, bc2, clip, pp, gg,
                    {k: t[i] for k, t in mvs.items()}, ma)
    new_state = dict(state)
    new_state["step"] = step
    return params, new_state, {"grad_norm": gnorm,
                               "lr": torch.tensor(lr, dtype=F32)}


def _with_moments(params, mv):
    """(parameter, its moments dict) pairs, in leaf order."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _with_moments(params[k], mv[k])
    else:
        yield params, mv


def opt_state_specs(cfg: AdamWConfig, param_specs_tree):
    """ParamSpec tree for the optimizer state: int8 codes keep the
    parameter axes; scales drop the last axis."""
    def mv_spec(s: ParamSpec):
        if cfg.mode == "8bit":
            return {
                "m_q": ParamSpec(s.shape, "int8", s.axes, init="zeros"),
                "m_s": ParamSpec(s.shape[:-1], "float32", s.axes[:-1],
                                 init="zeros"),
                "v_q": ParamSpec(s.shape, "int8", s.axes, init="zeros"),
                "v_s": ParamSpec(s.shape[:-1], "float32", s.axes[:-1],
                                 init="zeros"),
            }
        return {"m": ParamSpec(s.shape, "float32", s.axes, init="zeros"),
                "v": ParamSpec(s.shape, "float32", s.axes, init="zeros")}

    out = {"step": ParamSpec((), "int32", (), init="zeros"),
           "mv": map_tree(mv_spec, param_specs_tree)}
    if cfg.mode == "8bit":
        out["master"] = map_tree(
            lambda s: ParamSpec(s.shape, "float32", s.axes),
            param_specs_tree)
    return out
