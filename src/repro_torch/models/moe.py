"""Mixture-of-Experts block on torch tensors: top-k routing with a per-row
expert capacity (Switch / Mesh-TF semantics), the reference's
``models/moe.py``.

The reference dispatches and combines with one-hot (B, S, E, C) einsums.
The port keeps the routing decisions (which expert, which slot, which
tokens are dropped, the combine weights) and computes them with index
ops instead:

  * dispatch is an index gather of the tokens into an (E, B'*C, D)
    buffer (B' = B times the sequence chunks, C the capacity); a slot no
    token took reads a zero row, as the reference's einsum gives it;
  * the experts are two ``torch.bmm`` over that buffer;
  * combine gathers each token's kept (expert, slot) rows and sums them
    with their weights in float32, rounding once to the activation
    dtype, as the reference's combine einsum does.

An empty slot contributes exactly 0 in the reference (act(0) * 0 @ wo),
so computing every slot gives its result.  Left-padded tokens are
routed and take capacity, as in the reference.  The expert layout axes
the reference uses for its device mesh have no effect on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.models.layers import activation_fn, rms_norm

Params = Dict[str, Any]

# production model-axis size the reference picks its expert layout by
_MODEL_AXIS = 16


def _expert_axes(n_experts: int) -> Tuple:
    if n_experts % _MODEL_AXIS == 0:
        return ("experts", "embed", "expert_mlp")      # expert-parallel
    return (None, "mlp", "expert_data")                # TP within expert


def moe_specs(cfg: ModelConfig, prefix: Tuple[int, ...] = ()) -> Params:
    assert cfg.moe is not None
    m = cfg.moe
    D, pd = cfg.d_model, cfg.param_dtype
    lead, ax = prefix, ("layers",) * len(prefix)
    e_ax = _expert_axes(m.n_experts)
    wi_cols = 2 * m.d_ff_expert if cfg.gated_mlp else m.d_ff_expert
    specs = {
        "ln": ParamSpec(lead + (D,), "float32", ax + ("embed",), init="zeros"),
        "router": ParamSpec(lead + (D, m.n_experts), "float32",
                            ax + ("embed", None), scale=0.1),
        "wi_e": ParamSpec(lead + (m.n_experts, D, wi_cols), pd,
                          ax + (e_ax[0], e_ax[1], e_ax[2])),
        "wo_e": ParamSpec(lead + (m.n_experts, m.d_ff_expert, D), pd,
                          ax + (e_ax[0], e_ax[2], e_ax[1])),
    }
    if m.n_shared_experts:
        sh_cols = 2 * m.d_ff_shared if cfg.gated_mlp else m.d_ff_shared
        specs["wi_s"] = ParamSpec(lead + (D, sh_cols), pd, ax + ("embed", "mlp"))
        specs["wo_s"] = ParamSpec(lead + (m.d_ff_shared, D), pd,
                                  ax + ("mlp", "embed"))
    return specs


def _top_k_dispatch(gates: torch.Tensor, top_k: int, capacity: int):
    """Top-k routing with per-row expert capacity.

    gates: (B, S, E) float32 softmax router probabilities.  Returns
    (expert, slot, keep, weight, aux), the first four (B, S, k) with each
    token's choices in expert order: a choice went to ``expert`` at
    ``slot`` if ``keep`` (else it is dropped, past capacity, with weight
    0).  Choices are taken one at a time: the first-index argmax of what
    remains, its slot the running count of that expert's earlier tokens
    in the row plus the kept counts of the earlier choices.  The weights
    are renormalised over the kept choices (by at least 1e-9)."""
    B, S, E = gates.shape
    # load-balance auxiliary loss (Switch): E * mean(gates) . mean(top-1)
    top1 = torch.argmax(gates, dim=-1)
    me = gates.mean(dim=1)                                        # (B,E)
    ce = F.one_hot(top1, E).to(gates.dtype).mean(dim=1)
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))

    experts, slots, keeps, weights = [], [], [], []
    remaining = gates
    base_count = torch.zeros((B, 1, E), dtype=torch.int64,
                             device=gates.device)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                     # (B,S)
        onehot = F.one_hot(idx, E)                                # (B,S,E)
        pos = torch.gather(torch.cumsum(onehot, dim=1) - 1 + base_count,
                           -1, idx[..., None])[..., 0]            # (B,S)
        keep = pos < capacity
        gate_val = torch.gather(remaining, -1, idx[..., None])[..., 0]
        experts.append(idx)
        slots.append(pos.clamp(0, capacity - 1))
        keeps.append(keep)
        weights.append(gate_val * keep)
        base_count = base_count + (onehot * keep[..., None]).sum(
            dim=1, keepdim=True)
        remaining = remaining * (1.0 - onehot.to(gates.dtype))
    # the choices in expert order, the order in which the reference's sums
    # over its (E, C) axes meet them; renormalised over the kept ones
    expert = torch.stack(experts, dim=-1)
    order = torch.sort(expert, dim=-1, stable=True).indices
    expert, slot, keep, weight = (
        torch.gather(torch.stack(t, dim=-1), -1, order)
        for t in (experts, slots, keeps, weights))
    denom = weight[..., 0]
    for j in range(1, top_k):
        denom = denom + weight[..., j]
    weight = weight / torch.clamp(denom, min=1e-9)[..., None]
    return expert, slot, keep, weight, aux


# tokens are routed in sequence chunks of this size when a sequence holds
# at least 4 of them, with per-chunk capacity (the reference's constant)
_SEQ_CHUNK = 2048


def _route(cfg: ModelConfig, p: Params, hc: torch.Tensor):
    """Router logits ``hc.float() @ router`` (float32), their softmax and
    the top-k choices with the per-row capacity: (expert, slot, keep,
    weight, aux, capacity)."""
    m = cfg.moe
    gates = torch.softmax(hc.float() @ p["router"], dim=-1)      # (B',c,E)
    capacity = max(1, int(hc.shape[1] * m.top_k * m.capacity_factor
                          / m.n_experts))
    return (*_top_k_dispatch(gates, m.top_k, capacity), capacity)


def _dispatch(hc: torch.Tensor, n_experts: int, expert, slot, keep,
              capacity: int):
    """Gather the tokens into the (E, B'*C, D) expert buffer: slot (e, b,
    c) takes the token routed there, every other slot the zero row after
    the tokens.  A dropped choice writes the spare entry past the buffer
    (no boolean indexing: nothing waits for the device).  Returns the
    buffer and each choice's flat slot (B', c, k)."""
    Bc, chunk, D = hc.shape
    row = torch.arange(Bc, device=hc.device)[:, None, None]
    flat_slot = (expert * Bc + row) * capacity + slot
    n_slots = n_experts * Bc * capacity
    token = (row * chunk
             + torch.arange(chunk, device=hc.device)[None, :, None]
             ).expand_as(flat_slot)
    src = torch.full((n_slots + 1,), Bc * chunk, dtype=torch.int64,
                     device=hc.device)
    src.scatter_(0, torch.where(keep, flat_slot, n_slots).reshape(-1),
                 token.reshape(-1))
    table = torch.cat([hc.reshape(Bc * chunk, D), hc.new_zeros((1, D))])
    return table[src[:n_slots]].view(n_experts, Bc * capacity, D), flat_slot


def _experts(cfg: ModelConfig, p: Params, xin: torch.Tensor) -> torch.Tensor:
    """Every expert's MLP over its rows of the buffer: two ``bmm``."""
    act = activation_fn(cfg.activation)
    hi = torch.bmm(xin, p["wi_e"].to(xin.dtype))
    if cfg.gated_mlp:
        gate, up = torch.chunk(hi, 2, dim=-1)
        hi = act(gate) * up
    else:
        hi = act(hi)
    return torch.bmm(hi, p["wo_e"].to(xin.dtype))


def _combine(xout: torch.Tensor, flat_slot, weight) -> torch.Tensor:
    """Each token's rows of the experts' output, weighted in the
    activation dtype and summed in float32 in expert order, rounded once
    to the activation dtype: (B', c, D)."""
    D = xout.shape[-1]
    rows = xout.reshape(-1, D)
    w = weight.to(xout.dtype).float()
    out = torch.zeros(flat_slot.shape[:2] + (D,), dtype=torch.float32,
                      device=xout.device)
    for j in range(flat_slot.shape[-1]):
        out = out + w[..., j:j + 1] * rows[flat_slot[..., j]].float()
    return out.to(xout.dtype)


def moe_apply(cfg: ModelConfig, p: Params,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (residual output, aux loss (), float32)."""
    m = cfg.moe
    B, S, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if S >= 4 * _SEQ_CHUNK and S % _SEQ_CHUNK == 0:
        n_chunks = S // _SEQ_CHUNK
    else:
        n_chunks = 1
    hc = h.reshape(B * n_chunks, S // n_chunks, D)
    expert, slot, keep, weight, aux, capacity = _route(cfg, p, hc)
    xin, flat_slot = _dispatch(hc, m.n_experts, expert, slot, keep, capacity)
    out = _combine(_experts(cfg, p, xin), flat_slot, weight).reshape(B, S, D)
    if m.n_shared_experts:
        act = activation_fn(cfg.activation)
        hi_s = h @ p["wi_s"].to(h.dtype)
        if cfg.gated_mlp:
            gate, up = torch.chunk(hi_s, 2, dim=-1)
            hi_s = act(gate) * up
        else:
            hi_s = act(hi_s)
        out = out + hi_s @ p["wo_s"].to(h.dtype)
    return x + out, aux.float()
