"""Mamba2 block (SSD, state-space duality) on torch tensors.

The reference's parameter tree and layouts: the projections are split per
component (z / x / B / C / dt), one SSD group shared by the heads.  Full
mode (prefill) runs the chunked scan through ``kernels.ssd_scan.ops``: the
hand-written kernel for a CUDA tensor, its plain version for a CPU tensor
(the reference's ``ssd_impl="pallas"``, with its chunk clamp and its
``S % chunk`` check).  Decode is the one-token
recurrence in plain torch, as in the reference (no kernel there); it
updates the cache tensors in place, as the attention cache does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import rms_norm

Params = Dict[str, Any]


def mamba_specs(cfg: ModelConfig, prefix: Tuple[int, ...] = ()) -> Params:
    ssm = cfg.ssm
    D = cfg.d_model
    din = ssm.d_inner(D)
    nh = ssm.n_heads(D)
    N, K = ssm.d_state, ssm.d_conv
    pd = cfg.param_dtype
    lead, ax = prefix, ("layers",) * len(prefix)
    return {
        "ln": ParamSpec(lead + (D,), "float32", ax + ("embed",), init="zeros"),
        "wz": ParamSpec(lead + (D, din), pd, ax + ("embed", "mamba_inner")),
        "wx": ParamSpec(lead + (D, din), pd, ax + ("embed", "mamba_inner")),
        "wB": ParamSpec(lead + (D, N), pd, ax + ("embed", "mamba_state")),
        "wC": ParamSpec(lead + (D, N), pd, ax + ("embed", "mamba_state")),
        "wdt": ParamSpec(lead + (D, nh), pd, ax + ("embed", "mamba_heads")),
        "conv_x": ParamSpec(lead + (K, din), pd,
                            ax + ("conv_width", "mamba_inner"), scale=0.5),
        "conv_B": ParamSpec(lead + (K, N), pd,
                            ax + ("conv_width", "mamba_state"), scale=0.5),
        "conv_C": ParamSpec(lead + (K, N), pd,
                            ax + ("conv_width", "mamba_state"), scale=0.5),
        "A_log": ParamSpec(lead + (nh,), "float32", ax + ("mamba_heads",),
                           init="zeros"),
        "D": ParamSpec(lead + (nh,), "float32", ax + ("mamba_heads",),
                       init="ones"),
        "dt_bias": ParamSpec(lead + (nh,), "float32", ax + ("mamba_heads",),
                             init="zeros"),
        "gate_ln": ParamSpec(lead + (din,), "float32", ax + ("mamba_inner",),
                             init="zeros"),
        "out": ParamSpec(lead + (din, D), pd, ax + ("mamba_inner", "embed")),
    }


# --------------------------------------------------------------------------
# Depthwise causal conv (width K, no dilation)
# --------------------------------------------------------------------------

def causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: (B,S,Ch), w: (K,Ch) -> (B,S,Ch); causal, zero left-pad."""
    K, S = w.shape[0], u.shape[1]
    out = u * w[K - 1]
    for k in range(K - 1):
        shift = K - 1 - k
        shifted = F.pad(u, (0, 0, shift, 0))[:, :S]
        out = out + shifted * w[k]
    return out


def causal_conv_step(u_new: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  u_new: (B,Ch); conv_state: (B,K-1,Ch).  Returns
    (out (B,Ch), the next conv state (B,K-1,Ch))."""
    hist = torch.cat([conv_state, u_new[:, None]], dim=1)      # (B,K,Ch)
    out = torch.einsum("bkc,kc->bc", hist, w)
    return out, hist[:, 1:]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), with no linear cut-off above a threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_: torch.Tensor, C_: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence.  x: (B,H,P); dt: (B,H); B_, C_: (B,N);
    state: (B,H,P,N) -> (y (B,H,P) in x's dtype, the new state)."""
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32))                       # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt.to(f32), x.to(f32),
                       B_.to(f32))
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_.to(f32))
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------
# Block apply
# --------------------------------------------------------------------------

def make_mamba_cache(cfg: ModelConfig, batch: int) -> Params:
    """Zero decode cache on torch's default device: the f32 SSD state and
    the bf16 conv histories (bf16 whatever the model's dtype, as in the
    reference)."""
    ssm = cfg.ssm
    din = ssm.d_inner(cfg.d_model)
    nh = ssm.n_heads(cfg.d_model)
    K = ssm.d_conv - 1
    bf16 = torch.bfloat16
    return {
        "state": torch.zeros((batch, nh, ssm.head_dim, ssm.d_state),
                             dtype=torch.float32),
        "conv_x": torch.zeros((batch, K, din), dtype=bf16),
        "conv_B": torch.zeros((batch, K, ssm.d_state), dtype=bf16),
        "conv_C": torch.zeros((batch, K, ssm.d_state), dtype=bf16),
    }


def _tail_conv_inputs(h: torch.Tensor, p: Params, wname: str,
                      ssm: SSMConfig) -> torch.Tensor:
    """Last (K-1) pre-conv inputs of the sequence: the decode conv state."""
    u = h[:, -(ssm.d_conv - 1):] @ p[wname].to(h.dtype)
    return u.to(torch.bfloat16)


def _gate_out(cfg: ModelConfig, p: Params, y, z, h_dtype):
    """The gated norm and the output projection."""
    y = rms_norm(y * F.silu(z), p["gate_ln"], cfg.norm_eps)
    return y @ p["out"].to(h_dtype)


def mamba_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                cache: Optional[Params] = None, return_state: bool = False):
    """Mamba2 block with pre-norm and residual.

    Full mode (prefill): ``cache`` is None; ``return_state`` also returns
    the decode cache (final SSD state, the last K-1 conv inputs).  Decode
    mode: one token, ``cache`` updated in place and returned.
    """
    ssm = cfg.ssm
    nh = ssm.n_heads(cfg.d_model)
    Pd = ssm.head_dim
    A = -torch.exp(p["A_log"].float())
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    w = lambda name: p[name].to(h.dtype)

    if cache is None:
        B, S, _ = x.shape
        z, xv, Bv, Cv, dt = (h @ w(n) for n in ("wz", "wx", "wB", "wC",
                                                "wdt"))
        xv = F.silu(causal_conv(xv, w("conv_x")))
        Bv = F.silu(causal_conv(Bv, w("conv_B")))
        Cv = F.silu(causal_conv(Cv, w("conv_C")))
        dt = softplus(dt.float() + p["dt_bias"])
        xh = xv.reshape(B, S, nh, Pd)
        y, fstate = ssd_ops.ssd(xh, dt, A, Bv, Cv, chunk=ssm.chunk)
        y = y + xh * p["D"][:, None].to(y.dtype)
        out = x + _gate_out(cfg, p, y.reshape(B, S, nh * Pd), z, h.dtype)
        if not return_state:
            return out, None
        return out, {"state": fstate,
                     "conv_x": _tail_conv_inputs(h, p, "wx", ssm),
                     "conv_B": _tail_conv_inputs(h, p, "wB", ssm),
                     "conv_C": _tail_conv_inputs(h, p, "wC", ssm)}

    # ---- decode ------------------------------------------------------------
    B = x.shape[0]
    h1 = h[:, 0]                                                  # (B,D)
    z, xv, Bv, Cv, dt = (h1 @ w(n) for n in ("wz", "wx", "wB", "wC", "wdt"))
    conv = {}
    for name, u in (("conv_x", xv), ("conv_B", Bv), ("conv_C", Cv)):
        conv[name] = causal_conv_step(u, cache[name].to(h1.dtype), w(name))
    xv, Bv, Cv = (F.silu(conv[n][0]) for n in ("conv_x", "conv_B", "conv_C"))
    dt = softplus(dt.float() + p["dt_bias"])
    xh = xv.reshape(B, nh, Pd)
    y, new_state = ssd_decode_step(xh, dt, A, Bv, Cv, cache["state"])
    y = y + xh * p["D"][:, None].to(y.dtype)
    out = x + _gate_out(cfg, p, y.reshape(B, nh * Pd), z, h1.dtype)[:, None]
    cache["state"].copy_(new_state)
    for name, (_, hist) in conv.items():
        cache[name].copy_(hist)
    return out, cache
