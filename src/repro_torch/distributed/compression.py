"""Gradient compression: int8 quantization with error feedback (EF-SGD),
the reference's ``distributed.compression`` on torch tensors.

Plugs into ``train.step.make_train_step(grad_transform=...)``: before the
optimizer, each gradient (plus the residual carried from the last step)
is quantized to int8 with per-row absmax scales, and the new residual is
kept for the next step.  On one card there is no all-reduce to shrink:
the numerics are EF-int8's, and ``compression_ratio`` is the wire saving
a data-parallel reduction of the codes would see.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.sharding import map_tree
from repro_torch.optim.adamw import dequantize_rowwise, quantize_rowwise

Params = Any


def init_error_state(params: Params) -> Params:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress(grads, err):
    """(compressed grads, new residuals), as two trees."""
    if isinstance(grads, dict):
        pairs = {k: _compress(grads[k], err[k]) for k in sorted(grads)}
        return ({k: g for k, (g, _) in pairs.items()},
                {k: e for k, (_, e) in pairs.items()})
    g = grads.to(torch.float32) + err
    g_hat = dequantize_rowwise(*quantize_rowwise(g))
    return g_hat, g - g_hat


def ef_int8_transform(grads: Params, state: Dict[str, Any],
                      key: str = "ef_err") -> Tuple[Params, Dict[str, Any]]:
    """grad_transform hook: (compressed grads, state with the new
    residuals under ``key``)."""
    new_g, new_e = _compress(grads, state[key])
    new_state = dict(state)
    new_state[key] = new_e
    return new_g, new_state


def compression_ratio() -> float:
    """Nominal wire compression against float32 gradients (int8 codes;
    the float32 row scales are negligible at realistic row lengths)."""
    return 4.0
