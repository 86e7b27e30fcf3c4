"""Plain PyTorch version of the ``amva`` kernel: the batched PS fixed
point of ``core.mva`` (its float32 tensor form), on any device."""
from __future__ import annotations

from repro_torch.core.mva import PS_ITERS, ps_response_batch


def ps_fixed_point(a_over_c, b, think, h_users, iters: int = PS_ITERS):
    return ps_response_batch(a_over_c, b, think, h_users, iters=iters)
