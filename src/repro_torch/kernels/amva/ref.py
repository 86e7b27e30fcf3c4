"""Plain PyTorch versions of the ``amva`` kernels: the batched PS fixed
point and exact MVA of ``core.mva`` (their float32 tensor forms), on any
device."""
from __future__ import annotations

from repro_torch.core.mva import PS_ITERS, mva_response_batch, \
    ps_response_batch


def ps_fixed_point(a_over_c, b, think, h_users, iters: int = PS_ITERS):
    return ps_response_batch(a_over_c, b, think, h_users, iters=iters)


def mva_response(demand, think, h_users: int):
    return mva_response_batch(demand, think, h_users)
