"""Plain PyTorch versions of the ``amva`` kernels: the batched PS fixed
point (from four tensors, or from a frontier's scalars) and exact MVA of
``core.mva`` (their float32 tensor forms), on any device."""
from __future__ import annotations

import torch

from repro_torch.core.mva import PS_ITERS, mva_response_batch, \
    ps_response_batch


def ps_fixed_point(a_over_c, b, think, h_users, iters: int = PS_ITERS):
    return ps_response_batch(a_over_c, b, think, h_users, iters=iters)


def frontier_a_over_c(a: float, slots: int, nu_lo: int, n: int,
                      device=None):
    """``a / (nu * slots)`` for nu = nu_lo .. nu_lo + n - 1, divided in
    float64 and rounded to float32, as the reference's ``amva_frontier``
    computes it with numpy on the host."""
    nu = torch.arange(nu_lo, nu_lo + n, dtype=torch.float64, device=device)
    return (float(a) / (nu * float(slots))).to(torch.float32)


def ps_frontier(a: float, slots: int, nu_lo: int, n: int, b: float,
                think: float, h_users: float, iters: int = PS_ITERS,
                device=None):
    """The fixed point at the frontier's ``frontier_a_over_c`` with ``b``,
    ``think`` and ``h_users`` broadcast as float32."""
    a_over_c = frontier_a_over_c(a, slots, nu_lo, n, device)
    full = lambda v: torch.full((n,), v, dtype=torch.float32,  # noqa: E731
                                device=device)
    return ps_fixed_point(a_over_c, full(b), full(think), full(h_users),
                          iters=iters)


def mva_response(demand, think, h_users: int):
    return mva_response_batch(demand, think, h_users)
