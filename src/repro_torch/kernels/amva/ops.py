"""Wrappers of the two ``amva`` kernels: the batched processor-sharing
fixed point and exact single-station MVA.

A CUDA tensor launches the hand-written kernels of ``csrc/amva.cu`` (the
counterparts of the reference's ``amva_fwd``/``_ps_kernel`` and
``mva_fwd``/``_mva_kernel``); a CPU tensor takes the plain versions in
``ref.py``.  ``ps_frontier`` is the fixed point's second entry, a whole
frontier from its scalars (``amva_ps_frontier_kernel``: no input tensors,
so no copies to the card), on the device it is given.
``ps_fixed_point.launches``, ``ps_frontier.launches`` and
``mva_response.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.mva import PS_ITERS
from repro_torch.kernels import build
from repro_torch.kernels.amva import ref
from repro_torch.obs import trace as _obs_trace


def _check(name, args):
    a = args[0]
    for x in args:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes tensors")
        if x.dtype != torch.float32 or x.dim() != 1 \
                or x.shape != a.shape or x.device != a.device:
            raise ValueError(f"{name} takes {len(args)} float32 (N,) "
                             "tensors on one device")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no amva kernel for device {a.device}")


def ps_fixed_point(a_over_c: torch.Tensor, b: torch.Tensor,
                   think: torch.Tensor, h_users: torch.Tensor,
                   iters: int = PS_ITERS) -> torch.Tensor:
    """PS fixed point ``T <- a*max(1, h*T/(T+z)) + b`` from ``T0 = a + b``,
    ``iters`` rounds, per element of four float32 ``(N,)`` tensors."""
    args = (a_over_c, b, think, h_users)
    _check("ps_fixed_point", args)
    dev = a_over_c.device
    if dev.type == "cpu":
        return ref.ps_fixed_point(*args, iters=iters)
    args = tuple(x.contiguous() for x in args)
    out = torch.empty_like(args[0])
    n = out.numel()
    if n == 0:
        return out
    rc = build.launch(dev, build.library().amva_ps_launch,
                      *(x.data_ptr() for x in args), out.data_ptr(), n,
                      int(iters))
    build.check(rc, "amva")
    build.count(ps_fixed_point)
    return out


ps_fixed_point.launches = 0


def ps_frontier(a: float, slots: int, nu_lo: int, n: int, b: float,
                think: float, h_users: float, *, device,
                iters: int = PS_ITERS) -> torch.Tensor:
    """The fixed point of ``ps_fixed_point`` over a frontier, float32
    ``(n,)`` on ``device``: element i is nu = ``nu_lo`` + i, at ``a_over_c
    = a / (nu * slots)`` divided in float64 and rounded to float32 (as the
    reference's ``amva_frontier``), with ``b``, ``think`` and ``h_users``
    as float32.  On the card one launch takes the scalars by value."""
    dev = torch.device(device)
    if isinstance(n, bool) or int(n) != n or n < 0:
        raise ValueError(f"n must be an int >= 0, got {n!r}")
    n = int(n)
    if dev.type == "cpu":
        return ref.ps_frontier(a, slots, nu_lo, n, b, think, h_users,
                               iters=iters, device=dev)
    if dev.type != "cuda":
        raise ValueError(f"no amva kernel for device {dev}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    rc = build.launch(dev, build.library().amva_ps_frontier_launch,
                      float(a), int(slots), int(nu_lo), n, float(b),
                      float(think), float(h_users), out.data_ptr(),
                      int(iters))
    build.check(rc, "amva")
    build.count(ps_frontier)
    return out


ps_frontier.launches = 0


def mva_response(demand: torch.Tensor, think: torch.Tensor,
                 h_users: int) -> torch.Tensor:
    """Exact MVA response ``R(H)`` of a single queueing station with
    service demand ``demand`` and a delay station of mean ``think``, per
    element of two float32 ``(N,)`` tensors, for ``h_users`` users
    (``demand`` itself when it is 0)."""
    args = (demand, think)
    _check("mva_response", args)
    if isinstance(h_users, bool) or int(h_users) != h_users or h_users < 0:
        raise ValueError(f"h_users must be an int >= 0, got {h_users!r}")
    h_users = int(h_users)
    dev = demand.device
    with _obs_trace.span("kernel:amva_exact", cat="kernel", h_users=h_users):
        if dev.type == "cpu":
            return ref.mva_response(demand, think, h_users)
        args = tuple(x.contiguous() for x in args)
        out = torch.empty_like(args[0])
        n = out.numel()
        if n == 0:
            return out
        rc = build.launch(dev, build.library().amva_mva_launch,
                          *(x.data_ptr() for x in args), out.data_ptr(), n,
                          h_users)
        build.check(rc, "amva_mva")
        build.count(mva_response)
        return out


mva_response.launches = 0
