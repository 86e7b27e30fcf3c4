"""Analytic performance models — the *fast* tier of D-SPACE4Cloud.

Three layers, as in the reference:

1. ``aria_demand``: ARIA-style job demand bounds (Verma et al., the
   paper's profile-based estimate), ``T_est(c) = A/c + B`` with
       A = ((n_M-0.5) M_avg + (n_R-0.5) R_avg),  B = (M_max+R_max+S1_max)/2.

2. ``ps_response``: the closed interactive processor-sharing model
       T = (A / c) * max(1, m) + B,     m = H * T / (T + Z)
   solved by fixed point; ``min_slots_for_deadline`` bisects it for the
   KKT point "deadline binds" that the initial solution uses.

3. ``mva_response``: textbook exact MVA for a single-server closed network.

The scalar functions run on Python floats (float64) and equal the
reference's exactly.  ``ps_response_batch`` and ``mva_response_batch``
are their float32 tensor versions over many candidates: the plain
versions behind ``kernels/amva``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.problem import JobProfile
from repro_torch.core.workload import DAG, workload_kind
from repro_torch.kernels.fma import fma32

PS_ITERS = 40


def aria_demand(p: JobProfile, slots: int = 1) -> Tuple[float, float]:
    """Returns (A, B) such that T_est(c) = A/c + B."""
    a = (p.n_map - 1.0) * p.m_avg + (p.n_reduce - 1.0) * p.r_avg
    a = 0.5 * (a + p.n_map * p.m_avg + p.n_reduce * p.r_avg)
    b = 0.5 * (p.m_max + p.r_max + p.s1_max)
    return a, b


def workload_demand(w) -> Tuple[float, float]:
    """Generic (A, B) demand of any workload kind: ``aria_demand`` for
    MapReduce profiles, the per-stage sums for DAG chains."""
    if workload_kind(w) == DAG:
        a = sum((s.n_tasks - 0.5) * s.t_avg for s in w.stages)
        b = 0.5 * sum(s.max_or_est for s in w.stages)
        return a, b
    return aria_demand(w)


def ps_response(a_over_c: float, b: float, think: float,
                h_users: int, iters: int = PS_ITERS) -> float:
    """Interactive processor-sharing fixed point (see module docstring)."""
    t = a_over_c + b
    for _ in range(iters):
        m = h_users * t / (t + think)
        t = a_over_c * max(1.0, m) + b
    return t


def mva_response(demand: float, think: float, h_users: int) -> float:
    """Exact MVA, single queueing station + delay; returns R(H)."""
    q = 0.0
    r = demand
    for h in range(1, h_users + 1):
        r = demand * (1.0 + q)
        x = h / (r + think)
        q = x * r
    return r


def job_response(p, slots: int, think: float, h_users: int) -> float:
    """Analytic response time of class jobs on ``slots`` containers."""
    a, b = workload_demand(p)
    return ps_response(a / slots, b, think, h_users)


def ps_response_batch(a_over_c: torch.Tensor, b: torch.Tensor,
                      think: torch.Tensor, h_users: torch.Tensor,
                      iters: int = PS_ITERS) -> torch.Tensor:
    """float32 PS fixed point over candidates (all ``(N,)``), with the
    reference's rounding: IEEE division, and ``a*max(1, m) + b`` as one
    FMA (XLA contracts it)."""
    t = a_over_c + b
    for _ in range(iters):
        m = h_users * t / (t + think)
        t = fma32(a_over_c, torch.clamp(m, min=1.0), b)
    return t


def mva_response_batch(demand: torch.Tensor, think: torch.Tensor,
                       h_users: int) -> torch.Tensor:
    """float32 exact single-station MVA over candidates (``(N,)`` each),
    with the reference's rounding: ``1 + q``, ``d * (.)``, ``r + z``, an
    IEEE division of the float32 ``h`` by it, ``x * r``, each rounded once
    (the reference contracts none of them).  ``h_users = 0`` returns
    ``demand``, as the reference's kernel does."""
    q = torch.zeros_like(demand)
    r = demand.clone()
    for h in range(1, int(h_users) + 1):
        r = demand * (1.0 + q)
        # a tensor numerator: ``float / tensor`` would multiply by the
        # reciprocal, two roundings
        x = torch.full_like(r, float(h)) / (r + think)
        q = x * r
    return r


def min_slots_for_deadline(p, think: float, h_users: int,
                           deadline: float, max_slots: int = 1 << 16) -> int:
    """Smallest slot count meeting the deadline under the PS model
    (= the KKT point: deadline binds at the optimum)."""
    lo, hi = 1, max_slots
    if job_response(p, hi, think, h_users) > deadline:
        return -1
    while lo < hi:
        mid = (lo + hi) // 2
        if job_response(p, mid, think, h_users) <= deadline:
            hi = mid
        else:
            lo = mid + 1
    return lo
