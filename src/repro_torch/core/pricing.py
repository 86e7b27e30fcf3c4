"""Pricing: reserved/spot mixes.

``optimal_mix`` is the paper's inner-problem split (constraints P1h/P1i):
every time the hill climber moves nu_i, the best (R_i, s_i) split is
recomputed (paper §3.2 last paragraph) — with sigma < pi the cost is
minimized by the largest admissible spot share, s <= eta * nu (equivalent
to s <= eta/(1-eta) * R at R = nu - s).
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.core.problem import VMType


def optimal_mix(nu: int, eta: float, vm: VMType) -> Tuple[int, int, float]:
    """Returns (reserved, spot, hourly_cost) for ``nu`` VMs of type ``vm``."""
    if nu <= 0:
        return 0, 0, 0.0
    if vm.sigma < vm.pi:
        spot = int(math.floor(eta * nu))
    else:                         # spot not worth it
        spot = 0
    reserved = nu - spot
    # invariant (P1h): spot <= eta/(1-eta) * reserved  (checked in tests)
    cost = vm.sigma * spot + vm.pi * reserved
    return reserved, spot, cost


def mix_cost(nu: int, eta: float, vm: VMType) -> float:
    return optimal_mix(nu, eta, vm)[2]
