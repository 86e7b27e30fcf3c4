"""Pricing: reserved/spot mixes, day-long contracts, and host energy.

``optimal_mix`` is the paper's inner-problem split (constraints P1h/P1i):
every time the hill climber moves nu_i, the best (R_i, s_i) split is
recomputed (paper §3.2 last paragraph) — with sigma < pi the cost is
minimized by the largest admissible spot share, s <= eta * nu (equivalent
to s <= eta/(1-eta) * R at R = nu - s).

The private-cloud plane adds two more pricing paths:

  * ``optimal_day_mix`` — reserved contracts priced across a whole
    24-hour concurrency profile (the paper's hourly h_i windows): a
    reserved VM is committed for the full day (idle hours still paid),
    spot fills the peaks above it, and the optimal reserved count has a
    closed form (see the function);
  * ``host_energy_cost`` — owned physical hosts are paid in energy, not
    in sigma/pi rental prices; the placement layer reports the powered
    hosts and this prices them.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

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


def optimal_day_mix(nus: Sequence[int], eta: float, vm: VMType
                    ) -> Tuple[int, List[int], float]:
    """Optimal (reserved contract, per-window spot fill) across a day.

    ``nus[t]`` is the VM count window ``t`` needs.  Reserved instances
    are committed for ALL windows (pi per window, idle windows still
    paid); spot fills each window's excess above the contract, bounded by
    P1h (spot_t <= floor(eta * nu_t)).  The day cost

        C(R) = pi * R * W  +  sigma * sum_t max(0, nu_t - R)

    is convex piecewise-linear in R, so the optimum is where the forward
    difference pi*W - sigma*#{t : nu_t > R} turns non-negative — climbed
    from the P1h floor R_min = max_t (nu_t - floor(eta * nu_t)).  With
    sigma < pi that difference is positive everywhere and R* = R_min
    ("reserved covers the max over windows' non-spot share, spot fills
    the peaks"); with sigma >= pi the optimum climbs to the quantile
    point (ultimately R* = max nu_t: all-reserved, spot priced out).
    A single-window day degenerates exactly to ``optimal_mix``.

    Returns ``(reserved, spots_per_window, day_cost)``.
    """
    nus = [int(n) for n in nus]
    w = len(nus)
    if w == 0 or max(nus, default=0) <= 0:
        return 0, [0] * w, 0.0
    r = max(n - int(math.floor(eta * n)) for n in nus)          # P1h floor
    if vm.sigma >= vm.pi:
        while vm.sigma * sum(1 for n in nus if n > r) > vm.pi * w:
            r += 1
    spots = [max(0, n - r) for n in nus]
    cost = vm.pi * r * w + vm.sigma * sum(spots)
    return r, spots, cost


def day_mix_cost(nus: Sequence[int], eta: float, vm: VMType) -> float:
    return optimal_day_mix(nus, eta, vm)[2]


def host_energy_cost(hosts: Iterable) -> float:
    """Hourly energy cost of keeping the given (powered) hosts on — the
    private cloud's counterpart of the sigma/pi rental objective.  Hosts
    are anything with an ``energy_cost_per_h`` attribute
    (``cloud.hosts.Host``)."""
    return float(sum(h.energy_cost_per_h for h in hosts))
