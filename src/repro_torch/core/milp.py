"""Initial solution (paper §3.2, Figure 3, left box).

The paper solves a MINLP whose inner problem is convex (time expression T
convex in nu) via KKT conditions [29].  Here the same structure is made
explicit: with prices fixed per VM type, cost is strictly increasing in nu
and T strictly decreasing, so the KKT/complementary-slackness point is
"deadline binds": nu* = min { nu : T(nu) <= D }.  We find it on the convex
analytic MVA model with bisection (exact for monotone T — this *is* the
stationary point of the relaxed convex program, then ceil-restored to
integrality), independently per class and per VM type, then pick the
cheapest feasible VM type (the outer x_ij choice).

``rank_vm_types`` keeps the *whole* per-class candidate ranking, not just
the argmin: the QN-tier racer (``hillclimb.race_requests``) seeds one
search lane per analytically-feasible VM type, so a misranking by this
approximate model is corrected by the accurate simulator instead of being
frozen in (``initial_solution`` is the ranking's head and preserves the
paper's outer x_ij choice exactly).

Workload-generic: the bisection prices candidates through
``mva.workload_demand``, so classes whose profile is a Tez/Spark DAG chain
get the same KKT initial point as MapReduce classes (T_est(c) = A/c + B is
monotone in c for every kind).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.core.mva import job_response, min_slots_for_deadline
from repro_torch.core.pricing import optimal_mix
from repro_torch.core.problem import ApplicationClass, ClassSolution, Problem, VMType


def initial_class_solution(cls: ApplicationClass, vm: VMType,
                           max_vms: int = 4096) -> Optional[ClassSolution]:
    prof = cls.profile_for(vm)
    slots = min_slots_for_deadline(prof, cls.think_ms, cls.h_users,
                                   cls.deadline_ms,
                                   max_slots=max_vms * vm.slots)
    if slots < 0:
        return None
    nu = max(1, math.ceil(slots / vm.slots))
    r, s, cost = optimal_mix(nu, cls.eta, vm)
    t = job_response(prof, nu * vm.slots, cls.think_ms, cls.h_users)
    return ClassSolution(vm_type=vm.name, nu=nu, reserved=r, spot=s,
                         cost_per_h=cost, predicted_ms=t,
                         feasible=t <= cls.deadline_ms)


def rank_vm_types(problem: Problem,
                  max_vms: int = 4096) -> Dict[str, List[ClassSolution]]:
    """Per class: every analytically-feasible (vm type, nu) candidate,
    sorted by analytic cost ascending (the sort is stable, so catalog order
    breaks ties — ``ranking[name][0]`` is exactly ``initial_solution``'s
    pick).  Each entry's ``cost_per_h`` is the ``optimal_mix`` cost at the
    analytic minimum nu: the cost lower bound the racer prunes lanes with.
    """
    out: Dict[str, List[ClassSolution]] = {}
    for cls in problem.classes:
        cands = [sol for vm in problem.vm_types
                 if (sol := initial_class_solution(cls, vm,
                                                   max_vms=max_vms))
                 is not None]
        if not cands:
            raise ValueError(
                f"class {cls.name}: no feasible configuration below "
                f"{max_vms} VMs of any type")
        cands.sort(key=lambda s: s.cost_per_h)
        out[cls.name] = cands
    return out


def initial_solution(problem: Problem,
                     max_vms: int = 4096) -> Dict[str, ClassSolution]:
    """Per class: cheapest feasible (vm type, nu) under the analytic model
    (the head of ``rank_vm_types``)."""
    return {name: cands[0] for name, cands
            in rank_vm_types(problem, max_vms=max_vms).items()}
