"""Capacity-coupled joint allocation: dual-price coordination of classes.

The public-cloud optimizer races every application class *independently*
(``hillclimb.race_requests``) — sound when capacity is rented and
unbounded.  On a ``PrivateCloud`` the independently-raced optima can
*over-commit* the physical cluster: the fleet does not bin-pack onto the
hosts (``cloud.placement``).  This module restores feasibility without
abandoning the fused QN plane:

  * detect over-commitment by actually packing the raced fleet;
  * when it does not fit, put a **shared dual price** λ on physical
    cores: each class re-chooses its VM-type lane under the priced cost
    ``mix_cost(nu) + λ · nu · cores`` — λ steers classes toward
    core-efficient deployments exactly like a dual variable on the
    coupling constraint of the underlying MINLP (classes only interact
    through the capacity term, so pricing decomposes the joint problem
    back into per-class races);
  * λ escalates geometrically until the re-chosen fleet packs or the
    escalation budget is exhausted — in which case the plan degrades
    gracefully: allocations are truncated to fit (classes marked
    infeasible, the paper's "negative answer is an answer") and the
    result is never worse than the naive baseline (independently
    optimized classes truncated to fit), which is also computed and
    returned for comparison;
  * every lane the coordinator needs verified is swept through the SAME
    propose/receive protocol as the base race (``sweep_requests``), all
    classes' probe windows advanced in lockstep — so whoever drives the
    generator (``DSpace4Cloud.run``'s ``evaluate_many``, or the service's
    ``FusionScheduler``) satisfies each coordination round with one
    fused QN dispatch per fusion group, and re-probes of already-raced
    lanes are pure cache hits.

``coordinate_requests`` is the resumable generator; ``coordinate`` the
single-job driver.  With unbounded capacity the base fleet packs, the
generator returns before its first yield, and the public-cloud solution
passes through untouched (bit-exact, regression-tested).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cloud.hosts import PrivateCloud
from repro_torch.cloud.placement import Placement, demand_cores, pack
from repro_torch.core.hillclimb import HCTrace, request_id, sweep_requests
from repro_torch.core.mva import job_response
from repro_torch.core.pricing import mix_cost, optimal_mix
from repro_torch.core.problem import (
    ApplicationClass,
    ClassSolution,
    Problem,
    VMType,
    solution_cost,
)
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace


# Process-wide dual-price coordination counters (each JointPlan also
# carries its own per-run price_rounds/probe_rounds tallies).
_REG = _obs_metrics.registry()
_PRICE_ROUNDS = _REG.counter("joint.price_rounds")
_PROBE_ROUNDS = _REG.counter("joint.probe_rounds")
_FALLBACKS = _REG.counter("joint.fallbacks")


def violations(sols: Dict[str, ClassSolution]) -> int:
    return sum(1 for s in sols.values() if not s.feasible)


def plan_objective(sols: Dict[str, ClassSolution], penalty: float) -> float:
    """Deployment objective: σ/π cost plus a per-violation penalty large
    enough that feasibility strictly dominates cost (the coordinator
    selects plans lexicographically by (violations, cost); the scalar
    objective is reported for benchmarks/dashboards)."""
    return solution_cost(sols) + penalty * violations(sols)


@dataclass
class JointPlan:
    """The private-cloud planning outcome: a packing-feasible allocation
    plus the coordination telemetry benchmarks assert on."""
    solutions: Dict[str, ClassSolution]
    placement: Placement
    dual_price: float = 0.0
    price_rounds: int = 0          # λ escalation rounds run
    probe_rounds: int = 0          # fused probe rounds yielded (each is one
    #                                batched QN dispatch per fusion group)
    lanes_verified: int = 0        # sweeps the coordination itself ran
    coordinated: bool = False      # False: base fleet packed directly
    used_fallback: bool = False    # price escalation exhausted: truncated
    baseline: Dict[str, ClassSolution] = field(default_factory=dict)
    baseline_placement: Optional[Placement] = None
    penalty_per_violation: float = 0.0

    @property
    def cost_per_h(self) -> float:
        return solution_cost(self.solutions)

    @property
    def violations(self) -> int:
        return violations(self.solutions)

    @property
    def objective(self) -> float:
        return plan_objective(self.solutions, self.penalty_per_violation)

    @property
    def baseline_objective(self) -> float:
        return plan_objective(self.baseline, self.penalty_per_violation)

    def summary(self) -> dict:
        return {
            "cost_per_h": self.cost_per_h,
            "violations": self.violations,
            "objective": self.objective,
            "baseline_cost_per_h": solution_cost(self.baseline),
            "baseline_violations": violations(self.baseline),
            "baseline_objective": self.baseline_objective,
            "dual_price": self.dual_price,
            "price_rounds": self.price_rounds,
            "probe_rounds": self.probe_rounds,
            "lanes_verified": self.lanes_verified,
            "coordinated": self.coordinated,
            "used_fallback": self.used_fallback,
            "placement": self.placement.summary(),
        }


def _analytic_estimate(cls: ApplicationClass, vm: VMType, nu: int) -> float:
    """Analytic response estimate for a *degraded* (truncated) allocation
    — no QN dispatches; the class is marked infeasible regardless, since
    truncation only ever moves a class below its QN-verified minimum."""
    if nu <= 0:
        return float("inf")
    return job_response(cls.profile_for(vm), nu * vm.slots, cls.think_ms,
                       cls.h_users)


def truncate_to_fit(problem: Problem, sols: Dict[str, ClassSolution],
                    cloud: PrivateCloud, *, device=None
                    ) -> Tuple[Dict[str, ClassSolution], Placement]:
    """Degrade an over-committed allocation until it packs: repeatedly
    shave VMs off the class with the largest core footprint (~12% per
    step, at least one VM), re-packing after every cut.  Shaved classes
    are marked infeasible with an analytic response estimate — this is
    both the coordinator's last-resort fallback and the *naive baseline*
    the coordinated plan is measured against.  Every re-pack's
    feasibility check runs on ``device``."""
    classes = {c.name: c for c in problem.classes}
    out = dict(sols)
    place = pack(problem, out, cloud, device=device)
    while not place.feasible:
        name = max((n for n, s in out.items() if s.nu > 0),
                   key=lambda n: out[n].nu
                   * problem.vm_by_name(out[n].vm_type).cores,
                   default=None)
        if name is None:
            break
        sol, cls = out[name], classes[name]
        vm = problem.vm_by_name(sol.vm_type)
        nu = sol.nu - max(1, sol.nu // 8)
        r, s, cost = optimal_mix(nu, cls.eta, vm)
        out[name] = ClassSolution(
            vm_type=vm.name, nu=nu, reserved=r, spot=s, cost_per_h=cost,
            predicted_ms=_analytic_estimate(cls, vm, nu), feasible=False)
        place = pack(problem, out, cloud, device=device)
    return out, place


def _finish(plan: JointPlan, candidates, baseline) -> JointPlan:
    """Select the final allocation lexicographically by (violations,
    cost) among the coordinated candidates AND the naive baseline
    (independently-optimized classes truncated to fit) — so the returned
    plan's objective can never exceed the baseline's (the acceptance
    invariant of the subsystem)."""
    plan.baseline, plan.baseline_placement = baseline
    best_sols, best_place = min(
        candidates + [baseline],
        key=lambda c: (violations(c[0]), solution_cost(c[0])))
    plan.solutions = best_sols
    plan.placement = best_place
    plan.penalty_per_violation = 1.0 + max(
        solution_cost(s) for s, _ in candidates + [baseline])
    return plan


def coordinate_requests(problem: Problem, cloud: PrivateCloud,
                        base_sols: Dict[str, ClassSolution],
                        lanes: Dict[str, Sequence[Tuple[VMType, int]]], *,
                        window: int = 16, max_nu: int = 8192,
                        stall_windows: int = 2, max_price_rounds: int = 10,
                        traces: Optional[Dict[str, HCTrace]] = None,
                        device=None):
    """Resumable propose/receive coordinator (same protocol family as
    ``race_requests``): *yields* lists of ``(cls, vm, nus)`` probe windows
    — the union across ALL classes needing lane verification this round —
    and expects ``send()`` of a ``{request_id(cls, vm): ts}`` mapping.
    Returns the ``JointPlan`` as the ``StopIteration`` value.

    ``base_sols`` is the unconstrained (public-cloud) race outcome;
    ``lanes`` the per-class analytic candidate ranking
    (``milp.rank_vm_types`` style ``(vm, nu0)`` pairs) the dual price can
    steer within.  Coordination traces land in ``traces`` under
    ``joint:<class>@<vm>`` keys (the base race owns the unprefixed ids).
    Every packing's feasibility check runs on ``device`` (the plan's).
    """
    base_place = pack(problem, base_sols, cloud, device=device)
    plan = JointPlan(solutions=base_sols, placement=base_place,
                     baseline=base_sols, baseline_placement=base_place)
    if base_place.feasible:
        plan.penalty_per_violation = 1.0 + solution_cost(base_sols)
        return plan
    plan.coordinated = True

    classes = {c.name: c for c in problem.classes}
    # QN-verified minimal feasible allocation per (class, vm) lane; the
    # base race's winners seed it, everything else is swept on demand
    verified: Dict[Tuple[str, str], ClassSolution] = {
        (name, sol.vm_type): sol for name, sol in base_sols.items()}

    lam = 0.0
    # λ's unit is cost-per-core-hour: seed the escalation at the fleet's
    # own average so the first priced round already re-orders lanes
    lam0 = solution_cost(base_sols) / max(
        demand_cores(problem, base_sols), 1)
    sols = dict(base_sols)
    while True:
        plan.price_rounds += 1
        _PRICE_ROUNDS.inc()
        # -------- choose each class's lane under λ, verifying on demand
        while True:
            choice: Dict[str, ClassSolution] = {}
            to_verify: Dict[str, Tuple[VMType, int]] = {}
            for name, cls in classes.items():
                best = None   # (priced cost, analytic rank, vm, sol|None, nu0)
                for rank, (vm, nu0) in enumerate(lanes.get(name, ())):
                    nu0 = max(1, int(nu0))
                    v = verified.get((name, vm.name))
                    if v is not None:
                        if not v.feasible:
                            continue          # lane cannot meet the deadline
                        priced = v.cost_per_h + lam * v.nu * vm.cores
                        cand = (priced, rank, vm, v, nu0)
                    else:                     # optimistic analytic estimate
                        priced = mix_cost(nu0, cls.eta, vm) \
                            + lam * nu0 * vm.cores
                        cand = (priced, rank, vm, None, nu0)
                    if best is None or (cand[0], cand[1]) < (best[0],
                                                             best[1]):
                        best = cand
                if best is None:              # nothing feasible anywhere:
                    choice[name] = base_sols[name]   # keep the base verdict
                    continue
                _, _, vm, v, nu0 = best
                if v is None:
                    to_verify[name] = (vm, nu0)
                else:
                    choice[name] = v
            if not to_verify:
                break
            # ---- lockstep fused verification of all chosen lanes: each
            # round below is ONE evaluate_many / FusionScheduler flush
            gens: Dict[str, tuple] = {}
            props: Dict[str, list] = {}
            for name, (vm, nu0) in to_verify.items():
                tr = HCTrace(cls=name, vm=vm.name)
                if traces is not None:
                    traces[f"joint:{request_id(name, vm.name)}"] = tr
                g = sweep_requests(classes[name], vm, nu0, window=window,
                                   max_nu=max_nu,
                                   stall_windows=stall_windows, trace=tr)
                gens[name] = (g, vm)
                props[name] = next(g)
            while props:
                plan.probe_rounds += 1
                _PROBE_ROUNDS.inc()
                results = yield [(classes[name], gens[name][1], list(nus))
                                 for name, nus in props.items()]
                nxt: Dict[str, list] = {}
                for name, nus in props.items():
                    g, vm = gens[name]
                    ts = np.asarray(results[request_id(name, vm.name)])
                    try:
                        nxt[name] = g.send(ts)
                    except StopIteration as stop:
                        verified[(name, vm.name)] = stop.value
                        plan.lanes_verified += 1
                props = nxt
            # re-choose: fresh verifications may have moved the argmin
        sols = choice
        place = pack(problem, sols, cloud, device=device)
        if place.feasible:
            plan.dual_price = lam
            return _finish(plan, [(sols, place)],
                           truncate_to_fit(problem, base_sols, cloud,
                                           device=device))
        if plan.price_rounds >= max_price_rounds:
            break
        lam = lam0 if lam == 0.0 else lam * 2.0

    # -------- escalation exhausted: degrade the most core-efficient fleet
    plan.dual_price = lam
    plan.used_fallback = True
    _FALLBACKS.inc()
    baseline = truncate_to_fit(problem, base_sols, cloud, device=device)
    # pricing that could not shift any lane leaves sols == base_sols —
    # the degraded fleet IS the baseline then, don't truncate it twice
    fallback = baseline if sols == base_sols \
        else truncate_to_fit(problem, sols, cloud, device=device)
    return _finish(plan, [fallback], baseline)


def coordinate(problem: Problem, cloud: PrivateCloud,
               base_sols: Dict[str, ClassSolution],
               lanes: Dict[str, Sequence[Tuple[VMType, int]]], evaluator, *,
               window: int = 16, max_nu: int = 8192,
               traces: Optional[Dict[str, HCTrace]] = None,
               device=None) -> JointPlan:
    """Single-job driver of ``coordinate_requests``: every probe round is
    satisfied with ONE fused ``evaluate_many`` call (scalar evaluators
    fall back to per-point probes).  ``device`` is where the packings'
    feasibility checks run (the evaluator owns its own)."""
    gen = coordinate_requests(problem, cloud, base_sols, lanes,
                              window=window, max_nu=max_nu, traces=traces,
                              device=device)
    results = None
    n_round = 0
    with _obs_trace.span("coordinate", cat="coord",
                         classes=len(problem.classes)):
        while True:
            try:
                props = gen.send(results) if results is not None \
                    else next(gen)
            except StopIteration as stop:
                return stop.value
            # Probe-round span wraps only the evaluation; the generator
            # suspends at its yield outside any span.
            with _obs_trace.span("coord_round", cat="coord", round=n_round,
                                 windows=len(props)):
                results = {}
                if hasattr(evaluator, "evaluate_many"):
                    flat = [(cls, vm, int(n)) for cls, vm, nus in props
                            for n in nus]
                    ts = evaluator.evaluate_many(flat)
                    at = 0
                    for cls, vm, nus in props:
                        results[request_id(cls.name, vm.name)] = \
                            np.asarray(ts[at:at + len(nus)], float)
                        at += len(nus)
                else:
                    for cls, vm, nus in props:
                        results[request_id(cls.name, vm.name)] = np.asarray(
                            [evaluator(cls, vm, int(n)) for n in nus], float)
            n_round += 1
