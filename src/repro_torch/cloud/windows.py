"""24-hour windowed planning: the paper's hourly concurrency profiles.

D-SPACE4Cloud's problem statement (§2) gives every application class an
*hourly* concurrency profile h_i(t) — the tool is meant to plan a whole
day, not one operating point.  This module plans all windows together:

  * every window becomes one capacity-planning sub-problem (the same
    classes at that hour's concurrency, the same ``PrivateCloud`` if one
    is deployed), and ALL windows' ``run_steps`` generators advance in
    lockstep — each scheduling round gathers every window's pending
    probe windows and satisfies them with ONE ``evaluate_many`` call on
    a shared batched evaluator, so the whole day behaves like one fused
    tenant set (windows that repeat a concurrency level are pure cache
    hits: same profile hash, same h, same nu probes);
  * reserved contracts are priced across the WHOLE day
    (``pricing.optimal_day_mix``): a reserved VM is committed for all 24
    windows (idle hours still paid), spot fills each window's peak above
    the contract under the P1h bound — so the day cost is the honest
    contractual cost, not the sum of per-hour re-contracted mixes (that
    sum is reported too, as the lower bound it is);
  * on a private cloud every window's fleet is packed, and the whole
    day's packings are re-validated in ONE ``feasibility_batch`` call
    (the padded cross-window batch) on the plan's device.

``benchmarks/torch_scenarios.py`` ``private_cloud_bench`` drives the fusion
economics: a 24-window day of 4 distinct concurrency levels costs about
one fused dispatch a level (5 at its full size, against a single
window's 1), the windows that repeat a level being cache hits.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.cloud.hosts import PrivateCloud
from repro_torch.cloud.placement import feasibility_batch, fleet_of, pack, \
    pad_batch
from repro_torch.core import qn_sim
from repro_torch.core.evaluators import make_batched_qn_evaluator
from repro_torch.core.optimizer import DSpace4Cloud, RunReport
from repro_torch.core.pricing import optimal_day_mix
from repro_torch.core.problem import Problem
from repro_torch.obs import trace as _obs_trace

HOURS = 24


@dataclass
class DayContract:
    """One (class, VM type) reserved contract across the day."""
    cls: str
    vm_type: str
    reserved: int                 # committed for every window
    spots: List[int]              # per-window spot fill above the contract
    nus: List[int]                # per-window total VM counts
    day_cost: float

    def as_dict(self) -> dict:
        return {"cls": self.cls, "vm_type": self.vm_type,
                "reserved": self.reserved, "spots": self.spots,
                "nus": self.nus, "day_cost": self.day_cost}


@dataclass
class DayPlan:
    reports: List[RunReport]      # one per window, in hour order
    contracts: List[DayContract] = field(default_factory=list)
    vm_day_cost: float = 0.0      # reserved contracts + spot fills
    energy_day_cost: float = 0.0  # powered hosts, summed over windows
    naive_hourly_cost: float = 0.0  # sum of per-window mixes (lower bound:
    #                                 hourly re-contracting isn't buyable)
    qn_dispatches: int = 0
    rounds: int = 0               # lockstep scheduling rounds driven
    windows_feasible: List[bool] = field(default_factory=list)

    @property
    def total_day_cost(self) -> float:
        return self.vm_day_cost + self.energy_day_cost

    def summary(self) -> dict:
        return {"windows": len(self.reports),
                "vm_day_cost": self.vm_day_cost,
                "energy_day_cost": self.energy_day_cost,
                "total_day_cost": self.total_day_cost,
                "naive_hourly_cost": self.naive_hourly_cost,
                "qn_dispatches": self.qn_dispatches,
                "rounds": self.rounds,
                "windows_feasible": self.windows_feasible,
                "contracts": [c.as_dict() for c in self.contracts],
                "slo": self.slo_summary()}

    def slo_summary(self) -> dict:
        """Day-level SLO attribution: fold every window report's
        ``RunReport.slo`` into the worst margin per hour, the worst hour
        of the day, and the day's violation total — the per-window view
        the deadline budget is actually spent against."""
        margins: List[float] = []
        violations = 0
        for rep in self.reports:
            s = getattr(rep, "slo", None) or {}
            margins.append(s.get("worst_margin_ms", float("inf")))
            violations += int(s.get("violations", 0))
        finite = [m for m in margins if m == m and m not in
                  (float("inf"), float("-inf"))]
        return {"window_margin_ms": margins,
                "worst_margin_ms": min(finite) if finite else None,
                "worst_window": (margins.index(min(finite))
                                 if finite else None),
                "violations": violations,
                "met": violations == 0}


def _window_problem(problem: Problem, day_h: Dict[str, Sequence[int]],
                    t: int) -> Problem:
    """The hour-``t`` sub-problem: each class at its profile's
    concurrency (classes without a profile entry keep their base
    ``h_users``; an hour at 0 drops the class for that window)."""
    classes = []
    for cls in problem.classes:
        h = int(day_h[cls.name][t]) if cls.name in day_h else cls.h_users
        if h > 0:
            classes.append(replace(cls, h_users=h))
    return Problem(classes=classes, vm_types=problem.vm_types)


def plan_day(problem: Problem, day_h: Dict[str, Sequence[int]], *,
             deployment: Optional[PrivateCloud] = None,
             min_jobs: int = 40, replications: int = 2, seed: int = 0,
             samples=None, window: int = 16, race: bool = True,
             max_rounds: int = 10_000, device=None) -> DayPlan:
    """Plan every window of a day as one fused tenant set.

    ``day_h`` maps class name -> per-window concurrency levels (all
    profiles must agree on the window count; 24 for the paper's hourly
    day).  ``deployment`` (or the problem's own) makes each window a
    capacity-coupled private-cloud plan.  ``device`` is where every
    window's kernels and feasibility checks run: the current CUDA device
    by default (it raises without one), ``"cpu"`` for the plain versions.
    """
    lengths = {len(v) for v in day_h.values()}
    if len(lengths) > 1:
        raise ValueError(f"uneven day profiles: window counts {lengths}")
    n_windows = lengths.pop() if lengths else HOURS
    deployment = deployment if deployment is not None \
        else getattr(problem, "deployment", None)
    dev = resolve_device(device)

    d0 = qn_sim.dispatch_count()
    shared_cache: dict = {}
    sim_kw = dict(min_jobs=min_jobs, replications=replications, seed=seed,
                  samples=samples)
    evaluator = make_batched_qn_evaluator(cache=shared_cache, device=dev,
                                          **sim_kw)

    problems: List[Problem] = []
    reports: List[Optional[RunReport]] = [None] * n_windows
    gens: Dict[int, object] = {}
    pending: Dict[int, list] = {}
    for t in range(n_windows):
        prob_t = _window_problem(problem, day_h, t)
        problems.append(prob_t)
        tool = DSpace4Cloud(prob_t, cache=shared_cache, window=window,
                            race=race, deployment=deployment, device=dev,
                            **sim_kw)
        gen = tool.run_steps()
        try:
            pending[t] = next(gen)
            gens[t] = gen
        except StopIteration as stop:        # empty window: settled already
            reports[t] = stop.value

    # ---- lockstep rounds: every window's probes share one fused call
    plan = DayPlan(reports=[])
    with _obs_trace.span("day_plan", cat="windows", windows=n_windows):
        while pending:
            plan.rounds += 1
            if plan.rounds > max_rounds:
                raise RuntimeError(
                    f"day plan did not settle in {max_rounds} "
                    f"rounds ({len(pending)} windows open)")
            reqs = [(t, r) for t, rs in pending.items() for r in rs]
            flat = [(r.cls, r.vm, int(nu)) for _, r in reqs for nu in r.nus]
            with _obs_trace.span("day_round", cat="windows",
                                 round=plan.rounds, open=len(pending),
                                 points=len(flat)):
                ts = evaluator.evaluate_many(flat)
            results: Dict[int, dict] = {t: {} for t in pending}
            at = 0
            for t, r in reqs:
                results[t][r.rid] = np.asarray(ts[at:at + len(r.nus)])
                at += len(r.nus)
            nxt: Dict[int, list] = {}
            for t in list(pending):
                try:
                    nxt[t] = gens[t].send(results[t])
                except StopIteration as stop:
                    reports[t] = stop.value
            pending = nxt
    plan.reports = reports

    # ---- day pricing: reserved contracts across all windows
    eta_by_class = {c.name: c.eta for c in problem.classes}
    nus_by_lane: Dict[tuple, List[int]] = {}
    for t, rep in enumerate(reports):
        for name, sol in rep.solutions.items():
            key = (name, sol.vm_type)
            lane = nus_by_lane.setdefault(key, [0] * n_windows)
            lane[t] = int(sol.nu)
    for (name, vm_name), nus in sorted(nus_by_lane.items()):
        vm = problem.vm_by_name(vm_name)
        r, spots, cost = optimal_day_mix(nus, eta_by_class[name], vm)
        plan.contracts.append(DayContract(
            cls=name, vm_type=vm_name, reserved=r, spots=spots, nus=nus,
            day_cost=cost))
    plan.vm_day_cost = sum(c.day_cost for c in plan.contracts)
    plan.naive_hourly_cost = sum(r.total_cost_per_h for r in reports)

    # ---- private cloud: energy + one batched all-windows validation
    if deployment is not None:
        plan.energy_day_cost = sum(
            (r.deployment or {}).get("placement", {})
            .get("energy_cost_per_h", 0.0) for r in reports)
        fleets = []
        for prob_t, rep in zip(problems, reports):
            place = pack(prob_t, rep.solutions, deployment, device=dev)
            cores, mem, _ = fleet_of(prob_t, rep.solutions, deployment)
            fleets.append((place.assignment, cores, mem))
        a, vc, vm_ = pad_batch(fleets)
        host_cores = np.asarray([h.cores for h in deployment.hosts],
                                np.float32)
        host_mem = np.asarray([h.memory_gb for h in deployment.hosts],
                              np.float32)
        plan.windows_feasible = [bool(x) for x in feasibility_batch(
            a, vc, vm_, host_cores, host_mem, device=dev)]
    else:
        plan.windows_feasible = [True] * n_windows

    plan.qn_dispatches = qn_sim.dispatch_count() - d0
    return plan
