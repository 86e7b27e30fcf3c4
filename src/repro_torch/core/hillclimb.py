"""Parallel Local Search Optimizer — Algorithm 1, in two gaits.

``optimize_class`` is the paper-verbatim point-wise walk: one evaluator
call (one scalar simulation) per probed nu, up while infeasible, down
while feasible, then one step back.  ``hill_climb`` runs it for every
class of a problem, in worker threads when ``parallel``.

``sweep_requests`` proposes a *window* of nu candidates around the
incumbent, receives the whole window's response times from one fused
device call, and jumps straight to the feasible minimum-cost point.
``race_requests`` lifts it to a *raced portfolio*: one sweep lane per
analytically-feasible VM type, advanced in lockstep rounds so every lane's
window can share one fused call, with cost-lower-bound pruning — a lane
whose ``optimal_mix`` cost at the smallest nu it can still end at exceeds
the incumbent's QN-verified cost is retired without further dispatches.
``sweep_class``/``race_class`` run one job each.

The climber only talks to the evaluator through ``(cls, vm, nu)``
probes, so it is the reference's code unchanged.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pricing import mix_cost, optimal_mix
from repro_torch.core.problem import ApplicationClass, ClassSolution, \
    Problem, VMType
from repro_torch.obs import trace as _obs_trace

# evaluator: (cls, vm, nu) -> predicted response time [ms]
Evaluator = Callable[[ApplicationClass, VMType, int], float]


def request_id(cls_name: str, vm_name: str) -> str:
    """Identity of one (class, VM type) search lane — the unit pending work
    is keyed by across ``run_steps``, the racer, and the solver service."""
    return f"{cls_name}@{vm_name}"


@dataclass
class HCTrace:
    cls: str
    moves: List[Tuple[int, float, bool]] = field(default_factory=list)
    evals: int = 0
    wall_s: float = 0.0
    vm: Optional[str] = None          # lane VM type (raced runs)
    lane_bound: Optional[float] = None  # analytic cost lower bound of lane
    pruned: bool = False              # retired by lower-bound pruning


def _solution(cls: ApplicationClass, vm: VMType, nu: int,
              t: float) -> ClassSolution:
    r, s, cost = optimal_mix(nu, cls.eta, vm)
    return ClassSolution(vm_type=vm.name, nu=nu, reserved=r, spot=s,
                         cost_per_h=cost, predicted_ms=t,
                         feasible=t <= cls.deadline_ms)


def optimize_class(cls: ApplicationClass, vm: VMType, nu0: int,
                   evaluate: Evaluator, max_nu: int = 8192,
                   stall_patience: int = 6,
                   trace: Optional[HCTrace] = None) -> ClassSolution:
    """Algorithm 1 body for one class, point-wise.

    ``stall_patience`` guards the pursuit of feasibility: when the
    response time has floored above the deadline (no cluster size can
    help), that many consecutive increments without >0.5% improvement
    abort with an infeasible verdict."""
    t_start = time.time()
    tr = trace if trace is not None else HCTrace(cls=cls.name)
    nu = max(1, nu0)
    t = evaluate(cls, vm, nu)
    tr.evals += 1
    tr.moves.append((nu, t, t <= cls.deadline_ms))

    if t > cls.deadline_ms:                        # pursuit of feasibility
        stall = 0
        while t > cls.deadline_ms and nu < max_nu and stall < stall_patience:
            nu += 1                                # IncrementCluster
            t_new = evaluate(cls, vm, nu)
            stall = stall + 1 if t_new > t * 0.995 else 0
            t = t_new
            tr.evals += 1
            tr.moves.append((nu, t, t <= cls.deadline_ms))
    else:                                          # cost optimization
        while nu > 1:
            t_next = evaluate(cls, vm, nu - 1)     # DecrementCluster probe
            tr.evals += 1
            tr.moves.append((nu - 1, t_next, t_next <= cls.deadline_ms))
            if t_next <= cls.deadline_ms:
                nu -= 1
                t = t_next
            else:
                break                              # IncrementCluster (back)
    tr.wall_s = time.time() - t_start
    return _solution(cls, vm, nu, t)


def sweep_requests(cls: ApplicationClass, vm: VMType, nu0: int, *,
                   window: int = 16, max_nu: int = 8192,
                   stall_windows: int = 2,
                   trace: Optional[HCTrace] = None):
    """Resumable propose/receive core of the frontier sweep.

    A generator that *proposes* each window as a list of nu candidates
    (``yield nus``), *receives* the aligned response-time array via
    ``send(ts)``, and finally returns the ``ClassSolution`` (as the
    ``StopIteration`` value).  It never evaluates anything itself — whoever
    drives it owns dispatch timing, which is what lets the multi-tenant
    service fuse windows from many concurrent jobs into shared device calls
    (the reference's ``service.scheduler``).  ``sweep_class`` runs it for one job.

    Move semantics (identical whoever runs it):

      * some point feasible -> take the smallest feasible nu (cost is
        strictly increasing in nu, so that is the window's minimum-cost
        feasible point); if it sits on the window's lower edge, slide the
        window below it and keep looking;
      * nothing feasible -> slide the window up (pursuit of feasibility),
        aborting after ``stall_windows`` consecutive windows whose best
        response time improves by <0.5% (response floored above deadline —
        no cluster size will help).

    The first window descends from the seed — ``[nu0-window+1, nu0]`` —
    because analytic seeds over-provision by construction (the MVA/AMVA
    response bounds are conservative, so the true minimum sits at or below
    the analytic one): anchoring at the seed's upper edge captures the
    whole overshoot in one round where a centered window would spend half
    its points above a nu that is already known feasible.  An undershooting
    seed (possible under simulation noise) still converges through the
    ordinary slide-up path, one round later.
    """
    t_start = time.time()
    tr = trace if trace is not None else HCTrace(cls=cls.name)
    window = max(2, window)

    nu0 = min(max(1, nu0), max_nu)     # an out-of-catalog incumbent would
    hi = min(max_nu, nu0)              # otherwise make the window empty
    lo = max(1, hi - window + 1)
    best: Optional[Tuple[int, float]] = None   # feasible incumbent
    prev_floor = float("inf")
    stall = 0
    while True:
        nus = list(range(lo, hi + 1))
        ts = yield nus
        tr.evals += len(nus)
        for n, t in zip(nus, ts):
            tr.moves.append((n, float(t), bool(t <= cls.deadline_ms)))
        feas = [i for i, t in enumerate(ts) if t <= cls.deadline_ms]

        if feas:
            nu_star, t_star = nus[feas[0]], float(ts[feas[0]])
            if best is None or nu_star < best[0]:
                best = (nu_star, t_star)
            if nu_star > lo or lo == 1:        # interior point: converged
                break
            hi = nu_star - 1                   # on the edge: look below
            lo = max(1, hi - window + 1)
            continue

        if best is not None:                   # nothing below the incumbent
            break
        if hi >= max_nu:                       # ran off the catalog
            best = (hi, float(ts[-1]))
            break
        floor = float(min(ts))                 # pursuit of feasibility
        stall = stall + 1 if floor > prev_floor * 0.995 else 0
        prev_floor = min(prev_floor, floor)
        if stall >= stall_windows:
            best = (hi, float(ts[-1]))
            break
        lo = hi + 1
        hi = min(max_nu, lo + window - 1)

    tr.wall_s = time.time() - t_start
    return _solution(cls, vm, best[0], best[1])


def sweep_class(cls: ApplicationClass, vm: VMType, nu0: int,
                evaluator, *, window: int = 16, max_nu: int = 8192,
                stall_windows: int = 2,
                trace: Optional[HCTrace] = None) -> ClassSolution:
    """Frontier-sweep Algorithm 1 for one class (the one-job loop over
    ``sweep_requests``): each proposed window is satisfied immediately with
    one fused device call.

    ``evaluator`` must expose ``evaluate_frontier(cls, vm, nus)`` (see
    ``BatchedQNEvaluator``); cached points cost nothing to re-sweep.
    Reaches the same fixed point as the point-wise walk whenever the
    evaluator is monotone non-increasing in nu; under simulation noise it
    may legitimately land within a point or two of it (it takes the global
    window minimum where the scalar walk stops at the first infeasible
    probe).
    """
    gen = sweep_requests(cls, vm, nu0, window=window, max_nu=max_nu,
                         stall_windows=stall_windows, trace=trace)
    ts = None
    n_round = 0
    while True:
        try:
            nus = gen.send(ts) if ts is not None else next(gen)
        except StopIteration as stop:
            return stop.value
        # The span wraps only the evaluate (the generator is suspended at
        # its yield and must not sit inside a span).
        with _obs_trace.span("sweep_window", cat="search", cls=cls.name,
                             vm=vm.name, round=n_round, points=len(nus)):
            ts = evaluator.evaluate_frontier(cls, vm, nus)
        n_round += 1


@dataclass
class _Lane:
    """One VM type's sweep inside a race."""
    vm: VMType
    gen: object                       # the sweep_requests generator
    nu0: int                          # analytic minimum nu (the seed)
    rank: int                         # position in the analytic ranking
    trace: HCTrace
    nus: Optional[List[int]] = None   # pending window proposal
    result: Optional[ClassSolution] = None
    pruned: bool = False
    max_infeasible: int = 0           # largest nu probed infeasible so far
    refuted: bool = False             # feasible probe seen below nu0

    def floor(self) -> int:
        """Smallest nu this lane can still end at, given its evidence: the
        proven QN infeasibility floor, raised to the analytic minimum only
        while the lane's own probes have not refuted it (a feasible point
        below the analytic nu0 proves the analytic model pessimistic for
        this VM type, so its floor must no longer constrain the bound)."""
        floor = self.max_infeasible + 1
        if not self.refuted:
            floor = max(floor, self.nu0)
        return max(1, floor)

    def observe(self, cls: ApplicationClass, nus, ts) -> None:
        for n, t in zip(nus, ts):
            if t <= cls.deadline_ms:
                if n < self.nu0:
                    self.refuted = True
            else:
                self.max_infeasible = max(self.max_infeasible, int(n))
        self.trace.lane_bound = mix_cost(self.floor(), cls.eta, self.vm)


def race_requests(cls: ApplicationClass,
                  lanes: Sequence[Tuple[VMType, int]], *,
                  window: int = 16, max_nu: int = 8192,
                  stall_windows: int = 2,
                  traces: Optional[Dict[str, HCTrace]] = None):
    """Resumable propose/receive racer over per-VM-type sweep lanes.

    ``lanes`` is the analytic candidate ranking of one class, cheapest
    first: ``(vm, nu0)`` pairs where ``nu0`` is the VM type's analytic
    minimum nu (``milp.rank_vm_types``).  One ``sweep_requests`` lane runs
    per entry; each round *proposes* every active lane's window as a list
    of ``(vm, nus)`` pairs (``yield``) and *receives* the aligned response
    times as a ``{vm_name: ts}`` mapping (``send``).  Returns the winning
    ``ClassSolution`` as the ``StopIteration`` value.  Like the sweep it
    drives, the racer never evaluates anything itself — whoever drives it
    owns dispatch timing, so all lanes of a round (and, in the service, of
    many tenants) can share fused device calls.

    Race semantics:

      * every probed point is evaluated by the same evaluator a solo sweep
        of that lane would use, so per-point estimates are bit-exact versus
        the un-raced run;
      * *lower-bound pruning*: each lane carries a cost lower bound — the
        ``optimal_mix`` cost at the smallest nu the lane can still end at.
        That floor starts at the lane's analytic minimum nu and is updated
        from the lane's own QN evidence each round: probed infeasible
        points raise it (final nu > largest infeasible nu, feasibility
        being monotone in nu), while a feasible probe *below* the analytic
        minimum refutes the analytic floor entirely (the analytic model
        proved pessimistic for this VM type — only the QN infeasibility
        floor constrains the bound from then on).  Once some lane finishes
        with a QN-verified feasible solution (the incumbent), any
        unfinished lane whose bound strictly exceeds the incumbent's cost
        is retired without further dispatches.  A lane whose bound still
        beats the incumbent is never discarded (property-tested), and with
        a noise-free monotone evaluator the post-evidence bound is a true
        lower bound — the eventual winner can never be pruned;
      * the winner is the cheapest verified-feasible lane (ties broken by
        analytic rank); if no lane verifies feasible, the analytically
        cheapest lane's verdict is returned — with a single-entry catalog
        this degenerates to exactly today's solo sweep.
    """
    entries: List[_Lane] = []
    for rank, (vm, nu0) in enumerate(lanes):
        nu0 = max(1, int(nu0))
        tr = HCTrace(cls=cls.name, vm=vm.name,
                     lane_bound=mix_cost(nu0, cls.eta, vm))
        if traces is not None:
            traces[request_id(cls.name, vm.name)] = tr
        gen = sweep_requests(cls, vm, nu0, window=window, max_nu=max_nu,
                             stall_windows=stall_windows, trace=tr)
        # sweep_requests always proposes at least one window first, so the
        # priming next() cannot raise StopIteration
        entries.append(_Lane(vm=vm, gen=gen, nu0=nu0,
                             rank=rank, trace=tr, nus=next(gen)))
    incumbent: Optional[ClassSolution] = None
    while True:
        active = [ln for ln in entries
                  if ln.result is None and not ln.pruned]
        if not active:
            break
        results: Mapping = yield [(ln.vm, list(ln.nus)) for ln in active]
        for lane in active:
            ts = results[lane.vm.name]
            lane.observe(cls, lane.nus, ts)
            try:
                lane.nus = lane.gen.send(ts)
            except StopIteration as stop:
                lane.result = stop.value
                if lane.result.feasible and (
                        incumbent is None
                        or lane.result.cost_per_h < incumbent.cost_per_h):
                    incumbent = lane.result
        if incumbent is not None:
            for lane in entries:
                if lane.result is None and not lane.pruned \
                        and lane.trace.lane_bound > incumbent.cost_per_h:
                    lane.pruned = True
                    lane.trace.pruned = True
                    lane.gen.close()
    finished = [ln for ln in entries
                if ln.result is not None and ln.result.feasible]
    if finished:
        return min(finished,
                   key=lambda ln: (ln.result.cost_per_h, ln.rank)).result
    # nothing verified feasible => no incumbent => no lane was pruned, so
    # the analytically-cheapest lane ran to completion
    return entries[0].result


def race_class(cls: ApplicationClass, lanes: Sequence[Tuple[VMType, int]],
               evaluator, *, window: int = 16, max_nu: int = 8192,
               stall_windows: int = 2,
               traces: Optional[Dict[str, HCTrace]] = None) -> ClassSolution:
    """The one-job loop over ``race_requests``: each round's lane windows are
    satisfied with ONE fused ``evaluate_many`` call when the evaluator can
    fuse across VM types (``BatchedQNEvaluator``), per-lane
    ``evaluate_frontier`` calls otherwise, and scalar probes as the last
    resort."""
    gen = race_requests(cls, lanes, window=window, max_nu=max_nu,
                        stall_windows=stall_windows, traces=traces)
    results = None
    n_round = 0
    while True:
        try:
            props = gen.send(results) if results is not None else next(gen)
        except StopIteration as stop:
            return stop.value
        # The span wraps the round's evaluation only — the generator is
        # suspended at its yield and must stay outside any span.
        with _obs_trace.span("race_round", cat="search", cls=cls.name,
                             round=n_round, lanes=len(props),
                             points=sum(len(nus) for _, nus in props)):
            results = {}
            if hasattr(evaluator, "evaluate_many"):
                flat = [(cls, vm, int(n)) for vm, nus in props for n in nus]
                ts = evaluator.evaluate_many(flat)
                at = 0
                for vm, nus in props:
                    results[vm.name] = np.asarray(
                        ts[at:at + len(nus)], float)
                    at += len(nus)
            elif hasattr(evaluator, "evaluate_frontier"):
                for vm, nus in props:
                    results[vm.name] = np.asarray(
                        evaluator.evaluate_frontier(cls, vm, nus), float)
            else:
                for vm, nus in props:
                    results[vm.name] = np.asarray(
                        [evaluator(cls, vm, int(n)) for n in nus], float)
        n_round += 1


def hill_climb(
    problem: Problem, initial: Dict[str, ClassSolution],
    evaluate: Evaluator, *, parallel: bool = True, max_nu: int = 8192,
) -> Tuple[Dict[str, ClassSolution], Dict[str, HCTrace]]:
    """Algorithm 1: a parallel for over the classes (the point-wise
    ``optimize_class``), one worker thread per class up to 8 when
    ``parallel`` and there is more than one class."""
    traces = {c.name: HCTrace(cls=c.name) for c in problem.classes}

    def run_one(cls: ApplicationClass) -> Tuple[str, ClassSolution]:
        init = initial[cls.name]
        vm = problem.vm_by_name(init.vm_type)
        sol = optimize_class(cls, vm, init.nu, evaluate, max_nu=max_nu,
                             trace=traces[cls.name])
        return cls.name, sol

    if parallel and len(problem.classes) > 1:
        with ThreadPoolExecutor(
                max_workers=min(8, len(problem.classes))) as ex:
            results = dict(ex.map(run_one, problem.classes))
    else:
        results = dict(map(run_one, problem.classes))
    return results, traces
