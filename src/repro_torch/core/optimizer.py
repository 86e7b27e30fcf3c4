"""D-SPACE4Cloud facade — the Figure 3 pipeline on PyTorch.

JSON problem description in -> initial solution (analytic KKT
ranking, ``milp.rank_vm_types``) -> raced window sweeps on the QN
simulator (``hillclimb.race_requests``, every round one fused
``BatchedQNEvaluator.evaluate_many`` dispatch of the ``qn_event`` kernel)
-> reserved/spot pricing -> ``RunReport``.  ``run_fast`` first re-seeds
every racing lane from the batched AMVA frontier (``amva_nu_seed`` on the
``amva`` kernel).

``batched=False`` is the paper's point-wise gait instead: the evaluator
runs one scalar simulation per probe (``make_qn_evaluator``, one
single-lane ``qn_event`` dispatch per replication), and ``run()`` walks
each class on its analytically-ranked VM type with Algorithm 1
(``hillclimb.hill_climb``, the classes in worker threads).  Both gaits
share the cache keys and the per-point numbers.

Deployment-generic: passing a ``PrivateCloud`` (``deployment=`` keyword,
or the problem's own ``deployment`` field) turns every gait into a
private-cloud planner: after the unconstrained search, the fleet is
bin-packed onto the physical hosts and — if it over-commits them — the
dual-price coordinator (``repro_torch.cloud.joint``) re-races classes
under a shared price on cores until the packed plan is feasible, every
coordination probe flowing through the same fused QN plane and every
packing checked on the plan's device.  ``deployment=None`` is the paper's
public cloud: unbounded capacity, the public plan unchanged.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.cloud import joint as joint_mod
from repro_torch.cloud.hosts import PrivateCloud
from repro_torch.core import qn_sim
from repro_torch.core.evaluators import amva_nu_seed, \
    make_batched_qn_evaluator, make_qn_evaluator
from repro_torch.core.hillclimb import HCTrace, hill_climb, race_class, \
    race_requests, request_id
from repro_torch.core.milp import rank_vm_types
from repro_torch.core.problem import ApplicationClass, ClassSolution, \
    Problem, VMType, solution_cost
from repro_torch.obs import compile as _obs_compile
from repro_torch.obs import slo as _obs_slo
from repro_torch.obs import trace as _obs_trace


@dataclass
class EvalRequest:
    """One pending window of a resumable run: evaluate ``nus`` for
    (``cls``, ``vm``) and send the aligned response times back, keyed by
    ``rid``."""
    cls: ApplicationClass
    vm: VMType
    nus: list

    @property
    def rid(self) -> str:
        return request_id(self.cls.name, self.vm.name)


@dataclass
class RunReport:
    solutions: Dict[str, ClassSolution]
    total_cost_per_h: float
    wall_s: float
    evals: int
    traces: Dict[str, HCTrace] = field(default_factory=dict)
    initial: Optional[Dict[str, ClassSolution]] = None
    qn_dispatches: int = 0        # simulator device dispatches this run
    deployment: Optional[dict] = None  # JointPlan.summary() (private cloud)
    telemetry: Optional[dict] = None   # {"qn": sim-stat deltas, ...}
    slo: Optional[dict] = None         # obs.slo.solve_slo_summary(...)

    def to_json(self) -> str:
        return json.dumps({
            "total_cost_per_h": self.total_cost_per_h,
            "wall_s": self.wall_s,
            "qn_evaluations": self.evals,
            "qn_dispatches": self.qn_dispatches,
            "classes": {k: v.as_dict() for k, v in self.solutions.items()},
            "initial": ({k: v.as_dict() for k, v in self.initial.items()}
                        if self.initial else None),
            "deployment": self.deployment,
            "telemetry": self.telemetry,
            "slo": self.slo,
        }, indent=1)


def _snapshot() -> Dict[str, Dict[str, int]]:
    return {"qn": qn_sim.sim_stats(),
            "compile": _obs_compile.compile_stats()}


def _report(sols: Dict[str, ClassSolution], traces: Dict[str, HCTrace],
            init: Dict[str, ClassSolution], t0: float,
            snap0: Dict[str, Dict[str, int]], problem) -> RunReport:
    """Shared epilogue: per-run counter deltas (simulator dispatches under
    ``"qn"``, kernel builds under ``"compile"``), the span summary when a
    tracer is installed, and the deadline-margin summary."""
    qn1 = qn_sim.sim_stats()
    qn_delta = {k: qn1[k] - snap0["qn"].get(k, 0) for k in qn1}
    c1 = _obs_compile.compile_stats()
    telemetry = {"qn": qn_delta,
                 "compile": {k: c1[k] - snap0["compile"].get(k, 0)
                             for k in c1}}
    tracer = _obs_trace.active()
    if tracer is not None:
        telemetry["spans"] = tracer.summary()
    wall_s = time.time() - t0
    return RunReport(solutions=sols,
                     total_cost_per_h=solution_cost(sols),
                     wall_s=wall_s,
                     evals=sum(t.evals for t in traces.values()),
                     traces=traces, initial=init,
                     qn_dispatches=qn_delta["dispatches"],
                     telemetry=telemetry,
                     slo=_obs_slo.solve_slo_summary(problem, sols, wall_s))


class DSpace4Cloud:
    """The tool: optimization scenario of Figure 3.
    ``batched=True`` probes the QN tier through the batched evaluator
    (raced window sweeps), ``batched=False`` through the point-wise one
    (Algorithm 1 per class in ``run()``).  ``race=False`` locks each class
    to its analytically cheapest VM type in every gait (the batched race
    and ``run_fast`` then sweep one lane a class).  ``deployment`` (or the
    problem's own field) plans against a private cluster.  ``device`` is
    where the kernels and the packings' checks run: the current CUDA
    device by default, ``"cpu"`` for their plain versions."""

    def __init__(self, problem: Problem, *, min_jobs: int = 40,
                 replications: int = 2, seed: int = 0, samples=None,
                 batched: bool = True, window: int = 16,
                 race: bool = True,
                 deployment: Optional[PrivateCloud] = None,
                 cache: Optional[dict] = None, device=None):
        self.problem = problem
        self.window = window
        self.batched = batched
        self.race = race
        # the deployment target: an explicit keyword wins, else whatever
        # the problem document carries; None = public cloud (unbounded)
        self.deployment = deployment if deployment is not None \
            else getattr(problem, "deployment", None)
        self.device = resolve_device(device)
        self._qn_cache: dict = cache if cache is not None else {}
        self._rank_cache: Optional[Dict[str, List[ClassSolution]]] = None
        maker = make_batched_qn_evaluator if batched else make_qn_evaluator
        self.evaluate = maker(
            min_jobs=min_jobs, replications=replications, seed=seed,
            cache=self._qn_cache, samples=samples, device=self.device)

    def _full_ranking(self) -> Dict[str, List[ClassSolution]]:
        """``milp.rank_vm_types`` memoized per instance — both the race
        and the private-cloud coordinator read it."""
        if self._rank_cache is None:
            with _obs_trace.span("tier:kkt", cat="tier",
                                 classes=len(self.problem.classes)):
                self._rank_cache = rank_vm_types(self.problem)
        return self._rank_cache

    def _coordination_lanes(self) -> Dict[str, List]:
        """Per-class ``(vm, nu0)`` candidate lanes the dual-price
        coordinator may steer within — always the FULL analytic ranking,
        even under ``race=False``: a capacity-coupled plan must be free
        to shift classes across VM types, or pricing cores could never
        change anything."""
        return {name: [(self.problem.vm_by_name(c.vm_type), c.nu)
                       for c in cands]
                for name, cands in self._full_ranking().items()}

    def _ranking(self) -> Dict[str, List[ClassSolution]]:
        """Per-class analytic candidate ranking: every ranked VM type
        races, or with ``race=False`` only the analytic argmin (one lane a
        class)."""
        ranking = self._full_ranking()
        if not self.race:
            ranking = {name: cands[:1] for name, cands in ranking.items()}
        return ranking

    # ----------------------------------------------------- resumable steps
    def run_steps(self):
        """Resumable propose/receive form of ``run()``: each round yields
        the pending ``EvalRequest`` windows of every still-racing (class,
        VM type) lane and expects ``send()`` of a ``{rid: times}`` dict.
        Returns the ``RunReport`` as the ``StopIteration`` value.  On a
        private cloud the coordinator's probe rounds follow the race's,
        yielded the same way."""
        t0 = time.time()
        snap0 = _snapshot()
        ranking = self._ranking()
        init = {name: cands[0] for name, cands in ranking.items()}
        racers: Dict[str, object] = {}
        proposed: Dict[str, List[EvalRequest]] = {}
        sols: Dict[str, ClassSolution] = {}
        traces: Dict[str, HCTrace] = {}
        for cls in self.problem.classes:
            lanes = [(self.problem.vm_by_name(c.vm_type), c.nu)
                     for c in ranking[cls.name]]
            g = race_requests(cls, lanes, window=self.window, traces=traces)
            racers[cls.name] = g
            proposed[cls.name] = [EvalRequest(cls=cls, vm=vm, nus=nus)
                                  for vm, nus in next(g)]
        while proposed:
            results = yield [r for reqs in proposed.values() for r in reqs]
            nxt: Dict[str, List[EvalRequest]] = {}
            for name, reqs in proposed.items():
                lane_ts = {r.vm.name: np.asarray(results[r.rid])
                           for r in reqs}
                try:
                    props = racers[name].send(lane_ts)
                    nxt[name] = [EvalRequest(cls=reqs[0].cls, vm=vm, nus=nus)
                                 for vm, nus in props]
                except StopIteration as stop:
                    sols[name] = stop.value
            proposed = nxt
        if self.deployment is None:
            return _report(sols, traces, init, t0, snap0, self.problem)

        # ---- private cloud: pack the raced fleet; coordinate if it
        # over-commits.  The coordinator speaks the same propose/receive
        # protocol, so its probe rounds keep flowing through whoever
        # drives this generator (run()'s evaluate_many, or the service's
        # FusionScheduler — fused across tenants either way).
        coord = joint_mod.coordinate_requests(
            self.problem, self.deployment, sols,
            self._coordination_lanes(), window=self.window, traces=traces,
            device=self.device)
        results = None
        while True:
            try:
                props = coord.send(results) if results is not None \
                    else next(coord)
            except StopIteration as stop:
                plan = stop.value
                break
            results = yield [EvalRequest(cls=cls, vm=vm, nus=list(nus))
                             for cls, vm, nus in props]
        report = _report(plan.solutions, traces, init, t0, snap0,
                         self.problem)
        report.deployment = plan.summary()
        return report

    def run(self, parallel: bool = True) -> RunReport:
        """Analytic ranking + QN-verified search.  Batched: raced sweeps,
        every scheduling round's windows, across all classes and VM-type
        lanes, one ``evaluate_many`` call (one fused dispatch per fusion
        group).  Point-wise: Algorithm 1 per class on its analytically
        cheapest VM type, the classes in worker threads when
        ``parallel``; on a private cloud the coordinator's probes are
        then point-wise too."""
        if not self.batched:
            with _obs_trace.span("solve", cat="solve", mode="pointwise",
                                 classes=len(self.problem.classes)):
                t0 = time.time()
                snap0 = _snapshot()
                init = {name: cands[0]
                        for name, cands in self._ranking().items()}
                sols, hc_traces = hill_climb(self.problem, init,
                                             self.evaluate,
                                             parallel=parallel)
                traces = {request_id(name, init[name].vm_type): tr
                          for name, tr in hc_traces.items()}
                plan = None
                if self.deployment is not None:
                    plan = joint_mod.coordinate(
                        self.problem, self.deployment, sols,
                        self._coordination_lanes(), self.evaluate,
                        window=self.window, traces=traces,
                        device=self.device)
                    sols = plan.solutions
                report = _report(sols, traces, init, t0, snap0,
                                 self.problem)
                if plan is not None:
                    report.deployment = plan.summary()
                return report

        gen = self.run_steps()
        with _obs_trace.span("solve", cat="solve", mode="batched",
                             classes=len(self.problem.classes)):
            try:
                reqs = next(gen)
            except StopIteration as stop:      # pragma: no cover - no classes
                return stop.value
            n_round = 0
            with _obs_trace.span("tier:qn", cat="tier"):
                while True:
                    with _obs_trace.span(
                            "race_round", cat="search", round=n_round,
                            windows=len(reqs),
                            points=sum(len(r.nus) for r in reqs)):
                        flat = [(r.cls, r.vm, int(nu))
                                for r in reqs for nu in r.nus]
                        ts = self.evaluate.evaluate_many(flat)
                        results, at = {}, 0
                        for r in reqs:
                            results[r.rid] = np.asarray(
                                ts[at:at + len(r.nus)])
                            at += len(r.nus)
                    n_round += 1
                    try:
                        reqs = gen.send(results)
                    except StopIteration as stop:
                        return stop.value

    def run_fast(self, frontier_span: int = 64) -> RunReport:
        """The AMVA frontier re-seeds every racing lane
        (``amva_nu_seed``), then the QN race verifies from those seeds:
        one fused dispatch per race round per class."""
        t0 = time.time()
        snap0 = _snapshot()
        with _obs_trace.span("solve", cat="solve", mode="fast",
                             classes=len(self.problem.classes)):
            ranking = self._ranking()
            init = {name: cands[0] for name, cands in ranking.items()}
            sols: Dict[str, ClassSolution] = {}
            traces: Dict[str, HCTrace] = {}
            lanes_by_class: Dict[str, List] = {}
            for cls in self.problem.classes:
                lanes = []
                with _obs_trace.span("tier:amva", cat="tier", cls=cls.name,
                                     lanes=len(ranking[cls.name])):
                    for cand in ranking[cls.name]:
                        vm = self.problem.vm_by_name(cand.vm_type)
                        lanes.append((vm, amva_nu_seed(
                            cls, vm, cand.nu, frontier_span,
                            device=self.device)))
                lanes_by_class[cls.name] = lanes
                with _obs_trace.span("tier:qn", cat="tier", cls=cls.name):
                    sols[cls.name] = race_class(cls, lanes, self.evaluate,
                                                window=self.window,
                                                traces=traces)
            plan = None
            if self.deployment is not None:
                # coordination lanes keep the AMVA-frontier seeds where the
                # race already computed them (race=True covers the full
                # ranking; under race=False the analytic ranking fills in)
                lanes = self._coordination_lanes()
                for name, raced in lanes_by_class.items():
                    seeded = {vm.name: nu for vm, nu in raced}
                    lanes[name] = [(vm, seeded.get(vm.name, nu))
                                   for vm, nu in lanes[name]]
                plan = joint_mod.coordinate(
                    self.problem, self.deployment, sols, lanes,
                    self.evaluate, window=self.window, traces=traces,
                    device=self.device)
                sols = plan.solutions
            report = _report(sols, traces, init, t0, snap0, self.problem)
            if plan is not None:
                report.deployment = plan.summary()
            return report

    @staticmethod
    def from_json_file(path: str, **kw) -> "DSpace4Cloud":
        with open(path) as f:
            return DSpace4Cloud(Problem.from_json(f.read()), **kw)
