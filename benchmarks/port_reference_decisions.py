"""Decisions and numbers of the JAX reference for the calls ``chip_smoke.py``
drives on the card, printed as the JSON that ``chip_smoke.REFERENCE`` holds.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks.port_reference_decisions [part ...]

Parts (all by default; each prints its wall time on stderr):

* ``plans``: the paper's §4.3 scenario (``scenario_problem("Q1", 10,
  160_000.0)`` with its replay lists) through ``DSpace4Cloud.run()`` and
  ``.run_fast()`` at the defaults, and through the point-wise gait
  ``DSpace4Cloud(batched=False).run()`` at the defaults, each on a fresh
  instance; and the quickstart problem through ``DSpace4Cloud(problem,
  min_jobs=20, replications=1).run()`` in both gaits (the point-wise one
  walks its two classes in two threads).
* ``batched_qn``, ``cost_deadline``, ``hc_convergence``, ``vm_race``: the
  repo's public-cloud planner benchmarks (``benchmarks/<name>.py``) at
  their own budgets (``cost_deadline`` on its quick grids), with the
  decisions, dispatch counts, pruned lanes and crossovers they report.
* ``table3``: the paper's Table 3 (``benchmarks/table3_qn_validation.py``):
  per row the cluster simulator's T, the QN's tau and theta.
* ``serving_qn``: the serving analogue's tau
  (``benchmarks/serving_qn_validation.py``) for fixed profiled round
  times ``SOLO_MS``.
* ``dag_sweep``: ``benchmarks/dag_sweep.py`` at its own budgets (the
  frontier scalar against batched, the optimizer point-wise and batched).
* ``spark_dag_plan``: the solo part of ``examples/spark_dag_plan.py`` (a
  MapReduce class and a 4-stage Spark chain in one problem) through
  ``run()`` in both gaits and ``run_fast()``.
* ``service``: the multi-tenant ``SolverService`` on four drives:
  ``benchmarks/service_throughput.py`` at its full size (eight tenants
  solo, then in one service, then a warm resubmission on the spill),
  ``examples/serve_many.py``'s five tenants (one a JSON submission), the
  service half of ``examples/spark_dag_plan.py`` (the mixed problem
  submitted twice, once as JSON) and four tenants planning the §4.3
  scenario ``scenario_problem("Q1", 10, D)`` at D = 300, 200, 160 and
  130 s with its replay lists (``window=16``, the defaults).  Per drive:
  each job's state and decisions, the rounds, the scheduler's counts,
  the points cached and deduplicated summed over the rounds (the
  ``fusion.*`` counters' deltas), the cache and admission stats and the
  per-tenant split.
* ``private_cloud``: the private-cloud plane in two drives.  ``bench``:
  ``benchmarks/private_cloud.py`` at its full size (the over-committed
  cluster coordinated by ``run()``, the unbounded cluster's ``run_fast()``
  bit-exact with the public one, the 24-window day), plus the same day on
  the over-committed cluster.  ``real``: the §4.3 classes Q1 (160 s) and
  Q3 (220 s) in one problem on 20-core hosts holding about half the
  public plan's cores, through ``run()``, ``run_fast()`` and the
  point-wise ``run()``, then as a private job in a ``SolverService``
  beside a public Q1 tenant, admitted against the cluster's cores.  Per
  plan: decisions, dispatches, the deployment summary and the placement's
  assignment; per day: dispatches, rounds, contracts, costs and
  ``windows_feasible``.
* ``capacity``: the TPU capacity planner on ``tests/test_capacity.py``'s
  synthetic costs (``benchmarks/torch_scenarios.py``'s
  ``CAPACITY_*``): five serving classes planned by the KKT ranking and
  QN-verified (slots, decisions, QN dispatches), the training plans, and
  on a synthetic dry-run record ``load_dryrun``'s costs,
  ``ElasticPlan.replan_capacity`` and the ``plan`` CLI's output.

Each scenario function takes the budgets as keywords, with the benchmark's
own as defaults (the two DAG parts take theirs from the constants of
``benchmarks/torch_scenarios.py``), and returns only numbers that do not
depend on a clock; ``benchmarks/torch_scenarios.py`` has the port's
counterpart of each, with the same budgets, and its ``mismatches``
compares the two.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from benchmarks.cost_deadline import _crossover, sweep
from benchmarks.vm_race import STEADY, _lane_parity, catalog_problem
from repro.core import qn_sim, shapes
from repro.core.cluster_sim import replayer_lists, simulate_cluster
from repro.core.optimizer import DSpace4Cloud
from repro.core.problem import ApplicationClass, JobProfile, Problem, VMType
from repro.core.tpcds import TABLE3, THINK_MS, calibrated_specs, \
    scenario_problem

# the serving analogue's profiled round times [ms] at which tau is printed
SOLO_MS = (150.0, 2500.0)

DECISION_KEYS = ("vm_type", "nu", "reserved", "spot", "cost_per_h",
                 "predicted_ms", "feasible")


def quickstart_problem() -> Problem:
    interactive = JobProfile(n_map=64, n_reduce=16, m_avg=4000, m_max=9000,
                             r_avg=2000, r_max=4500)
    batchy = JobProfile(n_map=400, n_reduce=64, m_avg=8000, m_max=18000,
                        r_avg=5000, r_max=11000)
    small = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   containers_per_core=2)
    big = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    return Problem(classes=[
        ApplicationClass(name="bi-dashboards", h_users=8, think_ms=10_000,
                         deadline_ms=60_000, eta=0.3,
                         profiles={"m4.xlarge": interactive,
                                   "c20.node": interactive.scaled(1.35)}),
        ApplicationClass(name="nightly-etl", h_users=2, think_ms=30_000,
                         deadline_ms=600_000, eta=0.5,
                         profiles={"m4.xlarge": batchy,
                                   "c20.node": batchy.scaled(1.35)}),
    ], vm_types=[small, big])


def plans() -> dict:
    prob, samples, _ = scenario_problem("Q1", 10, 160_000.0)
    reports = {
        "Q1-10u.run": DSpace4Cloud(prob, samples=samples).run(),
        "Q1-10u.run_fast": DSpace4Cloud(prob, samples=samples).run_fast(),
        "quickstart.run": DSpace4Cloud(quickstart_problem(), min_jobs=20,
                                       replications=1).run(),
        "Q1-10u.run_pointwise": DSpace4Cloud(prob, samples=samples,
                                             batched=False).run(),
        "quickstart.run_pointwise": DSpace4Cloud(
            quickstart_problem(), min_jobs=20, replications=1,
            batched=False).run(parallel=True),
    }
    return {name: {
        "qn_dispatches": r.qn_dispatches,
        "classes": {k: v.as_dict() for k, v in r.solutions.items()}}
        for name, r in reports.items()}


def _plan(rep) -> dict:
    """A report's decisions, as ``benchmarks/batched_qn.py`` and
    ``benchmarks/hc_convergence.py`` record them, with every class's
    solution beside them."""
    return {"evals": rep.evals, "dispatches": rep.qn_dispatches,
            "cost": rep.total_cost_per_h,
            "nu": {k: v.nu for k, v in rep.solutions.items()},
            "classes": {k: {f: v.as_dict()[f] for f in DECISION_KEYS}
                        for k, v in rep.solutions.items()}}


def batched_qn(*, points: int = 8, min_jobs: int = 25,
               replications: int = 1) -> dict:
    """``benchmarks/batched_qn.py`` on Q1-10u: a ``points``-point nu
    frontier scalar against batched, then the optimizer point-wise,
    batched and ``run_fast``."""
    prob, samples, _ = scenario_problem("Q1", 10, 160_000.0)
    cls, vm = prob.classes[0], prob.vm_types[0]
    prof = cls.profile_for(vm)
    ms, rs = samples[(cls.name, vm.name)]
    nus = np.arange(2, 2 + points)
    kw = dict(n_map=prof.n_map, n_reduce=prof.n_reduce, m_avg=prof.m_avg,
              r_avg=prof.r_avg, think_ms=cls.think_ms, h_users=cls.h_users,
              min_jobs=min_jobs, warmup_jobs=4, seed=0,
              replications=replications, m_samples=ms, r_samples=rs)
    d0 = qn_sim.dispatch_count()
    scalar = np.array([qn_sim.response_time(slots=int(s) * vm.slots, **kw)
                       for s in nus])
    d1 = qn_sim.dispatch_count()
    batched = qn_sim.response_time_batch(slots=nus * vm.slots, **kw)
    d2 = qn_sim.dispatch_count()
    fin = np.isfinite(scalar)
    frontier = {
        "points": int(points), "scalar_ms": scalar.tolist(),
        "batched_ms": np.asarray(batched, np.float64).tolist(),
        "scalar_dispatches": int(d1 - d0),
        "batched_dispatches": int(d2 - d1),
        "parity_max_rel_err": float(np.max(
            np.abs(scalar[fin] - batched[fin])
            / np.maximum(scalar[fin], 1e-9))) if fin.any() else 0.0}
    opt = {}
    for mode, batched_gait in (("scalar", False), ("batched", True)):
        opt[mode] = _plan(DSpace4Cloud(
            prob, min_jobs=min_jobs, replications=replications,
            samples=samples, batched=batched_gait).run())
    opt["fast_batched"] = _plan(DSpace4Cloud(
        prob, min_jobs=min_jobs, replications=replications,
        samples=samples, batched=True).run_fast())
    return {"frontier": frontier, "optimizer": opt,
            "dispatch_ratio": opt["scalar"]["dispatches"]
            / max(opt["batched"]["dispatches"], 1)}


# the grids of ``benchmarks/cost_deadline.py``'s ``run()`` (a local there)
COST_DEADLINE_GRIDS = {
    "fig5": ("Q1", 10, [300, 240, 200, 160, 130, 110]),
    "fig6": ("Q3", 10, [420, 330, 270, 220, 180, 150]),
    "fig7": ("Q1", 20, [300, 240, 200, 160, 130, 110, 95, 85, 75, 68,
                        62, 56, 50]),
}


def mono_cost(points) -> bool:
    """Cost non-increasing as the deadline loosens, per VM type (inline in
    ``benchmarks/cost_deadline.py``'s ``run()``)."""
    mono = True
    for vm in ("m4.xlarge", "CINECA"):
        cs = [p["cost_per_h"] for p in sorted(
            (x for x in points if x["vm"] == vm and x.get("feasible")),
            key=lambda x: x["deadline_s"])]
        mono &= all(cs[i] >= cs[i + 1] - 1e-9 for i in range(len(cs) - 1))
    return bool(mono)


def cost_deadline(*, quick: bool = True) -> dict:
    """``benchmarks/cost_deadline.py``'s ``sweep`` per figure (Figures
    5-7), with each figure's crossover, cost monotonicity and dispatches.
    ``quick`` takes every second deadline and ``min_jobs=15``, as the
    benchmark's own quick mode does."""
    out, summary = {}, {}
    for fig, (q, u, ds) in COST_DEADLINE_GRIDS.items():
        d0 = qn_sim.dispatch_count()
        pts = sweep(q, u, ds[::2] if quick else ds, quick=quick)
        out[fig] = pts
        summary[fig] = {"query": q, "users": u, "points": len(pts),
                        "crossover_deadline_s": _crossover(pts),
                        "mono_cost": mono_cost(pts),
                        "dispatches": int(qn_sim.dispatch_count() - d0)}
    out["summary"] = summary
    return out


def hc_convergence(*, min_jobs: int = 25) -> dict:
    """``benchmarks/hc_convergence.py``: Q1-10u with ``race=False`` in the
    classic point-wise, the batched and the ``run_fast`` gait."""
    prob, samples, _ = scenario_problem("Q1", 10, 160_000.0)
    kw = dict(min_jobs=min_jobs, replications=1, samples=samples,
              race=False)
    return {
        "classic": _plan(DSpace4Cloud(prob, batched=False, **kw).run()),
        "batched": _plan(DSpace4Cloud(prob, batched=True, **kw).run()),
        "fast": _plan(DSpace4Cloud(prob, batched=True, **kw).run_fast())}


def _race_solve(prob, race: bool, kw: dict, samples=None):
    d0 = qn_sim.dispatch_count()
    rep = DSpace4Cloud(prob, race=race, samples=samples, **kw).run()
    sol = rep.solutions["etl"]
    return rep, {"vm_type": sol.vm_type, "nu": sol.nu,
                 "reserved": sol.reserved, "spot": sol.spot,
                 "cost_per_h": sol.cost_per_h,
                 "predicted_ms": sol.predicted_ms,
                 "feasible": sol.feasible,
                 "dispatches": int(qn_sim.dispatch_count() - d0),
                 "evals": rep.evals}


def vm_race(*, min_jobs: int = 20, replications: int = 2) -> dict:
    """``benchmarks/vm_race.py``: the four-type catalog locked
    (``race=False``) against raced, per-lane parity against solo sweeps,
    and the single-type catalog's degenerate race."""

    kw = dict(min_jobs=min_jobs, replications=replications, seed=3,
              window=8)
    prob, samples = catalog_problem()
    _, locked = _race_solve(prob, False, kw, samples)
    raced_rep, raced = _race_solve(prob, True, kw, samples)
    lanes = {rid: {"bound": tr.lane_bound, "pruned": tr.pruned,
                   "evals": tr.evals, "nus": [m[0] for m in tr.moves],
                   "predicted_ms": [m[1] for m in tr.moves],
                   "feasible": [m[2] for m in tr.moves]}
             for rid, tr in raced_rep.traces.items()}
    single = Problem(classes=prob.classes, vm_types=[STEADY])
    _, single_locked = _race_solve(single, False, kw)
    _, single_raced = _race_solve(single, True, kw)
    keys = ("dispatches", "vm_type", "nu", "cost_per_h")
    return {"catalog_size": len(prob.vm_types),
            "locked": locked, "raced": raced, "lanes": lanes,
            "single_type": {"locked": single_locked, "raced": single_raced},
            "lanes_pruned": sum(1 for v in lanes.values() if v["pruned"]),
            "parity_bit_exact": bool(_lane_parity(prob, raced_rep, kw,
                                                  samples)),
            "degenerate_single_type": all(
                single_raced[k] == single_locked[k] for k in keys)}


def table3(*, rows=None, max_jobs: int = 40, min_jobs: int = 40,
           replications: int = 2) -> dict:
    """``benchmarks/table3_qn_validation.py``: per row of ``TABLE3`` (all,
    or the indices in ``rows``) T from the cluster simulator, the replay
    lists from profiling runs and tau from the scalar QN."""
    specs = calibrated_specs()
    out = []
    for i, s in enumerate(TABLE3):
        if rows is not None and i not in rows:
            continue
        sp = specs[i]
        T, _ = simulate_cluster(
            sp, slots=s.containers, h_users=s.users, think_ms=THINK_MS,
            max_jobs=max_jobs, warmup_jobs=5, seed=123)
        ms, rs = replayer_lists(sp, runs=20, slots=s.containers, seed=55)
        tau = qn_sim.response_time(
            n_map=s.n_map, n_reduce=s.n_reduce, m_avg=sp.map_ms,
            r_avg=sp.reduce_ms, think_ms=THINK_MS, h_users=s.users,
            slots=s.containers, min_jobs=min_jobs, warmup_jobs=8, seed=3,
            replications=replications, m_samples=ms, r_samples=rs)
        out.append({"row": i, "query": s.query, "users": s.users,
                    "cores": s.containers, "dataset_gb": s.dataset_gb,
                    "n_map": s.n_map, "n_reduce": s.n_reduce,
                    "events": qn_sim.padded_event_budget(
                        s.n_map, s.n_reduce, min_jobs=min_jobs,
                        warmup_jobs=8),
                    "max_slots": shapes.bucket_slots(s.containers),
                    "T_ms": T, "tau_ms": tau,
                    "theta_pct": (tau - T) / T * 100.0})
    a = np.abs([r["theta_pct"] for r in out])
    return {"rows": out, "mean_abs_theta_pct": float(a.mean()),
            "max_abs_theta_pct": float(a.max()),
            "paper_mean_pct": 12.27, "paper_max_pct": 30.59}


def serving_tau(solo_ms: float, *, n_requests: int = 12,
                slots: int = 3) -> float:
    """The serving analogue's QN prediction for a profiled round time
    ``solo_ms`` (``benchmarks/serving_qn_validation.py``): replay mode on
    ``solo_ms`` samples, a closed burst of ``n_requests`` on ``slots``."""
    return qn_sim.response_time(
        n_map=1, n_reduce=1, m_avg=solo_ms, r_avg=1e-3, think_ms=1.0,
        h_users=n_requests, slots=slots, min_jobs=n_requests * 6,
        warmup_jobs=n_requests * 2, seed=0, replications=2,
        m_samples=np.full(64, solo_ms, np.float32),
        r_samples=np.full(8, 1e-3, np.float32))


def serving_qn() -> dict:
    return {"n_requests": 12, "slots": 3, "solo_ms": list(SOLO_MS),
            "tau_ms": [serving_tau(s) for s in SOLO_MS]}


def dag_sweep() -> dict:
    """``benchmarks/dag_sweep.py`` on its 4-stage Spark class: a 16-point
    nu frontier, scalar ``dag_response_time`` against one
    ``response_time_batch``, then ``DSpace4Cloud`` point-wise and batched
    (``window=8``) at the 13 s deadline."""
    from benchmarks.dag_sweep import H_USERS, SPARK, THINK_MS, VM, \
        dag_problem
    from benchmarks.torch_scenarios import DAG_SWEEP_DEADLINE_MS, \
        DAG_SWEEP_MIN_JOBS, DAG_SWEEP_POINTS
    from repro.core.dag import dag_response_time, response_time_batch
    points = DAG_SWEEP_POINTS
    nus = np.arange(1, 1 + points)
    kw = dict(think_ms=THINK_MS, h_users=H_USERS,
              min_jobs=DAG_SWEEP_MIN_JOBS, warmup_jobs=4, seed=0,
              replications=1)
    d0 = qn_sim.dispatch_count()
    scalar = np.array([dag_response_time(SPARK, slots=int(s) * VM.slots,
                                         **kw) for s in nus])
    d1 = qn_sim.dispatch_count()
    batched = response_time_batch([SPARK] * points, slots=nus * VM.slots,
                                  **kw)
    d2 = qn_sim.dispatch_count()
    frontier = {"points": int(points),
                "predicted_ms": np.asarray(batched, np.float64).tolist(),
                "scalar_dispatches": int(d1 - d0),
                "batched_dispatches": int(d2 - d1),
                "parity_bit_exact": bool(np.array_equal(scalar, batched))}
    opt = {mode: _plan(DSpace4Cloud(
        dag_problem(deadline_ms=DAG_SWEEP_DEADLINE_MS), batched=gait,
        window=8, min_jobs=DAG_SWEEP_MIN_JOBS, replications=1,
        seed=0).run())
        for mode, gait in (("pointwise", False), ("batched", True))}
    return {"frontier": frontier, "optimizer": opt,
            "dispatch_ratio": opt["pointwise"]["dispatches"]
            / max(opt["batched"]["dispatches"], 1),
            "nu_agree": all(abs(opt["pointwise"]["nu"][k]
                                - opt["batched"]["nu"][k]) <= 2
                            for k in opt["pointwise"]["nu"])}


def spark_dag_problem() -> Problem:
    """The mixed problem of ``examples/spark_dag_plan.py``: a MapReduce BI
    class and a 4-stage Spark ETL chain on m4.xlarge and c20.node."""
    from repro.core.workload import DagJob, Stage
    small = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   containers_per_core=2)
    big = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    bi = JobProfile(n_map=64, n_reduce=16, m_avg=4000, m_max=9000,
                    r_avg=2000, r_max=4500)
    etl = DagJob("spark-etl", stages=(
        Stage(n_tasks=48, t_avg=900, t_max=2200),
        Stage(n_tasks=24, t_avg=700, t_max=1700),
        Stage(n_tasks=12, t_avg=1100, t_max=2600),
        Stage(n_tasks=4, t_avg=1500, t_max=3200)))
    return Problem(classes=[
        ApplicationClass(name="bi-dashboards", h_users=5, think_ms=10_000,
                         deadline_ms=60_000, eta=0.3,
                         profiles={"m4.xlarge": bi,
                                   "c20.node": bi.scaled(1.35)}),
        ApplicationClass(name="spark-etl", h_users=3, think_ms=9_000,
                         deadline_ms=14_000, eta=0.3,
                         profiles={"m4.xlarge": etl,
                                   "c20.node": etl.scaled(1.35)}),
    ], vm_types=[small, big])


def spark_dag_plan() -> dict:
    """The solo part of ``examples/spark_dag_plan.py``: the mixed problem
    through ``DSpace4Cloud.run()`` (batched, the example's own call), the
    point-wise ``run()`` and ``run_fast()``."""
    from benchmarks.torch_scenarios import SPARK_PLAN_KW as kw
    prob = spark_dag_problem()
    return {"run": _plan(DSpace4Cloud(prob, **kw).run()),
            "run_pointwise": _plan(DSpace4Cloud(prob, batched=False,
                                                **kw).run()),
            "run_fast": _plan(DSpace4Cloud(prob, **kw).run_fast())}


def _service_run(svc) -> tuple:
    """Run ``svc`` to completion; the ``fusion.*`` counters' deltas give
    the points cached and deduplicated summed over its rounds."""
    from repro.obs import registry
    before = registry().snapshot("fusion.")
    jobs = svc.run_until_complete()
    after = registry().snapshot("fusion.")
    return jobs, {k: after[f"fusion.{k}"] - before.get(f"fusion.{k}", 0)
                  for k in ("points_cached", "points_deduped")}


def service_throughput(n_jobs: int = None, **budgets) -> dict:
    """``benchmarks/service_throughput.py`` (at its full size by default):
    eight tenants solo, then in one service, then a fresh service on the
    spill."""
    import os
    import tempfile

    from benchmarks.service_throughput import N_JOBS, _job_equal, \
        tenant_problem
    from benchmarks.torch_scenarios import SERVICE_THROUGHPUT_KW, \
        SERVICE_THROUGHPUT_WINDOW as window, service_summary
    from repro.service import SolverService
    kw = {**SERVICE_THROUGHPUT_KW, **budgets}
    problems = [tenant_problem(i) for i in range(n_jobs or N_JOBS)]
    solo, solo_disp = [], []
    for prob in problems:
        d0 = qn_sim.dispatch_count()
        solo.append(DSpace4Cloud(prob, batched=True, window=window,
                                 **kw).run())
        solo_disp.append(qn_sim.dispatch_count() - d0)
    with tempfile.TemporaryDirectory() as tmp:
        spill = os.path.join(tmp, "service_eval_cache.json")
        svc = SolverService(window=window, cache_path=spill)
        jids = [svc.submit(p, tag=f"tenant-{i}", **kw)
                for i, p in enumerate(problems)]
        d0 = qn_sim.dispatch_count()
        jobs, fusion = _service_run(svc)
        service_disp = qn_sim.dispatch_count() - d0
        warm = SolverService(window=window, cache_path=spill)
        jids2 = [warm.submit(p, **kw) for p in problems]
        d0 = qn_sim.dispatch_count()
        jobs2 = warm.run_until_complete()
        warm_disp = qn_sim.dispatch_count() - d0
    return {"solo_dispatches": solo_disp,
            "service_dispatches": service_disp,
            "warm_dispatches": warm_disp,
            "warm_hit_rate": warm.cache.hit_rate,
            "parity": all(_job_equal(jobs[j].report, r)
                          for j, r in zip(jids, solo)),
            "warm_parity": all(_job_equal(jobs2[j].report, r)
                               for j, r in zip(jids2, solo)),
            "service": service_summary(svc, jobs, jids, fusion)}


def serve_many_problem(i: int) -> Problem:
    """Tenant ``i`` of ``examples/serve_many.py``."""
    vm = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                containers_per_core=2)
    prof = JobProfile(n_map=24 + 8 * i, n_reduce=6, m_avg=1400 + 150 * i,
                      m_max=2 * (1400 + 150 * i), r_avg=650, r_max=1300)
    cls = ApplicationClass(name=f"tenant-{i}", h_users=3, think_ms=9000.0,
                           deadline_ms=10_000.0, eta=0.3,
                           profiles={vm.name: prof})
    return Problem(classes=[cls], vm_types=[vm])


def serve_many(**budgets) -> dict:
    """``examples/serve_many.py``: four direct submissions and one JSON
    submission with its own solver section, in one service."""
    from benchmarks.torch_scenarios import SERVE_MANY_KW, \
        SERVE_MANY_WINDOW, service_summary
    from repro.service import SolverService
    kw = {**SERVE_MANY_KW, **budgets}
    svc = SolverService(window=SERVE_MANY_WINDOW)
    jids = [svc.submit(serve_many_problem(i), **kw) for i in range(4)]
    jids.append(svc.submit(json.dumps({
        "problem": json.loads(serve_many_problem(4).to_json()),
        "solver": {**kw, "seed": 0, "tag": "json-tenant"}})))
    jobs, fusion = _service_run(svc)
    return service_summary(svc, jobs, jids, fusion)


def spark_dag_service(problem=None, **budgets) -> dict:
    """The service half of ``examples/spark_dag_plan.py``: the mixed
    problem (``problem``, by default ``spark_dag_problem()``) submitted
    twice (the second time as JSON) to one service."""
    from benchmarks.torch_scenarios import SPARK_PLAN_KW, \
        SPARK_SERVICE_WINDOW, service_summary
    from repro.service import SolverService
    kw = {**SPARK_PLAN_KW, **budgets}
    prob = problem if problem is not None else spark_dag_problem()
    svc = SolverService(window=SPARK_SERVICE_WINDOW)
    jids = [svc.submit(prob, **kw), svc.submit(prob.to_json(), **kw)]
    jobs, fusion = _service_run(svc)
    return service_summary(svc, jobs, jids, fusion)


def q1_tenants(**budgets) -> dict:
    """Four tenants plan the §4.3 scenario, TPC-DS Q1 on 250 GB with 10
    users, at four deadlines, each with its replay lists, in one service
    (``window=16``; ``min_jobs=40``, ``replications=2`` unless
    ``budgets`` say otherwise)."""
    from benchmarks.torch_scenarios import Q1_TENANT_DEADLINES_S, \
        Q1_TENANT_WINDOW, service_summary
    from repro.service import SolverService
    svc = SolverService(window=Q1_TENANT_WINDOW)
    jids = []
    for d in Q1_TENANT_DEADLINES_S:
        prob, samples, _ = scenario_problem("Q1", 10, d * 1000.0)
        jids.append(svc.submit(prob, samples=samples, tag=f"Q1-{d}s",
                               **budgets))
    jobs, fusion = _service_run(svc)
    return service_summary(svc, jobs, jids, fusion)


def private_cloud_bench(**budgets) -> dict:
    """``benchmarks/private_cloud.py`` at its full size (or ``budgets``),
    plus its 24-window day on the over-committed cluster."""
    from benchmarks.private_cloud import make_problem
    from benchmarks.torch_scenarios import DAY_LEVELS, PRIVATE_CLOUD_KW, \
        cloud_plan, day_summary
    from repro.cloud import PrivateCloud, homogeneous_hosts
    from repro.cloud.placement import demand_cores, pack
    from repro.cloud.windows import plan_day
    kw = {**PRIVATE_CLOUD_KW, **budgets}
    prob = make_problem(3)
    pub = DSpace4Cloud(prob, **kw).run()
    demand = demand_cores(prob, pub.solutions)
    cloud = PrivateCloud(hosts=homogeneous_hosts(
        max(1, demand // 8), 4, energy_cost_per_h=0.3))
    priv = DSpace4Cloud(prob, deployment=cloud, **kw).run()
    big = PrivateCloud(hosts=homogeneous_hosts(64, 8, energy_cost_per_h=0.4))
    fast_pub = DSpace4Cloud(prob, **kw).run_fast()
    fast_priv = DSpace4Cloud(prob, deployment=big, **kw).run_fast()
    d0 = qn_sim.dispatch_count()
    DSpace4Cloud(prob, **kw).run()
    d_single = max(1, qn_sim.dispatch_count() - d0)
    day = {c.name: DAY_LEVELS for c in prob.classes}
    return {"demand_cores": demand, "capacity_cores": cloud.total_cores,
            "public": cloud_plan(pub, []),
            "private": cloud_plan(priv, pack(prob, priv.solutions,
                                             cloud).assignment),
            "unbounded": {
                "bit_exact": fast_priv.solutions == fast_pub.solutions,
                "coordinated": fast_priv.deployment["coordinated"],
                "classes": cloud_plan(fast_priv, [])["classes"]},
            "single_window_dispatches": d_single,
            "day": day_summary(plan_day(prob, day, **kw)),
            "day_private": day_summary(plan_day(prob, day,
                                                deployment=cloud, **kw))}


def private_cloud_real(**budgets) -> dict:
    """The §4.3 classes Q1 (160 s) and Q3 (220 s) in one problem, on
    ``homogeneous_hosts(max(1, demand // 40), 20)``: ``run()``,
    ``run_fast()``, point-wise ``run()``, then the private job in a service
    beside a public Q1 tenant (the defaults unless ``budgets`` say
    otherwise)."""
    from benchmarks.torch_scenarios import REAL_CLASSES, \
        REAL_ENERGY_PER_H, REAL_HOST_CORES, REAL_INFLIGHT_EVENTS, \
        REAL_PUBLIC_TENANT, cloud_plan, service_summary
    from repro.cloud import PrivateCloud, homogeneous_hosts
    from repro.cloud.placement import demand_cores, pack
    from repro.service import AdmissionController, SolverService
    classes, samples, vms = [], {}, None
    for query, deadline_ms in REAL_CLASSES:
        p, smp, _ = scenario_problem(query, 10, deadline_ms)
        classes += p.classes
        samples.update(smp)
        vms = p.vm_types
    prob = Problem(classes=classes, vm_types=vms)
    pub = DSpace4Cloud(prob, samples=samples, **budgets).run()
    demand = demand_cores(prob, pub.solutions)
    cloud = PrivateCloud(hosts=homogeneous_hosts(
        max(1, demand // 40), REAL_HOST_CORES,
        energy_cost_per_h=REAL_ENERGY_PER_H))
    out = {"demand_cores": demand, "capacity_cores": cloud.total_cores,
           "public": cloud_plan(pub, [])}
    for name, batched, solve in (
            ("run", True, lambda t: t.run()),
            ("run_fast", True, lambda t: t.run_fast()),
            ("run_pointwise", False, lambda t: t.run())):
        rep = solve(DSpace4Cloud(prob, samples=samples, deployment=cloud,
                                 batched=batched, **budgets))
        out[name] = cloud_plan(rep, pack(prob, rep.solutions,
                                         cloud).assignment)
    query, deadline_ms = REAL_PUBLIC_TENANT
    q1, q1_samples, _ = scenario_problem(query, 10, deadline_ms)
    svc = SolverService(admission=AdmissionController(
        max_inflight_events=REAL_INFLIGHT_EVENTS,
        max_physical_cores=cloud.total_cores))
    jids = [svc.submit(prob, samples=samples, deployment=cloud,
                       tag="private", **budgets),
            svc.submit(q1, samples=q1_samples, tag=f"{query}-public",
                       **budgets)]
    jobs, fusion = _service_run(svc)
    private = jobs[jids[0]].report
    out.update(service=service_summary(svc, jobs, jids, fusion),
               service_private=cloud_plan(private, pack(
                   prob, private.solutions, cloud).assignment))
    return out


def capacity() -> dict:
    """The TPU capacity planner (``core/capacity``) on
    ``tests/test_capacity.py``'s synthetic costs, as
    ``benchmarks/torch_scenarios.py`` ``capacity`` drives the port's: each
    serving class's slots and its plan in both modes (with the QN
    dispatches of each), the training plans, and on the synthetic dry-run
    record ``load_dryrun``'s costs, ``ElasticPlan.replan_capacity`` and the
    ``plan`` CLI's output."""
    import contextlib
    import io
    import os
    import tempfile

    from benchmarks.torch_scenarios import CAPACITY_CLI, CAPACITY_COSTS, \
        CAPACITY_REPLAN, CAPACITY_SERVING, CAPACITY_TRAINING, DECISION_KEYS, \
        capacity_record
    from repro.core.capacity import CellCost, ServingClass, \
        TPUCapacityPlanner, TrainClass, load_dryrun
    from repro.distributed.fault import ElasticPlan
    from repro.launch import plan as plan_cli

    def decisions(sol):
        return {f: sol.as_dict()[f] for f in DECISION_KEYS}

    planner = TPUCapacityPlanner(
        {k: CellCost(*v) for k, v in CAPACITY_COSTS.items()})
    out = {"slots": {}, "serving": {}, "training": {}}
    for spec in CAPACITY_SERVING:
        cls = ServingClass(*spec)
        out["slots"][cls.name] = {
            vm.name: vm.cores for vm in planner.serving_problem(cls).vm_types}
        out["serving"][cls.name] = {}
        for mode, use_qn in (("kkt", False), ("qn", True)):
            d0 = qn_sim.dispatch_count()
            sol = planner.plan_serving([cls], use_qn=use_qn)[cls.name]
            out["serving"][cls.name][mode] = {
                **decisions(sol),
                "dispatches": int(qn_sim.dispatch_count() - d0)}
    for name, arch, steps, deadline_h in CAPACITY_TRAINING:
        sol = planner.plan_training([TrainClass(
            name=name, arch=arch, steps=steps, deadline_h=deadline_h)])[name]
        out["training"][name] = decisions(sol)
    with tempfile.TemporaryDirectory() as tmp:
        record_path = os.path.join(tmp, "dryrun.json")
        with open(record_path, "w") as f:
            json.dump(capacity_record(), f)
        out["record"] = {f"{arch}|{shape}": [c.flops_per_dev, c.bytes_per_dev,
                                             c.coll_bytes_per_dev,
                                             c.ref_chips]
                         for (arch, shape), c in
                         sorted(load_dryrun(record_path).items())}
        arch, steps, deadline_h = CAPACITY_REPLAN
        out["replan"] = {k: decisions(v) for k, v in ElasticPlan.
                         replan_capacity(arch, steps, deadline_h,
                                         dryrun_path=record_path).items()}
        out["cli"] = {}
        argv0 = sys.argv
        for label, argv in CAPACITY_CLI.items():
            buf = io.StringIO()
            d0 = qn_sim.dispatch_count()
            sys.argv = ["plan", *argv, "--dryrun", record_path]
            try:
                with contextlib.redirect_stdout(buf):
                    plan_cli.main()
            finally:
                sys.argv = argv0
            out["cli"][label] = {
                "printed": json.loads(buf.getvalue()),
                "dispatches": int(qn_sim.dispatch_count() - d0)}
    return out


def private_cloud() -> dict:
    return {"bench": private_cloud_bench(), "real": private_cloud_real()}


def service() -> dict:
    return {"service_throughput": service_throughput(),
            "serve_many": serve_many(),
            "spark_dag_service": spark_dag_service(),
            "q1_tenants": q1_tenants()}


PARTS = {"plans": plans, "batched_qn": batched_qn,
         "cost_deadline": cost_deadline, "hc_convergence": hc_convergence,
         "vm_race": vm_race, "table3": table3, "serving_qn": serving_qn,
         "dag_sweep": dag_sweep, "spark_dag_plan": spark_dag_plan,
         "service": service, "private_cloud": private_cloud,
         "capacity": capacity}


def main() -> None:
    names = sys.argv[1:] or list(PARTS)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        res = PARTS[name]()
        print(f"[reference] {name}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        if name == "plans":
            out.update(res)
        else:
            out[name] = res
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
