"""The repo's public-cloud planner benchmarks, the paper's Table 3 and its
serving analogue, driven through the PyTorch port.

One function per reference benchmark, each taking ``device`` (the CUDA
card by default; ``"cpu"`` runs the kernels' plain versions) and the
benchmark's budgets as keywords, with the benchmark's own as defaults (the
two DAG drivers run at their benchmark's budgets, the module's
``DAG_SWEEP_*`` and ``SPARK_PLAN_KW``):

* ``batched_qn``     -- ``benchmarks/batched_qn.py``: a nu frontier on
  Q1-10u, scalar ``response_time`` against one ``response_time_batch``,
  then ``DSpace4Cloud`` point-wise, batched and ``run_fast``;
* ``cost_deadline``  -- ``benchmarks/cost_deadline.py`` (Figures 5-7):
  per deadline and VM type ``initial_class_solution``, ``amva_frontier``
  over [nu-8, nu+8], then Algorithm 1 on the point-wise QN evaluator;
* ``hc_convergence`` -- ``benchmarks/hc_convergence.py``: Q1-10u with
  ``race=False`` in the classic, batched and ``run_fast`` gaits;
* ``vm_race``        -- ``benchmarks/vm_race.py``: a four-type catalog
  locked against raced, lower-bound pruning, per-lane parity, and the
  single-type catalog's degenerate race;
* ``table3``         -- ``benchmarks/table3_qn_validation.py``: per row T
  from the cluster simulator and tau from the scalar QN;
* ``serving_qn``     -- ``benchmarks/serving_qn_validation.py``: tau from
  profiled ``BatchingEngine`` rounds against the engine's closed-loop T.
* ``dag_sweep``      -- ``benchmarks/dag_sweep.py``: a Spark chain's nu
  frontier scalar against batched, then the optimizer point-wise and
  batched;
* ``spark_dag_plan`` -- the solo part of ``examples/spark_dag_plan.py``: a
  MapReduce class and a Spark chain in one problem through ``run()`` in
  both gaits and ``run_fast()``;
* ``service_throughput`` -- ``benchmarks/service_throughput.py``: eight
  tenants solo, then in one ``SolverService`` (every job bit-identical to
  its solo run), then a fresh service on the cache spill (no dispatch),
  optionally scraped over HTTP and traced;
* ``serve_many``     -- ``examples/serve_many.py``: five tenants, one a
  JSON submission, in one service;
* ``spark_dag_service`` -- the service half of
  ``examples/spark_dag_plan.py``: the mixed problem submitted twice (once
  as JSON), each job against the solo run;
* ``q1_tenants``     -- four tenants planning the paper's §4.3 scenario
  (TPC-DS Q1 on 250 GB, 10 users, replay lists) at deadlines 300, 200,
  160 and 130 s in one service (``window=16``), each job against its
  solo run;
* ``private_cloud``  -- the private-cloud plane in two drives:
  ``private_cloud_bench``, ``benchmarks/private_cloud.py`` at its full
  size (an over-committed cluster coordinated under the dual price, an
  unbounded one bit-exact with the public ``run_fast``, the 24-window
  day plan) plus the same day on the over-committed cluster; and
  ``private_cloud_real``, the paper's §4.3 classes Q1 (160 s) and Q3
  (220 s) in one problem on a cluster of 20-core hosts with about half
  the public plan's cores, through ``run()``, ``run_fast()`` and the
  point-wise ``run()``, then as a private job in a ``SolverService``
  beside a public Q1 tenant, admitted against the cluster's cores.
* ``capacity``       -- the TPU capacity planner (``core/capacity``) on
  ``tests/test_capacity.py``'s synthetic costs: five serving classes
  planned by the KKT ranking and QN-verified, the training plans, and on a
  synthetic dry-run record ``load_dryrun``, ``ElasticPlan.replan_capacity``
  and the ``plan`` CLI (``capacity_mismatches`` compares it).

Each returns the dict its reference benchmark's ``run()`` returns (or, for
``serving_qn``, records), with the decisions and counts the reference
prints beside it (``benchmarks/port_reference_decisions.py``, same
budgets); ``mismatches`` lists where a port dict differs from the
reference's.  ``torch_scenarios`` files nothing under ``results/``.

    PYTHONPATH=src python -m benchmarks.torch_scenarios [name ...] [--device cpu]
"""
from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cloud import PrivateCloud, homogeneous_hosts, plan_day
from repro_torch.cloud.placement import demand_cores, pack
from repro_torch.core import dag, qn_sim, shapes
from repro_torch.core.cluster_sim import replayer_lists, simulate_cluster
from repro_torch.core.evaluators import amva_frontier, make_qn_evaluator
from repro_torch.core.hillclimb import HCTrace, optimize_class, \
    request_id, sweep_class
from repro_torch.core.milp import initial_class_solution, rank_vm_types
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.core.problem import ApplicationClass, JobProfile, \
    Problem, VMType
from repro_torch.core.tpcds import TABLE3, THINK_MS, calibrated_specs, \
    scenario_problem
from repro_torch.core.workload import DagJob, Stage
from repro_torch.kernels.qn_event import ops as qn_ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import parse_openmetrics
from repro_torch.service import AdmissionController, SolverService

DECISION_KEYS = ("vm_type", "nu", "reserved", "spot", "cost_per_h",
                 "predicted_ms", "feasible")


def _dispatches() -> int:
    return qn_sim.sim_stats()["dispatches"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _plan(rep, wall_s: float) -> dict:
    """A report's numbers as the reference benchmarks record them, with
    every class's solution beside them."""
    return {"wall_s": wall_s, "evals": rep.evals,
            "dispatches": rep.qn_dispatches,
            "cost": rep.total_cost_per_h,
            "nu": {k: v.nu for k, v in rep.solutions.items()},
            "classes": {k: _decisions(v) for k, v in rep.solutions.items()}}


def _decisions(sol) -> dict:
    return {f: sol.as_dict()[f] for f in DECISION_KEYS}


def _timed_plan(dev, solve) -> dict:
    t0 = time.perf_counter()
    rep = solve()
    _sync(dev)
    return _plan(rep, time.perf_counter() - t0)


# ------------------------------------------------------------- batched_qn

def batched_qn(device=None, *, points: int = 8, min_jobs: int = 25,
               replications: int = 1) -> dict:
    """Q1-10u: a ``points``-point nu frontier, one scalar ``response_time``
    per point against one fused ``response_time_batch`` (the same seeds,
    so the same numbers), then the optimizer point-wise, batched and
    ``run_fast``."""
    dev = resolve_device(device)
    prob, samples, _ = scenario_problem("Q1", 10, 160_000.0)
    cls, vm = prob.classes[0], prob.vm_types[0]
    prof = cls.profile_for(vm)
    ms, rs = samples[(cls.name, vm.name)]
    nus = np.arange(2, 2 + points)
    kw = dict(n_map=prof.n_map, n_reduce=prof.n_reduce, m_avg=prof.m_avg,
              r_avg=prof.r_avg, think_ms=cls.think_ms, h_users=cls.h_users,
              min_jobs=min_jobs, warmup_jobs=4, seed=0,
              replications=replications, m_samples=ms, r_samples=rs,
              device=dev)
    d0 = _dispatches()
    t0 = time.perf_counter()
    scalar = np.array([qn_sim.response_time(slots=int(s) * vm.slots, **kw)
                       for s in nus])
    t1 = time.perf_counter()
    d1 = _dispatches()
    batched = qn_sim.response_time_batch(slots=nus * vm.slots, **kw)
    t2 = time.perf_counter()
    d2 = _dispatches()
    fin = np.isfinite(scalar)
    assert np.allclose(scalar[fin], batched[fin], rtol=1e-6), \
        "batched/scalar parity violated"
    frontier = {
        "points": int(points), "scalar_s": t1 - t0, "batched_s": t2 - t1,
        "scalar_evals_per_s": points / max(t1 - t0, 1e-9),
        "batched_evals_per_s": points / max(t2 - t1, 1e-9),
        "scalar_dispatches": d1 - d0, "batched_dispatches": d2 - d1,
        "parity_max_rel_err": float(np.max(
            np.abs(scalar[fin] - batched[fin])
            / np.maximum(scalar[fin], 1e-9))) if fin.any() else 0.0,
        "scalar_ms": scalar.tolist(),
        "batched_ms": np.asarray(batched, np.float64).tolist()}
    tool = lambda batched_gait: DSpace4Cloud(
        prob, min_jobs=min_jobs, replications=replications, samples=samples,
        batched=batched_gait, device=dev)
    opt = {"scalar": _timed_plan(dev, lambda: tool(False).run()),
           "batched": _timed_plan(dev, lambda: tool(True).run()),
           "fast_batched": _timed_plan(dev, lambda: tool(True).run_fast())}
    return {"frontier": frontier, "optimizer": opt,
            "dispatch_ratio": opt["scalar"]["dispatches"]
            / max(opt["batched"]["dispatches"], 1),
            "nu_agree": all(abs(opt["scalar"]["nu"][k]
                                - opt["batched"]["nu"][k]) <= 2
                            for k in opt["scalar"]["nu"])}


# ---------------------------------------------------------- cost_deadline

COST_DEADLINE_GRIDS = {
    "fig5": ("Q1", 10, [300, 240, 200, 160, 130, 110]),
    "fig6": ("Q3", 10, [420, 330, 270, 220, 180, 150]),
    # below m4's response-time floor only the faster CINECA cores remain
    # feasible: the paper's crossover region
    "fig7": ("Q1", 20, [300, 240, 200, 160, 130, 110, 95, 85, 75, 68,
                        62, 56, 50]),
}


def crossover(points) -> Optional[float]:
    """Largest deadline at which CINECA is strictly cheaper (while both
    feasible): the Figure 7 region."""
    by_d = {}
    for p in points:
        by_d.setdefault(p["deadline_s"], {})[p["vm"]] = p
    best = None
    for d, vms in sorted(by_d.items()):
        m4, cin = vms.get("m4.xlarge"), vms.get("CINECA")
        cin_ok = cin and cin.get("feasible")
        m4_ok = m4 and m4.get("feasible")
        if cin_ok and (not m4_ok or cin["cost_per_h"] < m4["cost_per_h"]):
            best = d if best is None else max(best, d)
    return best


def mono_cost(points) -> bool:
    """Cost non-increasing as the deadline loosens, per VM type."""
    mono = True
    for vm in ("m4.xlarge", "CINECA"):
        cs = [p["cost_per_h"] for p in sorted(
            (x for x in points if x["vm"] == vm and x.get("feasible")),
            key=lambda x: x["deadline_s"])]
        mono &= all(cs[i] >= cs[i + 1] - 1e-9 for i in range(len(cs) - 1))
    return bool(mono)


def cost_deadline(device=None, *, quick: bool = True) -> dict:
    """Figures 5-7: per deadline and VM type the analytic initial solution,
    the AMVA frontier over [nu-8, nu+8] (one ``amva`` launch), then
    Algorithm 1 on the point-wise QN evaluator from the frontier's first
    feasible nu.  ``quick`` takes every second deadline and ``min_jobs=15``
    (the reference's quick grids).  Returns ``{fig: points}`` and under
    ``"summary"`` each figure's crossover, cost monotonicity, dispatches
    and wall."""
    dev = resolve_device(device)
    mj = 15 if quick else 25
    out, summary = {}, {}
    for fig, (q, u, ds) in COST_DEADLINE_GRIDS.items():
        d0 = _dispatches()
        t0 = time.perf_counter()
        pts = []
        for d_s in (ds[::2] if quick else ds):
            prob, samples, _ = scenario_problem(q, u, d_s * 1000.0)
            cls = prob.classes[0]
            ev = make_qn_evaluator(min_jobs=mj, warmup_jobs=10,
                                   replications=1, seed=11, samples=samples,
                                   device=dev)
            for vm in prob.vm_types:
                init = initial_class_solution(cls, vm)
                if init is None:
                    pts.append({"deadline_s": d_s, "vm": vm.name,
                                "feasible": False})
                    continue
                lo = max(1, init.nu - 8)
                ts = amva_frontier(cls, vm, lo, init.nu + 8, device=dev)
                feas = np.where(ts <= cls.deadline_ms)[0]
                nu_star = lo + int(feas[0]) if len(feas) else init.nu
                sol = optimize_class(cls, vm, nu_star, ev, max_nu=400)
                pts.append({"deadline_s": d_s, "vm": vm.name,
                            "feasible": sol.feasible, "nu": sol.nu,
                            "cost_per_h": sol.cost_per_h,
                            "reserved": sol.reserved, "spot": sol.spot,
                            "T_s": sol.predicted_ms / 1000.0})
        _sync(dev)
        out[fig] = pts
        summary[fig] = {"query": q, "users": u, "points": len(pts),
                        "crossover_deadline_s": crossover(pts),
                        "mono_cost": mono_cost(pts),
                        "dispatches": _dispatches() - d0,
                        "wall_s": time.perf_counter() - t0}
    out["summary"] = summary
    return out


# --------------------------------------------------------- hc_convergence

def hc_convergence(device=None, *, min_jobs: int = 25) -> dict:
    """Q1-10u with ``race=False`` (the analytic-locked VM type) in three
    gaits: classic point-wise Algorithm 1, batched window sweeps and
    ``run_fast``.  The reference's XLA compile counters have no
    counterpart here: they are ``None``."""
    dev = resolve_device(device)
    prob, samples, _ = scenario_problem("Q1", 10, 160_000.0)
    kw = dict(min_jobs=min_jobs, replications=1, samples=samples,
              race=False, device=dev)
    out = {
        "classic": _timed_plan(dev, lambda: DSpace4Cloud(
            prob, batched=False, **kw).run()),
        "batched": _timed_plan(dev, lambda: DSpace4Cloud(
            prob, batched=True, **kw).run()),
        "fast": _timed_plan(dev, lambda: DSpace4Cloud(
            prob, batched=True, **kw).run_fast())}
    for mode in out.values():
        mode.update(compile_s=None, execute_s=None, compiles=None,
                    compile_cache_hits=None)
    agree = all(abs(out["classic"]["nu"][k] - out[m]["nu"][k]) <= 2
                for m in ("batched", "fast") for k in out["classic"]["nu"])
    assert agree, f"modes disagree beyond 2 VMs: {out}"
    return out


# ---------------------------------------------------------------- vm_race

STEADY = VMType(name="steady", cores=2, sigma=0.05, pi=0.20)
TURBO = VMType(name="turbo", cores=2, sigma=0.0425, pi=0.17)
VALUE = VMType(name="value", cores=2, sigma=0.0475, pi=0.19)
MICRO = VMType(name="micro", cores=1, sigma=0.15, pi=0.15)

_BASE = dict(n_map=24, n_reduce=6, m_avg=2000, r_avg=900)


def catalog_problem():
    """``benchmarks/vm_race.py``'s catalog: the analytic ranking is steady
    < value < turbo < micro (turbo pushed back by pessimistic profiled
    maxima), while at the QN tier turbo is cheapest.  micro's lane replays
    logged task durations about twice its profiled averages, so it climbs
    until its cost floor passes the incumbent and is pruned; it also forms
    a second fusion group (replay beside exponential lanes).  Returns
    ``(problem, samples)``."""
    profiles = {
        "steady": JobProfile(m_max=4000, r_max=1800, **_BASE),
        "value": JobProfile(m_max=5600, r_max=2520, **_BASE),
        "turbo": JobProfile(m_max=6000, r_max=2700, **_BASE),
        "micro": JobProfile(m_max=2000, r_max=900, **_BASE),
    }
    cls = ApplicationClass(name="etl", h_users=4, think_ms=6000.0,
                           deadline_ms=11_000.0, eta=0.25,
                           profiles=profiles)
    m_logged = [3600.0 + 40.0 * i for i in range(24)]      # avg ~4060 ms
    r_logged = [1620.0 + 60.0 * i for i in range(6)]       # avg ~1770 ms
    samples = {("etl", "micro"): (m_logged, r_logged)}
    return Problem(classes=[cls],
                   vm_types=[STEADY, TURBO, VALUE, MICRO]), samples


def _race_solve(dev, prob, race: bool, kw: dict, samples=None):
    d0 = _dispatches()
    t0 = time.perf_counter()
    rep = DSpace4Cloud(prob, race=race, samples=samples, device=dev,
                       **kw).run()
    _sync(dev)
    sol = rep.solutions["etl"]
    return rep, {"vm_type": sol.vm_type, "nu": sol.nu,
                 "reserved": sol.reserved, "spot": sol.spot,
                 "cost_per_h": sol.cost_per_h,
                 "predicted_ms": sol.predicted_ms,
                 "feasible": sol.feasible,
                 "dispatches": _dispatches() - d0,
                 "evals": rep.evals, "wall_s": time.perf_counter() - t0}


def _lane_parity(dev, prob, raced_rep, kw: dict, samples=None) -> bool:
    """Every point the race probed equals a solo sweep of the same lane
    (same seed, fresh evaluator): a pruned lane probed a prefix of it, an
    unpruned lane all of it."""
    cls = prob.classes[0]
    ranking = {s.vm_type: s for s in rank_vm_types(prob)["etl"]}
    for vm in prob.vm_types:
        rid = request_id("etl", vm.name)
        if rid not in raced_rep.traces:
            continue                     # analytically infeasible: no lane
        tr = HCTrace(cls="etl")
        solo_kw = {k: kw[k] for k in ("min_jobs", "replications", "seed")}
        ev = DSpace4Cloud(Problem(classes=[cls], vm_types=[vm]),
                          window=kw["window"], samples=samples, device=dev,
                          **solo_kw).evaluate
        sweep_class(cls, vm, ranking[vm.name].nu, ev, window=kw["window"],
                    trace=tr)
        race_moves = raced_rep.traces[rid].moves
        if tr.moves[:len(race_moves)] != race_moves:
            return False
        if not raced_rep.traces[rid].pruned and tr.moves != race_moves:
            return False
    return True


def vm_race(device=None, *, min_jobs: int = 20,
            replications: int = 2) -> dict:
    """The four-type catalog locked (``race=False``) against raced; the
    reference's quick budgets are ``min_jobs=8, replications=1``."""
    dev = resolve_device(device)
    kw = dict(min_jobs=min_jobs, replications=replications, seed=3,
              window=8)
    prob, samples = catalog_problem()
    _, locked = _race_solve(dev, prob, False, kw, samples)
    raced_rep, raced = _race_solve(dev, prob, True, kw, samples)
    parity = _lane_parity(dev, prob, raced_rep, kw, samples)
    lanes = {rid: {"bound": tr.lane_bound, "pruned": tr.pruned,
                   "evals": tr.evals, "nus": [m[0] for m in tr.moves],
                   "predicted_ms": [m[1] for m in tr.moves],
                   "feasible": [m[2] for m in tr.moves]}
             for rid, tr in raced_rep.traces.items()}
    assert parity, "raced lane points diverged from solo sweeps"
    assert raced["cost_per_h"] < locked["cost_per_h"], \
        "racer failed to beat the analytic-locked choice"
    assert raced["dispatches"] <= 2 * max(locked["dispatches"], 1), \
        f"race cost {raced['dispatches']} dispatches > " \
        f"2x locked {locked['dispatches']}"
    single = Problem(classes=prob.classes, vm_types=[STEADY])
    _, single_locked = _race_solve(dev, single, False, kw)
    _, single_raced = _race_solve(dev, single, True, kw)
    degenerate = all(single_raced[k] == single_locked[k]
                     for k in ("dispatches", "vm_type", "nu", "cost_per_h"))
    assert degenerate, "single-type catalog did not degenerate to locked"
    return {"catalog_size": len(prob.vm_types),
            "locked": locked, "raced": raced, "lanes": lanes,
            "single_type": {"locked": single_locked, "raced": single_raced},
            "saving_per_h": locked["cost_per_h"] - raced["cost_per_h"],
            "dispatch_ratio": raced["dispatches"]
            / max(locked["dispatches"], 1),
            "lanes_pruned": sum(1 for v in lanes.values() if v["pruned"]),
            "parity_bit_exact": parity,
            "degenerate_single_type": degenerate}


# ----------------------------------------------------------------- table3

def table3(device=None, *, rows=None, max_jobs: int = 40,
           min_jobs: int = 40, replications: int = 2) -> dict:
    """The paper's Table 3: per row (all 12, or the indices in ``rows``)
    T from the cluster simulator (``max_jobs``, 5 warm-up jobs, seed 123),
    the replay lists from 20 profiling runs (seed 55) and tau from the
    scalar QN (``min_jobs``, 8 warm-up jobs, seed 3, ``replications``
    single-lane dispatches), theta = (tau - T) / T.  Each row also records
    its event budget, the launches of each event-loop kernel that ran (as
    ``qn_event.routes`` counts them; none on the CPU) and the host wall of
    the two simulators apart."""
    dev = resolve_device(device)
    specs = calibrated_specs()
    out = []
    for i, s in enumerate(TABLE3):
        if rows is not None and i not in rows:
            continue
        sp = specs[i]
        t0 = time.perf_counter()
        T, _ = simulate_cluster(
            sp, slots=s.containers, h_users=s.users, think_ms=THINK_MS,
            max_jobs=max_jobs, warmup_jobs=5, seed=123)
        ms, rs = replayer_lists(sp, runs=20, slots=s.containers, seed=55)
        t1 = time.perf_counter()
        n0 = qn_ops.qn_event.launches
        k0 = dict(qn_ops.qn_event.routes)
        tau = qn_sim.response_time(
            n_map=s.n_map, n_reduce=s.n_reduce, m_avg=sp.map_ms,
            r_avg=sp.reduce_ms, think_ms=THINK_MS, h_users=s.users,
            slots=s.containers, min_jobs=min_jobs, warmup_jobs=8, seed=3,
            replications=replications, m_samples=ms, r_samples=rs,
            device=dev)
        _sync(dev)
        t2 = time.perf_counter()
        events = qn_sim.padded_event_budget(s.n_map, s.n_reduce,
                                            min_jobs=min_jobs, warmup_jobs=8)
        max_slots = shapes.bucket_slots(s.containers)
        out.append({"row": i, "query": s.query, "users": s.users,
                    "cores": s.containers, "dataset_gb": s.dataset_gb,
                    "n_map": s.n_map, "n_reduce": s.n_reduce,
                    "events": events, "max_slots": max_slots,
                    "kernels": {k: n - k0[k] for k, n in
                                qn_ops.qn_event.routes.items() if n > k0[k]},
                    "launches": qn_ops.qn_event.launches - n0,
                    "cluster_sim_s": t1 - t0, "qn_s": t2 - t1,
                    "T_ms": T, "tau_ms": tau,
                    "theta_pct": (tau - T) / T * 100.0})
    a = np.abs([r["theta_pct"] for r in out])
    return {"rows": out, "mean_abs_theta_pct": float(a.mean()),
            "max_abs_theta_pct": float(a.max()),
            "paper_mean_pct": 12.27, "paper_max_pct": 30.59}


# ------------------------------------------------------------- serving_qn

def serving_tau(solo_ms: float, *, n_requests: int = 12, slots: int = 3,
                device=None) -> float:
    """The QN's predicted latency of a closed burst of ``n_requests`` on
    ``slots`` sequence slots, each request one task of a profiled round
    time ``solo_ms`` (replay mode on ``solo_ms`` samples: decode rounds
    are near-deterministic), think ~0."""
    return qn_sim.response_time(
        n_map=1, n_reduce=1, m_avg=solo_ms, r_avg=1e-3, think_ms=1.0,
        h_users=n_requests, slots=slots, min_jobs=n_requests * 6,
        warmup_jobs=n_requests * 2, seed=0, replications=2,
        m_samples=np.full(64, solo_ms, np.float32),
        r_samples=np.full(8, 1e-3, np.float32), device=device)


def _round_ms(eng, dev, cfg, prompt_len, gen_len, slots, rng) -> float:
    for _ in range(slots):
        eng.submit(rng.integers(1, cfg.vocab_size, size=prompt_len).tolist(),
                   gen_len=gen_len)
    _sync(dev)
    t0 = time.time()
    eng.run()
    _sync(dev)
    return (time.time() - t0) * 1e3


def serving_qn(device=None, *, arch: str = "granite-3-2b",
               smoke: bool = True, n_requests: int = 12, slots: int = 3,
               prompt_len: int = 32, gen_len: int = 24,
               runs: int = 5) -> dict:
    """Profiling rounds (``runs`` full rounds of ``slots`` identical
    requests on a dedicated engine, after one warm-up) give ``solo_ms``,
    the median round; the QN predicts tau from it (``serving_tau``); then
    a closed loop of ``n_requests`` (each completion resubmits at once)
    runs ``3 * (n_requests // slots)`` rounds on a fresh engine, and T is
    the mean latency past the first third.  ``smoke`` takes the arch's
    smoke config, else its full config; weights are seeded random
    (``torch.Generator(...).manual_seed(0)``)."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.distributed.sharding import init_params
    from repro_torch.models import api
    from repro_torch.serve.engine import BatchingEngine

    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    params = init_params(api.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0))
    eng = BatchingEngine(cfg, params, max_batch=slots, temperature=0.0)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    _round_ms(eng, dev, cfg, prompt_len, gen_len, slots, rng)   # warm-up
    solo_ms = float(np.median([
        _round_ms(eng, dev, cfg, prompt_len, gen_len, slots, rng)
        for _ in range(runs)]))
    t1 = time.perf_counter()
    tau = serving_tau(solo_ms, n_requests=n_requests, slots=slots,
                      device=dev)
    t2 = time.perf_counter()
    prefills = len(eng.round_stats)
    del eng
    eng = BatchingEngine(cfg, params, max_batch=slots, temperature=0.0)
    del params                        # the engine keeps its working copy
    rng = np.random.default_rng(0)

    def fresh():
        return rng.integers(1, cfg.vocab_size, size=prompt_len).tolist()

    for _ in range(slots):
        eng.submit(fresh(), gen_len=gen_len)
    eng.run()                                  # warm-up round (B = slots)
    for _ in range(n_requests):
        eng.submit(fresh(), gen_len=gen_len)
    lats = []
    rounds = 3 * (n_requests // slots)         # ~3 full cycles
    for _ in range(rounds):
        eng._run_round()
        completed, eng._done = eng._done, []
        for r in completed:
            lats.append(r.latency_s * 1e3)
            eng.submit(fresh(), gen_len=gen_len)   # closed loop
    _sync(dev)
    warm = len(lats) // 3
    T = float(np.mean(lats[warm:]))
    return {"solo_latency_ms": solo_ms, "qn_tau_ms": tau,
            "engine_T_ms": T, "theta_pct": (tau - T) / T * 100.0,
            "n_requests": n_requests, "slots": slots, "arch": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "prompt_len": prompt_len, "gen_len": gen_len,
            "rounds": rounds, "prefills": prefills + len(eng.round_stats),
            "profile_s": t1 - t0, "qn_s": t2 - t1,
            "closed_loop_s": time.perf_counter() - t2}


# -------------------------------------------------------------- DAG plans

SMALL_VM = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                  containers_per_core=2)
BIG_VM = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
# the 4-stage Spark ETL chain of benchmarks/dag_sweep.py and
# examples/spark_dag_plan.py: read -> shuffle-heavy join -> aggregate ->
# write
SPARK = DagJob("spark-etl", stages=(
    Stage(n_tasks=48, t_avg=900, t_max=2200),
    Stage(n_tasks=24, t_avg=700, t_max=1700),
    Stage(n_tasks=12, t_avg=1100, t_max=2600),
    Stage(n_tasks=4, t_avg=1500, t_max=3200)))
DAG_SWEEP_THINK_MS = 9000.0
DAG_SWEEP_USERS = 3
# the budgets of benchmarks/dag_sweep.py (its frontier's points, min_jobs
# and the optimizer's deadline) and of examples/spark_dag_plan.py's
# DSpace4Cloud call; port_reference_decisions.py drives the reference at
# the same
DAG_SWEEP_POINTS = 16
DAG_SWEEP_MIN_JOBS = 16
DAG_SWEEP_DEADLINE_MS = 13_000.0
SPARK_PLAN_KW = dict(min_jobs=15, replications=1)


def dag_sweep_problem() -> Problem:
    """``benchmarks/dag_sweep.py``'s one-class problem: the Spark chain,
    3 users thinking 9 s, on m4.xlarge, at the 13 s deadline."""
    cls = ApplicationClass(name="spark-etl", h_users=DAG_SWEEP_USERS,
                           think_ms=DAG_SWEEP_THINK_MS,
                           deadline_ms=DAG_SWEEP_DEADLINE_MS, eta=0.3,
                           profiles={SMALL_VM.name: SPARK})
    return Problem(classes=[cls], vm_types=[SMALL_VM])


def dag_sweep(device=None) -> dict:
    """``benchmarks/dag_sweep.py``: a 16-point nu frontier of the
    Spark chain, one scalar ``dag_response_time`` per point against one
    fused ``response_time_batch`` (bit for bit, asserted), then
    ``DSpace4Cloud`` point-wise and batched (``window=8``) at the 13 s
    deadline."""
    dev = resolve_device(device)
    vm = SMALL_VM
    points = DAG_SWEEP_POINTS
    nus = np.arange(1, 1 + points)
    kw = dict(think_ms=DAG_SWEEP_THINK_MS, h_users=DAG_SWEEP_USERS,
              min_jobs=DAG_SWEEP_MIN_JOBS, warmup_jobs=4, seed=0,
              replications=1, device=dev)
    d0 = _dispatches()
    t0 = time.perf_counter()
    scalar = np.array([dag.dag_response_time(SPARK, slots=int(s) * vm.slots,
                                             **kw) for s in nus])
    t1 = time.perf_counter()
    d1 = _dispatches()
    batched = dag.response_time_batch([SPARK] * points,
                                      slots=nus * vm.slots, **kw)
    t2 = time.perf_counter()
    d2 = _dispatches()
    parity = bool(np.array_equal(scalar, batched))
    assert parity, "DAG batched/scalar parity violated"
    frontier = {"points": int(points), "scalar_s": t1 - t0,
                "batched_s": t2 - t1,
                "predicted_ms": np.asarray(batched, np.float64).tolist(),
                "scalar_dispatches": d1 - d0, "batched_dispatches": d2 - d1,
                "parity_bit_exact": parity}
    opt = {mode: _timed_plan(dev, lambda: DSpace4Cloud(
        dag_sweep_problem(), batched=gait, window=8,
        min_jobs=DAG_SWEEP_MIN_JOBS, replications=1, seed=0,
        device=dev).run())
        for mode, gait in (("pointwise", False), ("batched", True))}
    return {"frontier": frontier, "optimizer": opt,
            "dispatch_ratio": opt["pointwise"]["dispatches"]
            / max(opt["batched"]["dispatches"], 1),
            "nu_agree": all(abs(opt["pointwise"]["nu"][k]
                                - opt["batched"]["nu"][k]) <= 2
                            for k in opt["pointwise"]["nu"])}


def spark_dag_problem() -> Problem:
    """``examples/spark_dag_plan.py``'s problem: a MapReduce BI class (the
    paper's Table-1 shape) and the Spark chain, on m4.xlarge and
    c20.node."""
    bi = JobProfile(n_map=64, n_reduce=16, m_avg=4000, m_max=9000,
                    r_avg=2000, r_max=4500)
    return Problem(classes=[
        ApplicationClass(name="bi-dashboards", h_users=5, think_ms=10_000,
                         deadline_ms=60_000, eta=0.3,
                         profiles={SMALL_VM.name: bi,
                                   BIG_VM.name: bi.scaled(1.35)}),
        ApplicationClass(name="spark-etl", h_users=3, think_ms=9_000,
                         deadline_ms=14_000, eta=0.3,
                         profiles={SMALL_VM.name: SPARK,
                                   BIG_VM.name: SPARK.scaled(1.35)}),
    ], vm_types=[SMALL_VM, BIG_VM])


def spark_dag_plan(device=None) -> dict:
    """The solo part of ``examples/spark_dag_plan.py``: the mixed problem
    through ``run()`` (batched: each workload kind fused into its own
    dispatches), the point-wise ``run()`` and ``run_fast()``."""
    dev = resolve_device(device)
    tool = lambda batched: DSpace4Cloud(
        spark_dag_problem(), batched=batched, device=dev, **SPARK_PLAN_KW)
    return {"run": _timed_plan(dev, lambda: tool(True).run()),
            "run_pointwise": _timed_plan(dev, lambda: tool(False).run()),
            "run_fast": _timed_plan(dev, lambda: tool(True).run_fast())}


# ---------------------------------------------------------------- service

# the budgets of benchmarks/service_throughput.py (its full size), of
# examples/serve_many.py and of examples/spark_dag_plan.py's service half,
# and the Q1 tenants' deadlines [s] (Figure 5's three and the paper's own
# 160 s) and window; port_reference_decisions.py drives the reference at
# the same
SERVICE_TENANTS = 8
SERVICE_THROUGHPUT_KW = dict(min_jobs=25, replications=2, seed=0)
SERVICE_THROUGHPUT_WINDOW = 8
SERVE_MANY_KW = dict(min_jobs=15, replications=1)
SERVE_MANY_WINDOW = 8
SPARK_SERVICE_WINDOW = 8
Q1_TENANT_DEADLINES_S = (300, 200, 160, 130)
Q1_TENANT_WINDOW = 16


def throughput_problem(i: int) -> Problem:
    """Tenant ``i`` of ``benchmarks/service_throughput.py``: one workload
    family (3 users, fusable), its own profile scale and deadline."""
    prof = JobProfile(n_map=32, n_reduce=8,
                      m_avg=1200.0 + 100.0 * i, m_max=2 * (1200 + 100 * i),
                      r_avg=600.0 + 40.0 * i, r_max=2 * (600 + 40 * i))
    cls = ApplicationClass(name=f"tenant-{i}", h_users=3, think_ms=8000.0,
                           deadline_ms=35_000.0 + 5_000.0 * i, eta=0.3,
                           profiles={SMALL_VM.name: prof})
    return Problem(classes=[cls], vm_types=[SMALL_VM])


def serve_many_problem(i: int) -> Problem:
    """Tenant ``i`` of ``examples/serve_many.py``."""
    prof = JobProfile(n_map=24 + 8 * i, n_reduce=6, m_avg=1400 + 150 * i,
                      m_max=2 * (1400 + 150 * i), r_avg=650, r_max=1300)
    cls = ApplicationClass(name=f"tenant-{i}", h_users=3, think_ms=9000.0,
                           deadline_ms=10_000.0, eta=0.3,
                           profiles={SMALL_VM.name: prof})
    return Problem(classes=[cls], vm_types=[SMALL_VM])


def job_equal(rep_a, rep_b) -> bool:
    """Same final deployment AND the same per-point estimates (every
    trace move), bit for bit."""
    if rep_a.solutions != rep_b.solutions:
        return False
    return all(rep_a.traces[k].moves == rep_b.traces[k].moves
               for k in rep_a.traces)


def _delta(counts, before) -> Optional[dict]:
    if counts is None:
        return None
    now = counts()
    return {k: n - before.get(k, 0) for k, n in now.items()}


def service_run(svc, dev) -> tuple:
    """Run ``svc`` to completion; returns its jobs, the points cached and
    deduplicated summed over its rounds (the ``fusion.*`` counters'
    deltas), and its timing: simulator dispatches, wall (ending in a
    sync), and its rounds' ``service.round_ms`` (the histogram's mean over
    this run, the largest round from the flight recorder)."""
    reg = obs_metrics.registry()
    before = reg.snapshot("fusion.")
    h0 = reg.histogram("service.round_ms").snapshot()
    d0 = _dispatches()
    t0 = time.perf_counter()
    jobs = svc.run_until_complete()
    _sync(dev)
    wall = time.perf_counter() - t0
    after = reg.snapshot("fusion.")
    h1 = reg.histogram("service.round_ms").snapshot()
    fusion = {k: after[f"fusion.{k}"] - before.get(f"fusion.{k}", 0)
              for k in ("points_cached", "points_deduped")}
    n = h1["count"] - h0["count"]
    rounds = [e["wall_ms"] for e in svc.recorder.events("round")]
    timing = {"dispatches": _dispatches() - d0, "wall_s": wall,
              "round_ms": {"count": n,
                           "mean": (h1["sum"] - h0["sum"]) / n if n else 0.0,
                           "max": max(rounds, default=0.0)}}
    return jobs, fusion, timing


def service_summary(svc, jobs, job_ids, fusion) -> dict:
    """A service's clock-free numbers: rounds, the scheduler's counts, the
    points cached and deduplicated over the rounds, cache and admission
    stats, the per-tenant split and each job's state and decisions.  It
    reads only what both packages' services share, so
    ``port_reference_decisions.py`` summarises the reference's with it
    too."""
    stats = svc.stats()
    return {
        "rounds": svc.rounds, "scheduler": stats["scheduler"],
        "points_cached": fusion["points_cached"],
        "points_deduped": fusion["points_deduped"],
        "cache": stats["cache"], "admission": stats["admission"],
        "tenants": {t: {k: v for k, v in ts.items() if k != "wall_ms"}
                    for t, ts in stats["tenants"].items()},
        "jobs": {jid: {"tenant": jobs[jid].tenant, "state": jobs[jid].state,
                       "classes": ({k: {f: v.as_dict()[f]
                                        for f in DECISION_KEYS}
                                    for k, v in
                                    jobs[jid].report.solutions.items()}
                                   if jobs[jid].report is not None
                                   else None)}
                 for jid in job_ids}}


def scrape(svc) -> dict:
    """Scrape the live service over HTTP (on localhost): ``/statz``'s
    per-tenant split must sum to the scheduler's totals, ``/healthz`` must
    report an empty queue and ``/metrics`` must parse as OpenMetrics."""
    import urllib.request

    handle = svc.serve_http()
    try:
        def get(path):
            with urllib.request.urlopen(handle.url + path, timeout=30) as r:
                return r.read().decode()
        statz = json.loads(get("/statz"))
        health = json.loads(get("/healthz"))
        families = parse_openmetrics(get("/metrics"))
    finally:
        svc.stop_http()
    tenants = statz["tenants"]
    split = {k: sum(t[k] for t in tenants.values())
             for k in ("points_dispatched", "points_cached", "points")}
    sched = svc.scheduler.stats()
    assert split["points_dispatched"] == sched["points_dispatched"], \
        f"dispatch attribution leaked: {split} vs {sched}"
    assert split["points"] == sched["points_requested"], \
        f"point attribution leaked: {split} vs {sched}"
    assert health["ok"] and health["queue_depth"] == 0, health
    slo = statz["slo"]
    return {"tenants": len(tenants), "split": split, "scheduler": sched,
            "dispatch_split": {t: tenants[t]["points_dispatched"]
                               for t in sorted(tenants)},
            "worst_margin_ms": {t: slo[t]["worst_margin_ms"]
                                for t in sorted(tenants)},
            "metric_families": len(families)}


def check_service_trace(tracer) -> dict:
    """The traced service phase: its Chrome export passes
    ``validate_chrome_trace`` and a ``kernel:*`` span sits under
    ``service.run`` through ``fused_dispatch``."""
    chrome = tracer.to_chrome()
    n_events = obs_trace.validate_chrome_trace(chrome)
    kernels = [sp for sp in tracer.spans if sp.name.startswith("kernel:")]
    chains = [tracer.chain(sp) for sp in kernels]
    under = [c for c in chains if "service.run" in c]
    assert under, f"no kernel span under service.run ({chains[:4]})"
    deepest = max(under, key=len)
    assert "fused_dispatch" in deepest, deepest
    return {"chrome_events": n_events, "n_spans": len(tracer.spans),
            "kernel_spans": len(under), "deepest_kernel_chain": deepest}


def service_throughput(device=None, *, trace: bool = False,
                       http: bool = False, counts=None,
                       n_jobs: int = SERVICE_TENANTS, **budgets) -> dict:
    """``benchmarks/service_throughput.py``: each tenant's solo ``run()``,
    then all of them in one ``SolverService`` (with ``trace``, under an
    installed tracer whose Chrome export and span chain are checked; with
    ``http``, scraped over HTTP after it settles), then a fresh service on
    the cache spill.  ``counts`` (a callable returning launch counts)
    gives each phase's launches under ``"launches"``."""
    import os
    import tempfile

    dev = resolve_device(device)
    kw = {**SERVICE_THROUGHPUT_KW, **budgets}
    window = SERVICE_THROUGHPUT_WINDOW
    problems = [throughput_problem(i) for i in range(n_jobs)]
    launches = {}
    c0 = counts() if counts else None
    solo, solo_disp = [], []
    t0 = time.perf_counter()
    for prob in problems:
        d0 = _dispatches()
        solo.append(DSpace4Cloud(prob, batched=True, window=window,
                                 device=dev, **kw).run())
        solo_disp.append(_dispatches() - d0)
    _sync(dev)
    solo_wall = time.perf_counter() - t0
    launches["solo"] = _delta(counts, c0)
    with tempfile.TemporaryDirectory() as tmp:
        spill = os.path.join(tmp, "service_eval_cache.json")
        svc = SolverService(window=window, cache_path=spill, device=dev)
        jids = [svc.submit(p, tag=f"tenant-{i}", **kw)
                for i, p in enumerate(problems)]
        c0 = counts() if counts else None
        if trace:
            with obs_trace.tracing() as tracer:
                jobs, fusion, timing = service_run(svc, dev)
        else:
            jobs, fusion, timing = service_run(svc, dev)
        launches["service"] = _delta(counts, c0)
        warm = SolverService(window=window, cache_path=spill, device=dev)
        jids2 = [warm.submit(p, **kw) for p in problems]
        c0 = counts() if counts else None
        jobs2, _, warm_timing = service_run(warm, dev)
        launches["warm"] = _delta(counts, c0)
    out = {"solo_dispatches": solo_disp,
           "service_dispatches": timing["dispatches"],
           "warm_dispatches": warm_timing["dispatches"],
           "warm_hit_rate": warm.cache.hit_rate,
           "parity": all(job_equal(jobs[j].report, r)
                         for j, r in zip(jids, solo)),
           "warm_parity": all(job_equal(jobs2[j].report, r)
                              for j, r in zip(jids2, solo)),
           "service": service_summary(svc, jobs, jids, fusion),
           "solo_wall_s": solo_wall, "timing": timing,
           "warm_timing": warm_timing}
    if counts is not None:
        out["launches"] = launches
    if trace:
        out["trace"] = check_service_trace(tracer)
    if http:
        out["scrape"] = scrape(svc)
    return out


def serve_many(device=None, **budgets) -> dict:
    """``examples/serve_many.py``: four direct submissions and one JSON
    submission with its own solver section, in one service."""
    dev = resolve_device(device)
    kw = {**SERVE_MANY_KW, **budgets}
    svc = SolverService(window=SERVE_MANY_WINDOW, device=dev)
    jids = [svc.submit(serve_many_problem(i), **kw) for i in range(4)]
    jids.append(svc.submit(json.dumps({
        "problem": json.loads(serve_many_problem(4).to_json()),
        "solver": {**kw, "seed": 0, "tag": "json-tenant"}})))
    jobs, fusion, timing = service_run(svc, dev)
    return {**service_summary(svc, jobs, jids, fusion), "timing": timing}


def spark_dag_service(device=None, problem=None, *, counts=None,
                      **budgets) -> dict:
    """The service half of ``examples/spark_dag_plan.py``: the mixed
    problem (``problem``, by default ``spark_dag_problem()``) solo at the
    default window, then submitted twice to one service at ``window=8``
    (the second time as JSON); each job's decisions against the solo
    run's, as the example asserts (the windows differ, so the walks
    do).  ``counts`` gives each phase's launches."""
    dev = resolve_device(device)
    kw = {**SPARK_PLAN_KW, **budgets}
    prob = problem if problem is not None else spark_dag_problem()
    c0 = counts() if counts else None
    solo = DSpace4Cloud(prob, device=dev, **kw).run()
    launches = {"solo": _delta(counts, c0)}
    svc = SolverService(window=SPARK_SERVICE_WINDOW, device=dev)
    jids = [svc.submit(prob, **kw), svc.submit(prob.to_json(), **kw)]
    c0 = counts() if counts else None
    jobs, fusion, timing = service_run(svc, dev)
    launches["service"] = _delta(counts, c0)
    out = {**service_summary(svc, jobs, jids, fusion),
           "solo_equal": [jobs[j].report.solutions == solo.solutions
                          for j in jids],
           "timing": timing}
    if counts is not None:
        out["launches"] = launches
    return out


def q1_tenants(device=None, *, solo: bool = True, counts=None,
               **budgets) -> dict:
    """Four tenants plan the §4.3 scenario (``scenario_problem("Q1", 10,
    D)`` with its replay lists) at the deadlines ``Q1_TENANT_DEADLINES_S``
    in one service (``window=16``, the defaults ``min_jobs=40``,
    ``replications=2``); with ``solo``, each job also solo and held
    against it bit for bit.  ``counts`` gives each phase's launches."""
    dev = resolve_device(device)
    tenants = [(d, *scenario_problem("Q1", 10, d * 1000.0)[:2])
               for d in Q1_TENANT_DEADLINES_S]
    out, launches = {}, {}
    if solo:
        c0 = counts() if counts else None
        t0 = time.perf_counter()
        solos = [DSpace4Cloud(prob, samples=smp, window=Q1_TENANT_WINDOW,
                              device=dev, **budgets).run()
                 for _, prob, smp in tenants]
        _sync(dev)
        out["solo_wall_s"] = time.perf_counter() - t0
        out["solo_dispatches"] = [r.qn_dispatches for r in solos]
        launches["solo"] = _delta(counts, c0)
    svc = SolverService(window=Q1_TENANT_WINDOW, device=dev)
    jids = [svc.submit(prob, samples=smp, tag=f"Q1-{d}s", **budgets)
            for d, prob, smp in tenants]
    c0 = counts() if counts else None
    jobs, fusion, timing = service_run(svc, dev)
    launches["service"] = _delta(counts, c0)
    out.update(service_summary(svc, jobs, jids, fusion), timing=timing)
    if solo:
        out["solo_equal"] = [job_equal(jobs[j].report, r)
                             for j, r in zip(jids, solos)]
    if counts is not None:
        out["launches"] = launches
    return out


# ---------------------------------------------------------- private cloud
# benchmarks/private_cloud.py: "roomy" is cheapest per slot-hour but burns
# 4 physical cores a VM; "dense" packs 2 containers a core (the same 4
# slots on half the metal), a little dearer.  Its full-size budgets and
# its day of 4 distinct concurrency levels
ROOMY = VMType(name="roomy", cores=4, sigma=0.05, pi=0.20)
DENSE = VMType(name="dense", cores=2, sigma=0.055, pi=0.22,
               containers_per_core=2)
CLOUD_PROF = JobProfile(n_map=24, n_reduce=6, m_avg=2000, r_avg=900,
                        m_max=4000, r_max=1800)
PRIVATE_CLOUD_KW = dict(min_jobs=20, replications=2, seed=3, window=8)
DAY_LEVELS = [1] * 6 + [2] * 6 + [4] * 8 + [6] * 4
# the real-size drive: the paper's §4.3 classes (query, deadline [ms]; 220
# s is a point of Figure 6's grid) in one problem, on hosts of 20 cores
# (a CINECA node's width) holding about half the public plan's cores; the
# public tenant beside it in the service; its admission's event budget
# holds both jobs at once
REAL_CLASSES = (("Q1", 160_000.0), ("Q3", 220_000.0))
REAL_HOST_CORES = 20
REAL_ENERGY_PER_H = 0.3
REAL_PUBLIC_TENANT = ("Q1", 160_000.0)
REAL_INFLIGHT_EVENTS = 64_000_000


def private_cloud_problem(n_classes: int = 3) -> Problem:
    """``benchmarks/private_cloud.py``'s problem: ``n_classes`` identical
    classes (4 users, 11 s deadline) on roomy and dense."""
    return Problem(classes=[
        ApplicationClass(name=f"c{i}", h_users=4, think_ms=6000.0,
                         deadline_ms=11_000.0, eta=0.25,
                         profiles={"roomy": CLOUD_PROF,
                                   "dense": CLOUD_PROF})
        for i in range(n_classes)], vm_types=[ROOMY, DENSE])


def real_cloud_problem() -> tuple:
    """The classes of ``REAL_CLASSES`` (``scenario_problem`` each, with
    their replay lists) merged into one problem on the shared catalog."""
    classes, samples, vms = [], {}, None
    for query, deadline_ms in REAL_CLASSES:
        prob, smp, _ = scenario_problem(query, 10, deadline_ms)
        classes += prob.classes
        samples.update(smp)
        vms = prob.vm_types
    return Problem(classes=classes, vm_types=vms), samples


def cloud_plan(rep, assignment) -> dict:
    """A private plan's numbers: decisions, dispatches, the deployment
    summary and the final placement's VM-to-host assignment (``pack`` of
    the final solutions, which is the plan's own placement)."""
    return {"qn_dispatches": rep.qn_dispatches,
            "classes": {k: {f: v.as_dict()[f] for f in DECISION_KEYS}
                        for k, v in rep.solutions.items()},
            "deployment": rep.deployment,
            "assignment": [int(h) for h in assignment]}


def day_summary(plan) -> dict:
    """A ``DayPlan``'s clock-free numbers (no SLO margins: they are
    response times)."""
    return {"windows": len(plan.reports),
            "vm_day_cost": plan.vm_day_cost,
            "energy_day_cost": plan.energy_day_cost,
            "naive_hourly_cost": plan.naive_hourly_cost,
            "qn_dispatches": plan.qn_dispatches, "rounds": plan.rounds,
            "windows_feasible": plan.windows_feasible,
            "coordinated": [bool((r.deployment or {}).get("coordinated"))
                            for r in plan.reports],
            "contracts": [c.as_dict() for c in plan.contracts]}


def _cloud_run(dev, prob, cloud, solve, walls, name, **kw) -> tuple:
    """``solve`` a private plan; its report and its ``cloud_plan``."""
    t0 = time.perf_counter()
    rep = solve(DSpace4Cloud(prob, deployment=cloud, device=dev, **kw))
    _sync(dev)
    walls[name] = time.perf_counter() - t0
    return rep, cloud_plan(rep, pack(prob, rep.solutions, cloud,
                                     device=dev).assignment)


def private_cloud_bench(device=None, **budgets) -> dict:
    """``benchmarks/private_cloud.py`` (at its full size by default): the
    over-committed cluster (about half the public plan's cores, in
    4-core hosts) coordinated by ``run()``; an unbounded cluster (64 x 8
    cores) whose ``run_fast()`` must equal the public one bit for bit;
    the 24-window day plan against one window's dispatches; and the same
    day on the over-committed cluster."""
    dev = resolve_device(device)
    kw = {**PRIVATE_CLOUD_KW, **budgets}
    prob = private_cloud_problem(3)
    walls = {}
    t0 = time.perf_counter()
    pub = DSpace4Cloud(prob, device=dev, **kw).run()
    _sync(dev)
    walls["public"] = time.perf_counter() - t0
    demand = demand_cores(prob, pub.solutions)
    cloud = PrivateCloud(hosts=homogeneous_hosts(
        max(1, demand // 8), 4, energy_cost_per_h=0.3))
    _, private = _cloud_run(dev, prob, cloud, lambda t: t.run(), walls,
                            "private", **kw)
    big = PrivateCloud(hosts=homogeneous_hosts(64, 8, energy_cost_per_h=0.4))
    fast_pub = DSpace4Cloud(prob, device=dev, **kw).run_fast()
    t0 = time.perf_counter()
    fast_priv = DSpace4Cloud(prob, deployment=big, device=dev,
                             **kw).run_fast()
    _sync(dev)
    walls["unbounded_run_fast"] = time.perf_counter() - t0
    d0 = _dispatches()
    DSpace4Cloud(prob, device=dev, **kw).run()
    d_single = max(1, _dispatches() - d0)
    day = {c.name: DAY_LEVELS for c in prob.classes}
    days = {}
    for name, dep in (("day", None), ("day_private", cloud)):
        t0 = time.perf_counter()
        plan = plan_day(prob, day, deployment=dep, device=dev, **kw)
        _sync(dev)
        walls[name] = time.perf_counter() - t0
        days[name] = day_summary(plan)
    return {"demand_cores": demand, "capacity_cores": cloud.total_cores,
            "public": cloud_plan(pub, []), "private": private,
            "unbounded": {
                "bit_exact": fast_priv.solutions == fast_pub.solutions,
                "coordinated": fast_priv.deployment["coordinated"],
                "classes": cloud_plan(fast_priv, [])["classes"]},
            "single_window_dispatches": d_single, **days,
            "walls": walls}


def private_cloud_real(device=None, *, counts=None, **budgets) -> dict:
    """The §4.3 classes of ``REAL_CLASSES`` in one problem (the defaults
    ``min_jobs=40``, ``replications=2``, ``window=16`` unless ``budgets``
    say otherwise): the public ``run()`` sizes the cluster
    (``homogeneous_hosts(max(1, demand // 40), 20)``); the private plan
    through ``run()``, ``run_fast()`` and the point-wise ``run()``; then
    the private job in a ``SolverService`` beside a public Q1 tenant,
    admitted against the cluster's cores, and held against the solo
    ``run()`` bit for bit.  ``counts`` gives each phase's launches."""
    dev = resolve_device(device)
    prob, samples = real_cloud_problem()
    walls, launches, out = {}, {}, {}
    c0 = counts() if counts else None
    t0 = time.perf_counter()
    pub = DSpace4Cloud(prob, samples=samples, device=dev, **budgets).run()
    _sync(dev)
    walls["public"] = time.perf_counter() - t0
    launches["public"] = _delta(counts, c0)
    demand = demand_cores(prob, pub.solutions)
    cloud = PrivateCloud(hosts=homogeneous_hosts(
        max(1, demand // 40), REAL_HOST_CORES,
        energy_cost_per_h=REAL_ENERGY_PER_H))
    out.update(demand_cores=demand, capacity_cores=cloud.total_cores,
               public=cloud_plan(pub, []))
    reports = {}
    for name, batched, solve in (
            ("run", True, lambda t: t.run()),
            ("run_fast", True, lambda t: t.run_fast()),
            ("run_pointwise", False, lambda t: t.run())):
        c0 = counts() if counts else None
        reports[name], out[name] = _cloud_run(
            dev, prob, cloud, solve, walls, name, samples=samples,
            batched=batched, **budgets)
        launches[name] = _delta(counts, c0)
    query, deadline_ms = REAL_PUBLIC_TENANT
    q1, q1_samples, _ = scenario_problem(query, 10, deadline_ms)
    svc = SolverService(admission=AdmissionController(
        max_inflight_events=REAL_INFLIGHT_EVENTS,
        max_physical_cores=cloud.total_cores), device=dev)
    jids = [svc.submit(prob, samples=samples, deployment=cloud,
                       tag="private", **budgets),
            svc.submit(q1, samples=q1_samples, tag=f"{query}-public",
                       **budgets)]
    c0 = counts() if counts else None
    jobs, fusion, timing = service_run(svc, dev)
    launches["service"] = _delta(counts, c0)
    private = jobs[jids[0]].report
    out.update(service=service_summary(svc, jobs, jids, fusion),
               service_private=cloud_plan(private, pack(
                   prob, private.solutions, cloud, device=dev).assignment),
               timing=timing, walls=walls,
               # every trace move and decision, bit for bit
               service_equal_solo=job_equal(private, reports["run"]))
    if counts is not None:
        out["launches"] = launches
    return out


def private_cloud(device=None) -> dict:
    """Both private-cloud drives at their full sizes."""
    return {"bench": private_cloud_bench(device),
            "real": private_cloud_real(device)}


# --------------------------------------------------------------- capacity
# tests/test_capacity.py's synthetic per-device costs on the 256-chip
# reference mesh, (flops, bytes, collective bytes) by (arch, shape)
CAPACITY_COSTS = {
    ("granite-3-2b", "train_4k"): (4.5e12, 6.0e11, 2.0e7),
    ("granite-3-2b", "prefill_32k"): (1.2e12, 2.5e11, 1.0e7),
    ("granite-3-2b", "decode_32k"): (2.0e9, 3.0e9, 5.0e6),
    ("mamba2-780m", "decode_32k"): (6.0e6, 2.0e7, 1.0e5),
}
# the serving classes (name, arch, prompt_len, gen_len, sessions, think_ms,
# deadline_ms): tests/test_capacity.py's two, examples/capacity_planning.py's
# chat class, the same traffic on mamba2-780m (past 16384 slots), and a
# crowd whose KKT ranking leaves v5e-16
CAPACITY_SERVING = (
    ("s", "granite-3-2b", 2048, 128, 32, 5_000.0, 20_000.0),
    ("s256", "granite-3-2b", 2048, 128, 256, 5_000.0, 20_000.0),
    ("chat-granite", "granite-3-2b", 4096, 256, 64, 10_000.0, 20_000.0),
    ("chat-mamba2", "mamba2-780m", 4096, 256, 64, 10_000.0, 20_000.0),
    ("crowd-granite", "granite-3-2b", 32768, 512, 2048, 5_000.0, 330.0),
)
# the training classes (name, arch, steps, deadline_h): tests/test_capacity.py's
CAPACITY_TRAINING = (("t24", "granite-3-2b", 200_000, 24.0),
                     ("t12", "granite-3-2b", 200_000, 12.0))
# ElasticPlan.replan_capacity's (arch, steps remaining, deadline_h) on the
# synthetic record
CAPACITY_REPLAN = ("granite-3-2b", 120_000, 12.0)
# the plan CLI's arguments, each run on the synthetic record
CAPACITY_CLI = {
    "serve-qn": ("serve", "--arch", "granite-3-2b", "--sessions", "64",
                 "--deadline-ms", "20000"),
    "serve-kkt": ("serve", "--arch", "mamba2-780m", "--sessions", "64",
                  "--deadline-ms", "20000", "--no-qn"),
    "train": ("train", "--arch", "granite-3-2b", "--steps", "200000",
              "--deadline-h", "24"),
}
# the parts of a capacity drive whose predicted_ms come from the QN
# (within a relative 1e-3 in exponential mode); the rest are exact
CAPACITY_QN_PARTS = ("qn", "serve-qn")


def capacity_record() -> list:
    """``CAPACITY_COSTS`` as a dry-run record in the reference's format
    (``launch/dryrun.py``'s keys), plus three rows ``load_dryrun`` skips:
    the multi-pod mesh, an unsupported cell and a failed one."""
    recs = [{"arch": arch, "shape": shape, "mesh": "16x16",
             "supported": True, "n_devices": 256,
             "cost_analysis": {"flops": fl, "bytes_accessed": nb},
             "collective_bytes": {"all-reduce": coll * 0.75,
                                  "all-gather": coll * 0.25}}
            for (arch, shape), (fl, nb, coll) in CAPACITY_COSTS.items()]
    recs.append({**recs[0], "mesh": "2x16x16", "n_devices": 512})
    recs.append({"arch": "granite-3-2b", "shape": "long_500k",
                 "mesh": "16x16", "supported": False})
    recs.append({"arch": "gemma3-27b", "shape": "train_4k", "mesh": "16x16",
                 "supported": True, "error": "compile failed"})
    return recs


def capacity(device=None) -> dict:
    """The TPU capacity planner (``core/capacity``) on the synthetic costs:
    each serving class's slots and its plan in both modes (the KKT
    ranking alone, then QN-verified, with the QN dispatches of each), the
    training plans, and on the synthetic record (in a temporary file)
    ``load_dryrun``'s costs, ``ElasticPlan.replan_capacity`` and the
    ``plan`` CLI's output.  ``walls`` holds each plan's host seconds
    (ending in a synchronize)."""
    import contextlib
    import io
    import os
    import tempfile

    from repro_torch.core.capacity import CellCost, ServingClass, \
        TPUCapacityPlanner, TrainClass, load_dryrun
    from repro_torch.distributed.fault import ElasticPlan
    from repro_torch.launch import plan as plan_cli

    dev = resolve_device(device)
    planner = TPUCapacityPlanner(
        {k: CellCost(*v) for k, v in CAPACITY_COSTS.items()}, device=dev)
    out = {"slots": {}, "serving": {}, "training": {}}
    walls = {}
    for spec in CAPACITY_SERVING:
        cls = ServingClass(*spec)
        out["slots"][cls.name] = {
            vm.name: vm.cores for vm in planner.serving_problem(cls).vm_types}
        out["serving"][cls.name] = {}
        for mode, use_qn in (("kkt", False), ("qn", True)):
            d0 = _dispatches()
            t0 = time.perf_counter()
            sol = planner.plan_serving([cls], use_qn=use_qn)[cls.name]
            _sync(dev)
            walls[f"{cls.name}.{mode}"] = time.perf_counter() - t0
            out["serving"][cls.name][mode] = {
                **_decisions(sol), "dispatches": _dispatches() - d0}
    for name, arch, steps, deadline_h in CAPACITY_TRAINING:
        sol = planner.plan_training([TrainClass(
            name=name, arch=arch, steps=steps, deadline_h=deadline_h)])[name]
        out["training"][name] = _decisions(sol)
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
        out["replan"] = {k: _decisions(v) for k, v in ElasticPlan.
                         replan_capacity(arch, steps, deadline_h,
                                         dryrun_path=record_path,
                                         device=dev).items()}
        out["cli"] = {}
        for label, argv in CAPACITY_CLI.items():
            buf = io.StringIO()
            d0 = _dispatches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                plan_cli.main([*argv, "--dryrun", record_path,
                               "--device", str(dev)])
            _sync(dev)
            walls[f"cli.{label}"] = time.perf_counter() - t0
            out["cli"][label] = {"printed": json.loads(buf.getvalue()),
                                 "dispatches": _dispatches() - d0}
    out["walls"] = walls
    return out


def capacity_mismatches(ref: dict, got: dict, *, rel: float = 1e-3) -> list:
    """``mismatches`` of a capacity drive: every number exact but the
    predicted_ms of a QN-verified plan (``CAPACITY_QN_PARTS``), within
    ``rel``."""
    out = []
    for key, want in ref.items():
        have = got.get(key)
        if key in ("serving", "cli") and isinstance(have, dict):
            for name, part in want.items():
                parts = part.items() if key == "serving" else [(name, part)]
                for mode, w in parts:
                    h = have.get(name, {})
                    h = h.get(mode) if key == "serving" else h
                    r = rel if mode in CAPACITY_QN_PARTS else 0.0
                    path = f"{key}.{name}" + (f".{mode}" if key == "serving"
                                              else "")
                    out += [f"{path}.{p}" for p in mismatches(w, h, rel=r)]
        else:
            out += [f"{key}.{p}" for p in mismatches(want, have)]
    return out


# ------------------------------------------------------------- comparison

def mismatches(ref, got, *, rel: float = 0.0) -> list:
    """Paths at which ``got`` differs from ``ref``: every key of a ``ref``
    dict must be in ``got`` (``got`` may hold more), lists must have equal
    lengths, and values must be equal, except numbers under a
    ``predicted_ms`` key (response times), which may differ by ``rel``
    relative to ``ref``'s."""
    out = []

    def walk(a, b, path, tol):
        if isinstance(a, dict):
            if not isinstance(b, dict):
                out.append(path or ".")
                return
            for k, v in a.items():
                p = f"{path}.{k}" if path else str(k)
                if k in b:
                    walk(v, b[k], p, tol or k == "predicted_ms")
                else:
                    out.append(p)
        elif isinstance(a, (list, tuple)):
            if not isinstance(b, (list, tuple)) or len(a) != len(b):
                out.append(path)
                return
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]", tol)
        elif isinstance(a, (bool, str)) or a is None \
                or isinstance(b, bool):
            if not (a == b and type(a) is type(b)):
                out.append(path)
        elif tol and rel and isinstance(b, (int, float)) \
                and np.isfinite(a):
            if not abs(b - a) <= rel * abs(a):
                out.append(path)
        elif b != a:
            out.append(path)

    walk(ref, got, "", False)
    return out


SCENARIOS = {"batched_qn": batched_qn, "cost_deadline": cost_deadline,
             "hc_convergence": hc_convergence, "vm_race": vm_race,
             "table3": table3, "serving_qn": serving_qn,
             "dag_sweep": dag_sweep, "spark_dag_plan": spark_dag_plan,
             "service_throughput": service_throughput,
             "serve_many": serve_many,
             "spark_dag_service": spark_dag_service,
             "q1_tenants": q1_tenants, "private_cloud": private_cloud,
             "capacity": capacity}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    for name in argv or list(SCENARIOS):
        t0 = time.perf_counter()
        res = SCENARIOS[name](device)
        print(json.dumps({name: res, "wall_s": time.perf_counter() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
