"""DAG workloads (the paper's §6 future work: Tez or Spark jobs) on
PyTorch: the port of the reference's ``repro/core/dag.py``.

A job is a CHAIN of fork-join stages (``workload.DagJob``): stage k forks
into n_k tasks that share the slots with every other stage and user;
deeper stages dispatch first (the paper's class switch), FIFO within a
depth.  Three tiers, with the reference's names and signatures:

  * ``dag_demand`` / ``dag_response_analytic`` -- the ARIA-style (A, B)
    demand and its processor-sharing response (``mva``);
  * ``dag_response_time`` -- the K-stage event simulation, one dispatch of
    ``kernels.dag_event`` per replication; ``response_time_batch`` is its
    fused batched gait (a whole candidate sweep per dispatch, each lane
    bit-identical to the scalar call);
  * ``simulate_dag_cluster`` -- the detailed ground truth, numpy on the
    host, a copy of the reference's (equal bit for bit).

Every simulator dispatch is counted in ``qn_sim``'s counters, as the
reference counts it.  Entry points run on the current CUDA device unless
given ``device=``; CPU tensors take the kernels' plain versions.
"""
from __future__ import annotations

import heapq
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import qn_sim
from repro_torch.core import shapes as _shapes
from repro_torch.core.mva import ps_response, workload_demand
from repro_torch.core.workload import DagJob, Stage
from repro_torch.kernels.dag_event import ops as dag_ops
from repro_torch.obs import trace as _obs_trace

__all__ = [
    "DagJob", "Stage", "dag_demand", "dag_response_analytic",
    "dag_response_time", "response_time_batch", "dag_replayer_lists",
    "dag_events_needed", "padded_event_budget", "simulate_dag_cluster",
]


# --------------------------------------------------------------------------
# Analytic tier
# --------------------------------------------------------------------------

def dag_demand(job: DagJob) -> Tuple[float, float]:
    """ARIA-style (A, B): T_est(c) = A/c + B summed over the stage chain
    (delegates to the generic ``mva.workload_demand``)."""
    return workload_demand(job)


def dag_response_analytic(job: DagJob, slots: int, think: float,
                          h_users: int) -> float:
    a, b = dag_demand(job)
    return ps_response(a / slots, b, think, h_users)


# --------------------------------------------------------------------------
# Event simulator: budgets and replay lists
# --------------------------------------------------------------------------

def dag_replayer_lists(job: DagJob, runs: int = 20, seed: int = 100,
                       cap: int = 1024) -> np.ndarray:
    """(K, cap) per-stage empirical duration samples (profiling runs)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(job.stages), cap), np.float32)
    for k, s in enumerate(job.stages):
        sigma = math.sqrt(math.log(1 + s.cv ** 2))
        draws = rng.lognormal(math.log(s.t_avg), sigma,
                              max(cap, runs * s.n_tasks))
        out[k] = rng.choice(draws, cap, replace=False)
    return out


def dag_events_needed(job: DagJob, min_jobs: int = 40,
                      warmup_jobs: int = 8) -> int:
    """Event-budget heuristic (the DAG analogue of
    ``qn_sim.events_needed``): ~2 events per task (dispatch + completion)
    + 4 per job, times jobs, padded 1.5x."""
    per_job = 2 * sum(s.n_tasks for s in job.stages) + 4
    return int(1.5 * per_job * (min_jobs + warmup_jobs))


def padded_event_budget(job: DagJob, *, min_jobs: int = 40,
                        warmup_jobs: int = 8) -> int:
    """The pow2-bucketed logical event budget of one (candidate,
    replication) lane of this chain -- what ``dag_response_time`` and
    ``response_time_batch`` scan for it; also its think-draw fold
    offset."""
    return _shapes.pow2(dag_events_needed(job, min_jobs, warmup_jobs))


def _stage_arrays(jobs: Sequence[DagJob], K: int):
    """``(C, K)`` task counts and means, zero past each chain's length."""
    nt = np.zeros((len(jobs), K), np.int32)
    ta = np.zeros((len(jobs), K), np.float32)
    for c, job in enumerate(jobs):
        nt[c, :len(job.stages)] = [s.n_tasks for s in job.stages]
        ta[c, :len(job.stages)] = [s.t_avg for s in job.stages]
    return nt, ta


def _samples(samples, dev):
    if samples is None:
        return None
    return torch.as_tensor(np.asarray(samples, np.float32), device=dev)


def dag_response_time(job: DagJob, slots: int, think_ms: float,
                      h_users: int, min_jobs: int = 40,
                      warmup_jobs: int = 8, seed: int = 0,
                      replications: int = 2, samples=None,
                      device=None) -> float:
    """Mean response time of the closed K-stage chain QN: one dispatch of
    ``kernels.dag_event`` per replication (seeded ``seed + 1000*r``) at
    the chain's padded budget and the bucketed slots, the parity oracle of
    ``response_time_batch``.  ``samples`` (K, NS) switches to replay
    mode."""
    dev = resolve_device(device)
    n_events = padded_event_budget(job, min_jobs=min_jobs,
                                   warmup_jobs=warmup_jobs)
    K = len(job.stages)
    nt, ta = _stage_arrays([job], K)
    smp = _samples(samples, dev)

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(dev)

    i32, f32 = torch.int32, torch.float32
    lane = (t(nt, i32), t(ta, f32), t([K], i32), t([think_ms], f32),
            t([slots], i32))
    outs = []
    for r in range(replications):
        qn_sim._count_dispatch(events_total=n_events,
                               events_useful=n_events)
        outs.append(torch.cat(dag_ops.sim_batch(
            *lane, t([seed + 1000 * r], torch.int64), t([n_events], i32),
            smp, h_users=int(h_users),
            max_slots=_shapes.bucket_slots(slots), n_events=n_events,
            warmup_jobs=warmup_jobs, depth=K)))
    if not outs:
        return qn_sim._combine([], [])[0]
    res = torch.stack(outs).cpu().numpy()      # one read for all of them
    return qn_sim._combine(res[:, 0], res[:, 1])[0]


def response_time_batch(jobs: Sequence[DagJob], think_ms, slots,
                        h_users: int, min_jobs: int = 40,
                        warmup_jobs: int = 8, seed: int = 0,
                        replications: int = 2, samples=None,
                        defer: bool = False, device=None):
    """Batched ``dag_response_time``: ONE fused dispatch (the draw tables,
    then the event loop) for a whole candidate sweep of DAG
    configurations.  ``jobs`` is one ``DagJob`` per point (chains of
    different length are padded to the bucketed batch-maximum K, each lane
    carrying its true stage count); ``think_ms``/``slots`` broadcast over
    the C points; ``h_users`` is one int for the batch.  Each lane keeps
    its own budget, seed and stage count, so every point equals a scalar
    ``dag_response_time`` call bit for bit.  ``samples`` (K, NS) switches
    the batch to replay mode; its jobs must then share one stage count
    (``ValueError`` otherwise).  Lanes, slots and stages are bucketed as in
    the reference and the padding counted in ``qn_sim.padding_stats``.
    Returns a float64 ``(C,)`` array (``inf`` where no replication
    completed a job), or with ``defer=True`` a ``qn_sim.PendingBatch``."""
    dev = resolve_device(device)
    jobs = list(jobs)
    C = len(jobs)
    if C == 0:
        empty = np.zeros((0,), np.float64)
        return qn_sim.PendingBatch.resolved(empty) if defer else empty

    def _b(x, dt):
        return np.broadcast_to(np.asarray(x, dt), (C,)).copy()

    tk = _b(think_ms, np.float32)
    sl = _b(slots, np.int64)
    ks = [len(j.stages) for j in jobs]
    if samples is not None and len(set(ks)) != 1:
        raise ValueError("replay-mode DAG batches must share a stage count")
    # each lane clips its stage indices to its own count, so the padded
    # stages are unreachable
    nt, ta = _stage_arrays(jobs, _shapes.bucket_stages(max(ks)))
    ns = np.asarray(ks, np.int32)
    n_ev = np.asarray([padded_event_budget(j, min_jobs=min_jobs,
                                           warmup_jobs=warmup_jobs)
                       for j in jobs], np.int64)
    scan_len = int(n_ev.max())
    max_slots = _shapes.bucket_slots(int(sl.max()))
    (nt, ta, ns, tk, sl, n_ev), seeds, shards = qn_sim.fused_lanes(
        (nt, ta, ns, tk, sl, n_ev), n_ev, replications=replications,
        seed=seed)
    smp = _samples(samples, dev)

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(dev)

    i32, f32 = torch.int32, torch.float32
    with _obs_trace.span("kernel:dag", cat="kernel", lanes=len(seeds),
                         candidates=C, scan_len=scan_len,
                         max_slots=max_slots, h_users=int(h_users),
                         stages=nt.shape[1], replay=smp is not None,
                         devices=shards, shard_lanes=len(seeds) // shards):
        mean, cnt = dag_ops.sim_batch(
            t(nt, i32), t(ta, f32), t(ns, i32), t(tk, f32), t(sl, i32),
            t(seeds, torch.int64), t(n_ev, i32), smp, h_users=int(h_users),
            max_slots=max_slots, n_events=scan_len,
            warmup_jobs=warmup_jobs, depth=int(ns.max()))
    pending = qn_sim.PendingBatch(mean, cnt, C, replications)
    return pending if defer else pending.resolve()


# --------------------------------------------------------------------------
# Detailed ground truth
# --------------------------------------------------------------------------

def simulate_dag_cluster(job: DagJob, *, slots: int, h_users: int,
                         think_ms: float, max_jobs: int = 40,
                         warmup_jobs: int = 5, seed: int = 0) -> float:
    """Trace replay of the chain on a cluster of ``slots`` containers:
    lognormal task durations (``Stage.cv``), deeper stages first, FIFO
    within a stage; the mean response time over ``max_jobs`` jobs past the
    warm-up."""
    rng = np.random.default_rng(seed)
    K = len(job.stages)
    free = slots
    queues: List[List[Tuple[float, int, float]]] = [[] for _ in range(K)]
    events: List[Tuple[float, int, int, int]] = []  # (t, kind, job, stage)
    state = {}                                      # jid -> [stage, remaining]
    submit_t = {}
    responses: List[float] = []
    next_jid = [0]

    def draw(stage: Stage) -> float:
        sigma = math.sqrt(math.log(1 + stage.cv ** 2))
        return float(rng.lognormal(math.log(stage.t_avg), sigma))

    def fork(jid: int, k: int, now: float):
        state[jid] = [k, job.stages[k].n_tasks]
        for _ in range(job.stages[k].n_tasks):
            queues[k].append((now, jid, draw(job.stages[k])))

    def dispatch(now: float):
        nonlocal free
        while free > 0:
            for k in reversed(range(K)):            # deeper stages first
                if queues[k]:
                    arr, jid, dur = queues[k].pop(0)
                    heapq.heappush(events, (now + dur, 1, jid, k))
                    free -= 1
                    break
            else:
                return

    for u in range(h_users):
        heapq.heappush(events, (rng.exponential(think_ms), 0, u, 0))

    done = 0
    while events and done < max_jobs + warmup_jobs:
        t, kind, a, k = heapq.heappop(events)
        if kind == 0:                               # submit
            jid = next_jid[0]
            next_jid[0] += 1
            submit_t[jid] = t
            fork(jid, 0, t)
            dispatch(t)
            continue
        free += 1
        jid = a
        state[jid][1] -= 1
        if state[jid][1] == 0:
            if state[jid][0] + 1 < K:
                fork(jid, state[jid][0] + 1, t)
            else:
                done += 1
                if done > warmup_jobs:
                    responses.append(t - submit_t[jid])
                heapq.heappush(
                    events, (t + rng.exponential(think_ms), 0, 0, 0))
        dispatch(t)

    return float(np.mean(responses)) if responses else float("inf")
