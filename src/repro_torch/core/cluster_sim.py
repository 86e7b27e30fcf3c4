"""Detailed YARN-cluster simulator — the "measured system" of this repro.

The paper validates its QN model against real Hadoop deployments (EC2 /
CINECA).  This container is CPU-only, so the ground-truth role is played by
a *trace-replay discrete-event simulator* that is deliberately richer than
the QN abstraction:

  * empirical (lognormal, configurable CV) task durations instead of
    exponential — replayed per task like the JMT replayer fed with log data;
  * container startup overhead per task;
  * first-wave shuffle penalty on the first ``slots`` reduce tasks of a job
    (the paper's S1 vs S_typ distinction);
  * straggler tail: a small fraction of tasks run a multiple of their
    nominal duration (the classic heavy-tail observed in Hadoop logs);
  * exact Capacity-Scheduler semantics: FIFO within queue, Reduce tasks
    prioritized over queued Maps, work-conserving container release.

The gap between this simulator and the QN model is therefore honest
modelling error of the same nature the paper reports (avg ~12%, max ~31%).

Profiles (JobProfile) are extracted from this simulator's logs exactly the
way the paper extracts them from Hadoop logs (profiling runs, then parse).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.problem import JobProfile


@dataclass(frozen=True)
class WorkloadSpec:
    """Ground-truth behaviour of one query class on a reference VM type."""
    name: str
    n_map: int
    n_reduce: int
    map_ms: float                 # median map duration on the reference VM
    reduce_ms: float
    cv: float = 0.35              # lognormal coefficient of variation
    startup_ms: float = 150.0     # container startup overhead
    shuffle_first_ms: float = 0.0 # extra first-wave shuffle latency
    straggler_p: float = 0.02
    straggler_mult: float = 2.5


def _lognormal(rng: np.random.Generator, median: float, cv: float,
               size: int) -> np.ndarray:
    sigma = math.sqrt(math.log(1.0 + cv * cv))
    return rng.lognormal(math.log(max(median, 1e-9)), sigma, size)


def sample_task_durations(spec: WorkloadSpec, rng: np.random.Generator,
                          speed: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Draw one job's map/reduce task durations (ms) on a VM with ``speed``."""
    m = _lognormal(rng, spec.map_ms / speed, spec.cv, spec.n_map)
    r = _lognormal(rng, spec.reduce_ms / speed, spec.cv, spec.n_reduce)
    strag_m = rng.random(spec.n_map) < spec.straggler_p
    strag_r = rng.random(spec.n_reduce) < spec.straggler_p
    m = np.where(strag_m, m * spec.straggler_mult, m)
    r = np.where(strag_r, r * spec.straggler_mult, r)
    m = m + spec.startup_ms / speed
    r = r + spec.startup_ms / speed
    return m, r


@dataclass
class JobRecord:
    user: int
    submit: float
    finish: float = 0.0
    map_durations: Optional[np.ndarray] = None
    reduce_durations: Optional[np.ndarray] = None

    @property
    def response(self) -> float:
        return self.finish - self.submit


def simulate_cluster(
    spec: WorkloadSpec, *, slots: int, h_users: int, think_ms: float,
    speed: float = 1.0, max_jobs: int = 60, warmup_jobs: int = 8,
    seed: int = 0,
) -> Tuple[float, List[JobRecord]]:
    """Event-driven exact simulation.  Returns (mean response, job records).

    Single class on a dedicated partition (the paper's node-label static
    split); multi-class work-conserving mode is exercised by the planner via
    per-class partitions, matching the conservative interpretation in §2.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    free = slots
    # queues: reduce has absolute priority; FIFO inside each
    map_q: List[Tuple[float, int, int]] = []      # (arrival, job_id, task_idx)
    red_q: List[Tuple[float, int, int]] = []
    events: List[Tuple[float, int, int, int]] = []  # (time, kind, job, task)
    # kind: 0 task-complete(map), 1 task-complete(reduce), 2 think-end
    jobs: List[JobRecord] = []
    remaining: Dict[int, List[int]] = {}          # job -> [maps left, reds left]
    responses: List[float] = []

    for u in range(h_users):
        heapq.heappush(events, (rng.exponential(think_ms), 2, u, 0))

    def submit(user: int, now: float) -> int:
        jid = len(jobs)
        m, r = sample_task_durations(spec, rng, speed)
        # first-wave shuffle: the first min(slots, n_reduce) reduce tasks
        nfw = min(slots, spec.n_reduce)
        r = r.copy()
        r[:nfw] += spec.shuffle_first_ms / speed
        jobs.append(JobRecord(user=user, submit=now, map_durations=m,
                              reduce_durations=r))
        remaining[jid] = [spec.n_map, spec.n_reduce]
        for i in range(spec.n_map):
            map_q.append((now, jid, i))
        return jid

    def dispatch(now: float):
        nonlocal free
        while free > 0 and (red_q or map_q):
            if red_q:                              # reduce priority
                arr, jid, tid = red_q.pop(0)
                dur, kind = jobs[jid].reduce_durations[tid], 1
            else:
                arr, jid, tid = map_q.pop(0)
                dur, kind = jobs[jid].map_durations[tid], 0
            heapq.heappush(events, (now + dur, kind, jid, tid))
            free -= 1

    done_jobs = 0
    while events and done_jobs < max_jobs + warmup_jobs:
        t, kind, a, b = heapq.heappop(events)
        if kind == 2:                              # think end -> submit
            submit(a, t)
            dispatch(t)
            continue
        free += 1
        jid = a
        if kind == 0:                              # map task done
            remaining[jid][0] -= 1
            if remaining[jid][0] == 0:             # join; fork reduces
                for i in range(spec.n_reduce):
                    red_q.append((t, jid, i))
        else:                                      # reduce task done
            remaining[jid][1] -= 1
            if remaining[jid][1] == 0:             # job completes
                jobs[jid].finish = t
                done_jobs += 1
                if done_jobs > warmup_jobs:
                    responses.append(jobs[jid].response)
                heapq.heappush(
                    events, (t + rng.exponential(think_ms), 2,
                             jobs[jid].user, 0))
        dispatch(t)

    mean = float(np.mean(responses)) if responses else float("inf")
    return mean, [j for j in jobs if j.finish > 0]


# --------------------------------------------------------------------------
# Profiling — the paper's log-parsing step
# --------------------------------------------------------------------------

def profile_from_runs(spec: WorkloadSpec, *, speed: float = 1.0,
                      runs: int = 20, slots: int = 240,
                      seed: int = 100) -> JobProfile:
    """Run ``runs`` dedicated single-user jobs and parse the 'logs' into a
    JobProfile (avg/max task durations, task counts) — §4.1 methodology."""
    m_all, r_all = [], []
    rng = np.random.default_rng(seed)
    for i in range(runs):
        m, r = sample_task_durations(spec, rng, speed)
        nfw = min(slots, spec.n_reduce)
        r = r.copy()
        r[:nfw] += spec.shuffle_first_ms / speed
        m_all.append(m)
        r_all.append(r)
    m_cat = np.concatenate(m_all)
    r_cat = np.concatenate(r_all)
    return JobProfile(
        n_map=spec.n_map, n_reduce=spec.n_reduce,
        m_avg=float(m_cat.mean()), m_max=float(m_cat.max()),
        r_avg=float(r_cat.mean()), r_max=float(r_cat.max()),
        s1_avg=0.0, s1_max=0.0,
    )


def replayer_lists(spec: WorkloadSpec, *, speed: float = 1.0,
                   runs: int = 20, slots: int = 240, seed: int = 100,
                   cap: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """Task-duration lists for the QN replayer (paper §4.1: 'lists of task
    execution times to feed into the replayer in JMT service centers')."""
    rng_sub = np.random.default_rng(seed + 1)
    m_all, r_all = [], []
    rng = np.random.default_rng(seed)
    for _ in range(runs):
        m, r = sample_task_durations(spec, rng, speed)
        nfw = min(slots, spec.n_reduce)
        r = r.copy()
        r[:nfw] += spec.shuffle_first_ms / speed
        m_all.append(m)
        r_all.append(r)
    m_cat = np.concatenate(m_all)
    r_cat = np.concatenate(r_all)
    if len(m_cat) > cap:
        m_cat = rng_sub.choice(m_cat, cap, replace=False)
    if len(r_cat) > cap:
        r_cat = rng_sub.choice(r_cat, cap, replace=False)
    return m_cat.astype(np.float32), r_cat.astype(np.float32)
