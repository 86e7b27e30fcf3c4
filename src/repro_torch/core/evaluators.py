"""Response-time evaluators of the port, at the reference's tiers:

  * ``amva_frontier`` — the batched AMVA frontier on ``kernels/amva``;
  * ``make_qn_evaluator`` — the paper's point-wise QN tier, one scalar
    simulation per probe (``qn_sim.response_time``, or for a DAG profile
    ``dag.dag_response_time``);
  * ``BatchedQNEvaluator`` — the batched QN tier, whole candidate sweeps
    per fused dispatch, routed by workload kind (``fused_eval_call``):
    MapReduce groups to ``kernels/qn_event``, DAG groups to
    ``kernels/dag_event``.

Caches are content-addressed exactly as in the reference: keys are
``(profile_hash, vm_name, nu, seed)`` with the same ``profile_hash``, for
both QN evaluators, so one cache serves both gaits and a cache filled by
the reference can feed the port (``core.interop``).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import dag as dag_mod
from repro_torch.core import partition as _partition
from repro_torch.core import qn_sim
from repro_torch.core.mva import workload_demand
from repro_torch.core.problem import ApplicationClass, VMType
from repro_torch.core.workload import (
    DAG,
    profile_hash,
    samples_digest,
    workload_kind,
)
from repro_torch.kernels.amva import ops as amva_ops
from repro_torch.obs import trace as _obs_trace


class _ContextDigests:
    """Per-(class, vm) evaluation-context digests, memoizing the replay
    sample digest (lists can be thousands of floats); the profile part is
    rehashed per call so same-named classes with different profiles get
    different keys."""

    def __init__(self, samples: Optional[Dict], *, min_jobs: int,
                 warmup_jobs: int, replications: int):
        self.samples = samples or {}
        self.sim = dict(min_jobs=min_jobs, warmup_jobs=warmup_jobs,
                        replications=replications)
        self._sdig: Dict[tuple, str] = {}

    def replay_for(self, cls: ApplicationClass, vm: VMType):
        return self.samples.get((cls.name, vm.name))

    def sample_digest(self, cls: ApplicationClass, vm: VMType) -> str:
        k = (cls.name, vm.name)
        if k not in self._sdig:
            self._sdig[k] = samples_digest(self.samples.get(k))
        return self._sdig[k]

    def digest(self, prof, cls: ApplicationClass, vm: VMType) -> str:
        return profile_hash(prof, cls.think_ms, cls.h_users, vm.slots,
                            samples_dig=self.sample_digest(cls, vm),
                            **self.sim)


def make_qn_evaluator(min_jobs: int = 40, warmup_jobs: int = 8,
                      replications: int = 2, seed: int = 0,
                      cache: Optional[dict] = None,
                      samples: Optional[Dict] = None,
                      device=None) -> Callable:
    """The point-wise QN evaluator: ``evaluate(cls, vm, nu)`` runs one
    scalar simulation (one ``qn_event`` dispatch per replication) on
    ``device``, which is resolved here, once, so that calls from worker
    threads use it too.  ``samples`` maps ``(class_name, vm_name)`` to
    replay lists (JMT replayer mode): ``(m_list, r_list)`` for a
    MapReduce class, a per-stage ``(K, NS)`` array for a DAG class.  The
    cache key is the batched evaluator's, so the two gaits share one
    cache."""
    dev = resolve_device(device)
    cache = cache if cache is not None else {}
    ctx = _ContextDigests(samples, min_jobs=min_jobs,
                          warmup_jobs=warmup_jobs, replications=replications)

    def evaluate(cls: ApplicationClass, vm: VMType, nu: int) -> float:
        prof = cls.profile_for(vm)
        key = (ctx.digest(prof, cls, vm), vm.name, int(nu), seed)
        if key in cache:
            return cache[key]
        smp = ctx.replay_for(cls, vm)
        if workload_kind(prof) == DAG:
            t = dag_mod.dag_response_time(
                prof, slots=nu * vm.slots, think_ms=cls.think_ms,
                h_users=cls.h_users, min_jobs=min_jobs,
                warmup_jobs=warmup_jobs, seed=seed,
                replications=replications, samples=smp, device=dev)
        else:
            ms, rs = smp if smp is not None else (None, None)
            t = qn_sim.response_time(
                n_map=prof.n_map, n_reduce=prof.n_reduce,
                m_avg=prof.m_avg, r_avg=prof.r_avg,
                think_ms=cls.think_ms, h_users=cls.h_users,
                slots=nu * vm.slots, min_jobs=min_jobs,
                warmup_jobs=warmup_jobs, seed=seed,
                replications=replications, m_samples=ms, r_samples=rs,
                device=dev)
        cache[key] = t
        return t
    return evaluate


def fused_qn_call(profs: Sequence["object"], think_ms: Sequence[float],
                  h_users: int, slots: Sequence[int], *,
                  min_jobs: int = 40, warmup_jobs: int = 8,
                  replications: int = 2, seed: int = 0,
                  m_samples=None, r_samples=None, device=None,
                  defer: bool = False):
    """ONE fused simulator dispatch over the points of a fusion group
    (shared ``h_users``, replay lists and simulation parameters); each
    lane keeps its own logical budget and seed.  ``defer=True`` returns a
    ``qn_sim.PendingBatch``."""
    return qn_sim.response_time_batch(
        n_map=np.asarray([p.n_map for p in profs], np.int64),
        n_reduce=np.asarray([p.n_reduce for p in profs], np.int64),
        m_avg=np.asarray([p.m_avg for p in profs], np.float32),
        r_avg=np.asarray([p.r_avg for p in profs], np.float32),
        think_ms=np.asarray(think_ms, np.float32),
        h_users=int(h_users),
        slots=np.asarray(slots, np.int64),
        min_jobs=min_jobs, warmup_jobs=warmup_jobs,
        seed=seed, replications=replications,
        m_samples=m_samples, r_samples=r_samples, device=device,
        defer=defer)


def fused_dag_call(jobs: Sequence["object"], think_ms: Sequence[float],
                   h_users: int, slots: Sequence[int], *,
                   min_jobs: int = 40, warmup_jobs: int = 8,
                   replications: int = 2, seed: int = 0,
                   samples=None, device=None, defer: bool = False):
    """DAG counterpart of ``fused_qn_call``: one fused dispatch of
    ``dag.response_time_batch`` over the chain configurations of a fusion
    group (chains of different length pad to the batch-maximum stage
    count).  Each lane equals a scalar ``dag_response_time`` call."""
    return dag_mod.response_time_batch(
        jobs, think_ms=np.asarray(think_ms, np.float32),
        slots=np.asarray(slots, np.int64), h_users=int(h_users),
        min_jobs=min_jobs, warmup_jobs=warmup_jobs, seed=seed,
        replications=replications, samples=samples, defer=defer,
        device=device)


def fused_eval_call(kind: str, profs: Sequence["object"],
                    think_ms: Sequence[float], h_users: int,
                    slots: Sequence[int], *, min_jobs: int = 40,
                    warmup_jobs: int = 8, replications: int = 2,
                    seed: int = 0, samples=None, device=None,
                    defer: bool = False):
    """Workload dispatch of a fusion group: MapReduce windows go to
    ``fused_qn_call``, DAG windows to ``fused_dag_call``.  ``samples`` is
    the group's replay payload in the kind's own form (an ``(m_list,
    r_list)`` pair, or a ``(K, NS)`` array)."""
    kw = dict(min_jobs=min_jobs, warmup_jobs=warmup_jobs,
              replications=replications, seed=seed, device=device,
              defer=defer)
    with _obs_trace.span("fused_dispatch", cat="fusion", kind=kind,
                         points=len(profs), h_users=int(h_users),
                         replay=samples is not None,
                         devices=_partition.shard_count(len(profs))):
        if kind == DAG:
            return fused_dag_call(profs, think_ms, h_users, slots,
                                  samples=samples, **kw)
        ms, rs = samples if samples is not None else (None, None)
        return fused_qn_call(profs, think_ms, h_users, slots,
                             m_samples=ms, r_samples=rs, **kw)


class BatchedQNEvaluator:
    """QN-tier evaluator that evaluates whole candidate sweeps per fused
    dispatch: cached points are gathered from the shared dict cache, the
    misses of each fusion group (workload kind, ``h_users``, replay lists)
    go to the device in one call, and every result lands in the cache
    under the reference's ``(profile_hash, vm, nu, seed)`` keys.

    Counters: ``device_calls`` fused dispatches made,
    ``points_evaluated`` simulator configurations they covered."""

    def __init__(self, min_jobs: int = 40, warmup_jobs: int = 8,
                 replications: int = 2, seed: int = 0,
                 cache: Optional[dict] = None,
                 samples: Optional[Dict] = None, device=None):
        self.device = resolve_device(device)
        self.min_jobs = min_jobs
        self.warmup_jobs = warmup_jobs
        self.replications = replications
        self.seed = seed
        self.cache = cache if cache is not None else {}
        self.samples = samples or {}
        self._ctx = _ContextDigests(self.samples, min_jobs=min_jobs,
                                    warmup_jobs=warmup_jobs,
                                    replications=replications)
        self.device_calls = 0
        self.points_evaluated = 0
        self._counter_lock = threading.Lock()

    def evaluate_frontier(self, cls: ApplicationClass, vm: VMType,
                          nus: Sequence[int]) -> np.ndarray:
        """Response time for every nu in ``nus`` (one dispatch for all
        cache misses)."""
        return np.asarray(
            self.evaluate_many((cls, vm, int(n)) for n in nus))

    def evaluate_many(
        self, items: Iterable[Tuple[ApplicationClass, VMType, int]],
    ) -> List[float]:
        """Evaluate arbitrary (class, vm, nu) points with one dispatch per
        fusion group and one host sync for the whole round.  Returns times
        aligned with ``items``."""
        items = list(items)
        keys: List[tuple] = []
        profs: List[object] = []
        todo: Dict[tuple, list] = {}
        seen = set()
        for idx, (cls, vm, nu) in enumerate(items):
            prof = cls.profile_for(vm)
            profs.append(prof)
            key = (self._ctx.digest(prof, cls, vm), vm.name, int(nu),
                   self.seed)
            keys.append(key)
            if key in self.cache or key in seen:
                continue
            seen.add(key)
            replay = (cls.name, vm.name) if (cls.name, vm.name) \
                in self.samples else None
            kind = workload_kind(prof)
            group_key = (kind, cls.h_users, replay)
            if kind == DAG and replay is not None:
                # replay lanes share one (K, NS) sample array, so a replay
                # group must agree on the stage count
                group_key += (len(prof.stages),)
            todo.setdefault(group_key, []).append(idx)
        # dispatch every group first, then read all results in one sync
        inflight: List[Tuple[list, "qn_sim.PendingBatch"]] = []
        for group_key, idxs in todo.items():
            kind, h_users, replay = group_key[:3]
            smp = self.samples[replay] if replay is not None else None
            pending = fused_eval_call(
                kind, [profs[i] for i in idxs],
                [items[i][0].think_ms for i in idxs],
                h_users,
                [int(items[i][2]) * items[i][1].slots for i in idxs],
                min_jobs=self.min_jobs, warmup_jobs=self.warmup_jobs,
                seed=self.seed, replications=self.replications,
                samples=smp, device=self.device, defer=True)
            inflight.append((idxs, pending))
            with self._counter_lock:
                self.device_calls += 1
                self.points_evaluated += len(idxs)
        if inflight:
            results = qn_sim.resolve_batches(p for _, p in inflight)
            for (idxs, _), ts in zip(inflight, results):
                for i, t in zip(idxs, ts):
                    self.cache[keys[i]] = float(t)
        return [self.cache[k] for k in keys]

    def __call__(self, cls: ApplicationClass, vm: VMType, nu: int) -> float:
        return float(self.evaluate_frontier(cls, vm, [nu])[0])


def make_batched_qn_evaluator(min_jobs: int = 40, warmup_jobs: int = 8,
                              replications: int = 2, seed: int = 0,
                              cache: Optional[dict] = None,
                              samples: Optional[Dict] = None,
                              device=None) -> BatchedQNEvaluator:
    return BatchedQNEvaluator(min_jobs=min_jobs, warmup_jobs=warmup_jobs,
                              replications=replications, seed=seed,
                              cache=cache, samples=samples, device=device)


def workload_event_budget(prof, *, min_jobs: int,
                          warmup_jobs: int) -> int:
    """Pow2-bucketed logical event budget of one (candidate, replication)
    simulator lane for any workload kind (the unit admission control
    prices jobs in).  Budgets depend only on the task counts and job
    quota, never on the candidate nu."""
    if workload_kind(prof) == DAG:
        return dag_mod.padded_event_budget(prof, min_jobs=min_jobs,
                                           warmup_jobs=warmup_jobs)
    return qn_sim.padded_event_budget(prof.n_map, prof.n_reduce,
                                      min_jobs=min_jobs,
                                      warmup_jobs=warmup_jobs)


def amva_frontier(cls: ApplicationClass, vm: VMType, nu_lo: int, nu_hi: int,
                  device=None) -> np.ndarray:
    """Analytic T for every nu in [nu_lo, nu_hi] in ONE ``amva`` kernel
    launch from the frontier's scalars (``amva_ops.ps_frontier``: no copy
    to the card, one read-back; the plain version on the CPU)."""
    dev = resolve_device(device)
    a, b = workload_demand(cls.profile_for(vm))
    n = max(0, nu_hi - nu_lo + 1)
    with _obs_trace.span("kernel:amva", cat="kernel", points=n):
        return amva_ops.ps_frontier(
            a, vm.slots, nu_lo, n, b, cls.think_ms, float(cls.h_users),
            device=dev).cpu().numpy()


def amva_nu_seed(cls: ApplicationClass, vm: VMType, nu0: int,
                 span: int, *, max_nu: int = 8192, device=None) -> int:
    """AMVA-frontier seed for one QN search lane: the smallest nu in a
    window around the analytic proposal ``nu0`` whose frontier response
    time meets the deadline.  The window starts at
    ``[nu0 - span//2, nu0 + span]`` and is re-anchored downward while its
    feasible minimum sits on the lower edge."""
    span = max(2, span)
    lo = max(1, int(nu0) - span // 2)
    hi = min(max_nu, int(nu0) + span)
    while True:
        ts = amva_frontier(cls, vm, lo, hi, device=device)
        feas = np.where(ts <= cls.deadline_ms)[0]
        if len(feas) == 0:
            return hi                       # infeasible window: sweep climbs
        nu_star = lo + int(feas[0])
        if nu_star > lo or lo == 1:
            return nu_star                  # interior (or floor) minimum
        hi = nu_star                        # feasible on the lower edge:
        lo = max(1, hi - span)              # look below, keep the edge
