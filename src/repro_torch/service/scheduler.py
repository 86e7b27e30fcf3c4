"""Cross-job fusion scheduler: shared device dispatches for all tenants.

Each scheduling round, every active job proposes the windows its classes
want next (the resumable ``DSpace4Cloud.run_steps`` protocol).  The
scheduler collects them ALL, resolves what it can from the shared
``EvalCache``, groups the remaining points by *fusion key* — the invariants
one batched simulator program requires all its lanes to share:

    (workload kind, h_users, replay-sample digest, min_jobs, warmup_jobs,
     replications, seed)

(+ the stage count for DAG *replay* groups, whose lanes share one
per-stage sample array) — deduplicates identical points (two tenants
probing the same configuration cost one lane), and issues ONE fused
device call per group
through the same ``fused_eval_call`` marshaling the single-job evaluator
uses, which routes MapReduce groups to ``qn_sim.response_time_batch`` (the
``qn_event`` kernel and its draw tables, ``event_streams``) and DAG groups
to ``dag.response_time_batch`` (``dag_event`` and ``dag_streams``), on the
scheduler's ``device``.  Mixed-tenant rounds (MapReduce
+ Spark/Tez jobs in flight together) therefore still fuse maximally: one
dispatch per kind per group.  Because every lane runs with its own
logical event budget and per-replication seed, and every route of the
event-loop kernels is bit-identical to their plain versions, each point's
estimate is bit-identical to what the job's solo run would have computed
— fusion changes dispatch *timing*, never values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import qn_sim
from repro_torch.core.evaluators import fused_eval_call
from repro_torch.core.hillclimb import request_id
from repro_torch.core.problem import ApplicationClass, VMType
from repro_torch.core.workload import DAG, workload_kind
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.service.cache import CacheKey, EvalCache, profile_hash, \
    samples_digest

_REG = _obs_metrics.registry()
_GROUP_SIZE = _REG.histogram(
    "fusion.group_size", help="points per fused dispatch group",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
_FUSION = {k: _REG.counter(f"fusion.{k}") for k in
           ("groups", "points", "points_dispatched", "points_cached",
            "points_deduped")}


@dataclass(frozen=True)
class SimSpec:
    """Simulation parameters one fused program must agree on (these default
    to the single-job evaluator defaults, so service runs reproduce solo
    runs bit-for-bit)."""
    min_jobs: int = 40
    warmup_jobs: int = 8
    replications: int = 2
    seed: int = 0


@dataclass
class WindowRequest:
    """One job's pending window, annotated with its simulation context.
    Identified by ``rid`` — the (class x VM type) lane of the resumable
    protocol, since a racing job can have several windows of one class in
    flight per round (one per surviving VM-type lane)."""
    job_id: str
    cls: ApplicationClass
    vm: VMType
    nus: List[int]
    spec: SimSpec
    samples: object = None               # replay payload in the workload's
    #                                      native form — (m_list, r_list)
    #                                      or a (K, NS) array — or None
    result: Optional[np.ndarray] = None  # filled by flush(), aligned to nus
    tenant: Optional[str] = None         # accounting identity for labeled
    #                                      metrics (defaults to job_id)

    @property
    def rid(self) -> str:
        return request_id(self.cls.name, self.vm.name)


@dataclass
class FlushReport:
    groups: int = 0                 # fusion groups with >= 1 cache miss
    points: int = 0                 # points requested this flush
    points_dispatched: int = 0      # unique misses sent to the device
    points_cached: int = 0          # served from the shared cache
    points_deduped: int = 0         # duplicate misses folded into one lane
    # per-tenant attribution: job_id -> {"points", "cached", "dispatched",
    # "deduped"}.  The FIRST requester of a missed key is charged the
    # dispatch; same-key requesters in the same round get dedup credit —
    # so summing "dispatched" over jobs equals points_dispatched exactly.
    per_job: Dict[str, Dict[str, int]] = field(default_factory=dict)


class FusionScheduler:
    """Collects ``WindowRequest``s and resolves them in fused batches on
    ``device`` (the current CUDA device by default; ``"cpu"`` runs the
    kernels' plain versions)."""

    def __init__(self, cache: Optional[EvalCache] = None, device=None):
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else EvalCache()
        self._pending: List[WindowRequest] = []
        # (job_id, cls, vm) -> (profile digest, samples digest): invariant
        # per job, so hash once instead of every scheduling round (replay
        # sample lists can be thousands of floats)
        self._digests: Dict[tuple, tuple] = {}
        self.fused_dispatches = 0
        self.points_requested = 0
        self.points_dispatched = 0
        self.last_flush = FlushReport()

    # ------------------------------------------------------------- intake
    def submit(self, req: WindowRequest) -> None:
        self._pending.append(req)
        self.points_requested += len(req.nus)

    def _digest(self, req: WindowRequest) -> tuple:
        """(profile digest, samples digest) shared by every nu of one
        request (nu and seed are separate key components, so one hash pair
        covers the window) — memoized per (job, class, vm)."""
        mkey = (req.job_id, req.cls.name, req.vm.name)
        got = self._digests.get(mkey)
        if got is None:
            sdig = samples_digest(req.samples)
            got = (profile_hash(req.cls.profile_for(req.vm),
                                req.cls.think_ms, req.cls.h_users,
                                req.vm.slots, min_jobs=req.spec.min_jobs,
                                warmup_jobs=req.spec.warmup_jobs,
                                replications=req.spec.replications,
                                samples_dig=sdig), sdig)
            self._digests[mkey] = got
        return got

    def forget_job(self, job_id: str) -> None:
        """Evict the memoized digests of a finished/failed job.  The memo
        is keyed ``(job_id, class, vm)`` and jobs never resume after they
        settle, so a long-lived service that does not evict grows it
        without bound (one entry per class x VM per tenant, forever).
        ``SolverService`` calls this whenever a job leaves the active
        set."""
        for k in [k for k in self._digests if k[0] == job_id]:
            del self._digests[k]

    # -------------------------------------------------------------- flush
    def flush(self) -> List[WindowRequest]:
        """Resolve every pending request: gather cache hits, fuse the
        misses into one device call per fusion group, fill ``req.result``
        for all requests, and return them."""
        pending, self._pending = self._pending, []
        rep = FlushReport()

        # point -> (prof, think, slots) by cache key, grouped by fusion key
        todo: Dict[tuple, Dict[CacheKey, tuple]] = {}
        keys: Dict[int, List[CacheKey]] = {}       # id(req) -> keys per nu
        tenants: Dict[str, str] = {}               # job_id -> tenant label
        for req in pending:
            prof = req.cls.profile_for(req.vm)
            digest, sdig = self._digest(req)
            kind = workload_kind(prof)
            fkey = (kind, req.cls.h_users, sdig, req.spec)
            if kind == DAG and req.samples is not None:
                # replay lanes share one (K, NS) sample array, so a replay
                # group must also agree on the stage count — two tenants
                # reusing one profiling run for different chain lengths
                # must not land in the same program (non-replay DAG lanes
                # pad freely and fuse across chain lengths)
                fkey += (len(prof.stages),)
            keys[id(req)] = kl = []
            tenant = req.tenant or req.job_id
            tenants[req.job_id] = tenant
            tally = rep.per_job.setdefault(
                req.job_id, {"points": 0, "cached": 0, "dispatched": 0,
                             "deduped": 0})
            for nu in req.nus:
                ck: CacheKey = (digest, req.vm.name, int(nu), req.spec.seed)
                kl.append(ck)
                rep.points += 1
                tally["points"] += 1
                if self.cache.lookup(ck, tenant=tenant) is not None:
                    rep.points_cached += 1
                    tally["cached"] += 1
                    continue
                group = todo.setdefault(fkey, {})
                if ck in group:
                    # same-key miss already owned by an earlier requester
                    # this round: fold into its lane, credit the dedup here
                    rep.points_deduped += 1
                    tally["deduped"] += 1
                else:
                    group[ck] = (prof, req.cls.think_ms,
                                 int(nu) * req.vm.slots, req.samples)
                    # first requester of the miss is charged the dispatch
                    tally["dispatched"] += 1
                    rep.points_dispatched += 1

        with _obs_trace.span("flush", cat="fusion", groups=len(todo),
                             points=rep.points, cached=rep.points_cached):
            # Phase 1 — queue every fusion group's kernels on the device
            # without reading anything back (marshaling the next group
            # overlaps the card running the previous one); phase 2 — ONE
            # device-to-host copy for the whole round
            # (qn_sim.resolve_batches, QN and DAG groups alike), then the
            # cache fills.
            inflight = []
            for fkey, group in todo.items():
                kind, h_users, _sdig, spec = fkey[:4]
                cks = list(group)
                profs = [group[k][0] for k in cks]
                think = [group[k][1] for k in cks]
                slots = [group[k][2] for k in cks]
                samples = group[cks[0]][3]
                _GROUP_SIZE.observe(len(cks))
                pending_batch = fused_eval_call(
                    kind, profs, think, h_users, slots,
                    min_jobs=spec.min_jobs,
                    warmup_jobs=spec.warmup_jobs,
                    replications=spec.replications,
                    seed=spec.seed, samples=samples, device=self.device,
                    defer=True)
                inflight.append((cks, pending_batch))
                rep.groups += 1
            if inflight:
                results = qn_sim.resolve_batches(p for _, p in inflight)
                for (cks, _), ts in zip(inflight, results):
                    for ck, t in zip(cks, ts):
                        self.cache.put(ck, float(t))

        for req in pending:
            req.result = np.array(
                [self.cache.get(k) for k in keys[id(req)]], np.float64)

        self.fused_dispatches += rep.groups
        self.points_dispatched += rep.points_dispatched
        with _REG.lock:
            _FUSION["groups"].inc(rep.groups)
            _FUSION["points"].inc(rep.points)
            _FUSION["points_dispatched"].inc(rep.points_dispatched)
            _FUSION["points_cached"].inc(rep.points_cached)
            _FUSION["points_deduped"].inc(rep.points_deduped)
            for jid, tally in rep.per_job.items():
                lbl = {"tenant": tenants[jid]}
                _FUSION["points"].labels(**lbl).inc(tally["points"])
                _FUSION["points_dispatched"].labels(**lbl).inc(
                    tally["dispatched"])
                _FUSION["points_cached"].labels(**lbl).inc(tally["cached"])
                _FUSION["points_deduped"].labels(**lbl).inc(
                    tally["deduped"])
        self.last_flush = rep
        return pending

    def stats(self) -> dict:
        return {"fused_dispatches": self.fused_dispatches,
                "points_requested": self.points_requested,
                "points_dispatched": self.points_dispatched}
