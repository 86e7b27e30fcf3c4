"""The multi-tenant solver service: job queue + cooperative solver pool.

``SolverService`` accepts capacity-planning problems (JSON or ``Problem``
objects; classes may carry MapReduce profiles, Spark/Tez DAG chains, or
a mix), runs many ``DSpace4Cloud`` optimizations *cooperatively* — all
active jobs advance in lockstep scheduling rounds so their QN window
requests coexist in flight — and fuses every round's windows across jobs
into shared device dispatches (``FusionScheduler``, grouping by a
workload-aware fusion key: one dispatch per workload kind per group).
Admission control bounds the concurrent in-flight event budget; the
shared ``EvalCache`` makes repeat tenants with overlapping catalogs
warm-start, across jobs and across process restarts.

One scheduling round (``step()``)::

    admit from queue  ->  collect pending windows of every active job
                      ->  FusionScheduler.flush()   (shared device calls)
                      ->  deliver results, advance each job's run_steps()
                      ->  retire finished jobs (DONE / INFEASIBLE / FAILED)

Throughput scales sub-linearly in dispatches: N similar concurrent jobs
cost about as many fused dispatches as the slowest single job alone
(``benchmarks/torch_scenarios.py`` ``service_throughput``).

The service runs every job and every fused dispatch on one ``device``: the
current CUDA device by default (it raises without one, like every entry
point of the port), ``"cpu"`` for the kernels' plain versions.  On the
card a round's MapReduce groups launch ``qn_event`` with its draw tables
(``event_streams``) and its DAG groups ``dag_event`` with theirs
(``dag_streams``); nothing falls back.  A private job (``deployment=``)
moves through the same rounds: each probe round of its coordinator is
part of one flush, and its packings are checked on the same device.

Telemetry: every round appends one structured
event to the flight recorder (a bounded ring buffer, dumped as JSON when
a job fails or via ``dump_flight_recorder()``); round wall time feeds the
``service.round_ms`` histogram; and when a tracer is installed the round
opens a ``service_round`` span above the scheduler's ``flush``.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Union

from repro_torch import resolve_device
from repro_torch.core import partition as _partition
from repro_torch.core import qn_sim
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.core.problem import Problem
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.slo import SLOTracker
from repro_torch.service.admission import ADMIT, SHED, \
    AdmissionController, estimate_job_cores, estimate_job_events
from repro_torch.service.cache import EvalCache
from repro_torch.service.jobs import Job, JobState, parse_submission
from repro_torch.service.scheduler import FusionScheduler, SimSpec, \
    WindowRequest

_REG = _obs_metrics.registry()
_ROUND_MS = _REG.histogram(
    "service.round_ms", help="wall time of one scheduling round [ms]",
    buckets=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000))
_ROUNDS = _REG.counter("service.rounds")
_JOBS_DONE = _REG.counter("service.jobs_finished")
_JOBS_FAILED = _REG.counter("service.jobs_failed")
_JOB_WALL_MS = _REG.gauge(
    "service.job_wall_ms",
    help="queue-to-settle wall time of the tenant's last finished job")
_PADDED_EVENTS = _REG.counter(
    "service.padded_events",
    help="padding-waste events attributed to the tenant's dispatches")


class SolverService:
    """Concurrent capacity-planning service (in-process event loop).

    ``cache_path`` enables the persistent spill: an existing file is
    warm-loaded, and ``save_cache()`` (called automatically by
    ``run_until_complete``) writes it back.

    ``recorder`` (or the default ring of ``recorder_capacity`` events)
    keeps the per-round flight log; ``recorder_path`` makes the service
    auto-dump it as JSON the first time a job FAILs.

    ``device`` is where every job's kernels run (resolved once, here).
    """

    def __init__(self, *, cache: Optional[EvalCache] = None,
                 cache_path: Optional[str] = None,
                 admission: Optional[AdmissionController] = None,
                 window: int = 16, max_rounds: int = 10_000,
                 recorder: Optional[FlightRecorder] = None,
                 recorder_capacity: int = 4096,
                 recorder_path: Optional[str] = None,
                 slo_budget: float = 0.01, device=None):
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else EvalCache(cache_path)
        self.scheduler = FusionScheduler(self.cache, device=self.device)
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.window = window
        self.max_rounds = max_rounds
        self.rounds = 0
        self.recorder = recorder if recorder is not None \
            else FlightRecorder(recorder_capacity)
        self.recorder_path = recorder_path
        self.slo = SLOTracker(budget=slo_budget)
        self._jobs: Dict[str, Job] = {}
        self._queue: List[str] = []
        self._active: List[str] = []
        self._seq = itertools.count()
        self._http = None             # serve_http() handle (service/http)

    # -------------------------------------------------------------- intake
    def submit(self, problem: Union[Problem, str], *, min_jobs: int = 40,
               warmup_jobs: int = 8, replications: int = 2, seed: int = 0,
               samples=None, window: Optional[int] = None,
               race: bool = True, tag: Optional[str] = None,
               deployment=None) -> str:
        """Queue one problem; returns the job id immediately.  ``problem``
        may be a ``Problem`` or a JSON submission (whose ``solver`` section
        overrides the keyword defaults).  ``race=False`` locks each class
        to its analytic-argmin VM type instead of racing the catalog.
        ``deployment`` (a ``PrivateCloud``, or its dict form inside a JSON
        submission's solver section) plans the job against a finite
        private cluster — overriding the problem document's own
        ``deployment`` field; such jobs are also admitted against the
        controller's physical-core budget."""
        kw = dict(min_jobs=min_jobs, warmup_jobs=warmup_jobs,
                  replications=replications, seed=seed)
        if isinstance(problem, str):
            problem, overrides = parse_submission(problem)
            tag = overrides.pop("tag", tag)
            window = overrides.pop("window", window)
            race = overrides.pop("race", race)
            deployment = overrides.pop("deployment", deployment)
            unknown = set(overrides) - set(kw)
            if unknown:                   # reject cleanly at intake, not as
                raise ValueError(         # a TypeError from SimSpec(**kw)
                    f"unknown solver option(s) {sorted(unknown)}; valid: "
                    f"{sorted(kw)} + ['window', 'race', 'tag', "
                    f"'deployment']")
            kw.update(overrides)
        if deployment is None:
            deployment = getattr(problem, "deployment", None)
        spec = SimSpec(**kw)
        job = Job(id=f"job-{next(self._seq):04d}", problem=problem,
                  spec=spec, window=window or self.window,
                  race=race, samples=samples, tag=tag,
                  deployment=deployment)
        job.events_estimate = estimate_job_events(
            problem, window=job.window, min_jobs=spec.min_jobs,
            warmup_jobs=spec.warmup_jobs, replications=spec.replications,
            race=job.race)
        job.cores_estimate = estimate_job_cores(problem, deployment)
        self._jobs[job.id] = job
        if self.admission.accept_submission(len(self._queue)):
            self._queue.append(job.id)
            self.recorder.record("submit", tenant=job.tenant, job=job.id,
                                 tag=tag, classes=len(problem.classes),
                                 events_estimate=job.events_estimate)
        else:
            job.state = JobState.SHED
            job.finished_s = time.time()
            self.recorder.record("shed", tenant=job.tenant, job=job.id,
                                 at="submit", queue_len=len(self._queue))
        return job.id

    # ----------------------------------------------------------- admission
    def _admit(self) -> None:
        """FIFO admission: queued jobs are offered in submission order and
        the first DEFER verdict stops the scan — later submissions never
        jump an earlier waiting job.  Under continuous traffic this is what
        guarantees a deferred (e.g. oversize) job eventually sees the
        in-flight budget it is waiting for instead of starving behind a
        stream of smaller newcomers."""
        admitted_until = 0
        for i, jid in enumerate(self._queue):
            job = self._jobs[jid]
            verdict = self.admission.try_admit(jid, job.events_estimate,
                                               job.cores_estimate,
                                               tenant=job.tenant)
            if verdict == ADMIT:
                self._activate(job)
            elif verdict == SHED:
                job.state = JobState.SHED
                job.finished_s = time.time()
                self.recorder.record("shed", tenant=job.tenant, job=jid,
                                     at="admission")
            else:
                self.recorder.record("defer", tenant=job.tenant, job=jid,
                                     events_estimate=job.events_estimate)
                admitted_until = i
                break
            admitted_until = i + 1
        self._queue = self._queue[admitted_until:]

    def _activate(self, job: Job) -> None:
        job.state = JobState.SOLVING
        job.started_s = time.time()
        self.recorder.record("activate", tenant=job.tenant, job=job.id,
                             window=job.window, race=job.race)
        # the facade's own evaluator stays idle here: run_steps() proposes
        # windows and this engine satisfies them through the FusionScheduler
        # and the shared content-addressed cache
        tool = DSpace4Cloud(job.problem, min_jobs=job.spec.min_jobs,
                            replications=job.spec.replications,
                            seed=job.spec.seed, samples=job.samples,
                            batched=True, window=job.window,
                            race=job.race, deployment=job.deployment,
                            device=self.device)
        job._gen = tool.run_steps()
        try:
            job._pending = next(job._gen)
            self._active.append(job.id)
        except StopIteration as stop:       # no classes to converge
            self._finish(job, stop.value)
        except Exception as e:              # e.g. no feasible initial point
            self._fail(job, e)

    # ------------------------------------------------------------ stepping
    def step(self) -> bool:
        """One cooperative scheduling round; True while work remains."""
        t_round = time.perf_counter()
        self._admit()
        if not self._active:
            return bool(self._queue)
        self.rounds += 1
        _ROUNDS.inc()

        with _obs_trace.span("service_round", cat="service",
                             round=self.rounds, active=len(self._active)):
            requests: Dict[str, List[WindowRequest]] = {}
            for jid in self._active:
                job = self._jobs[jid]
                reqs = []
                for er in job._pending:
                    req = WindowRequest(
                        job_id=jid, cls=er.cls, vm=er.vm,
                        nus=[int(n) for n in er.nus], spec=job.spec,
                        samples=job.samples_for(er.cls.name, er.vm.name),
                        tenant=job.tenant)
                    self.scheduler.submit(req)
                    reqs.append(req)
                requests[jid] = reqs

            qn0 = qn_sim.sim_stats()
            self.scheduler.flush()
            flush = self.scheduler.last_flush
            self._attribute(flush, qn0, qn_sim.sim_stats())

            advanced, finished = 0, 0
            for jid in list(self._active):
                job = self._jobs[jid]
                results = {r.rid: r.result for r in requests[jid]}
                try:
                    job._pending = job._gen.send(results)
                    advanced += 1
                except StopIteration as stop:
                    self._active.remove(jid)
                    self._finish(job, stop.value)
                    finished += 1
                except Exception as e:
                    self._active.remove(jid)
                    self._fail(job, e)
                    finished += 1

        round_ms = (time.perf_counter() - t_round) * 1e3
        _ROUND_MS.observe(round_ms)
        self.recorder.record(
            "round", n=self.rounds, active=advanced, finished=finished,
            windows=sum(len(r) for r in requests.values()),
            groups=flush.groups, points=flush.points,
            dispatched=flush.points_dispatched, cached=flush.points_cached,
            wall_ms=round(round_ms, 3))
        return bool(self._queue or self._active)

    def _attribute(self, flush, qn0: dict, qn1: dict) -> None:
        """Fold one flush's per-job tallies into the jobs and distribute
        the round's padding waste (events_total - events_useful deltas
        around the flush) over tenants, proportional to the points each
        one dispatched — the device doesn't bill padding to anyone, so
        the tenants whose lanes forced it carry it pro rata."""
        waste = max(0, (qn1["events_total"] - qn1["events_useful"])
                    - (qn0["events_total"] - qn0["events_useful"]))
        dispatched = sum(t["dispatched"] for t in flush.per_job.values())
        for jid, tally in flush.per_job.items():
            job = self._jobs[jid]
            job.rounds += 1
            job.points += tally["points"]
            job.points_cached += tally["cached"]
            job.points_dispatched += tally["dispatched"]
            if waste and tally["dispatched"]:
                share = round(waste * tally["dispatched"] / dispatched)
                _PADDED_EVENTS.inc(share)
                _PADDED_EVENTS.labels(tenant=job.tenant).inc(share)

    def _finish(self, job: Job, report) -> None:
        job.report = report
        job.finished_s = time.time()
        feasible = all(s.feasible for s in report.solutions.values())
        job.state = JobState.DONE if feasible else JobState.INFEASIBLE
        self.admission.release(job.id)
        self.scheduler.forget_job(job.id)
        _JOBS_DONE.inc()
        _JOBS_DONE.labels(tenant=job.tenant).inc()
        _JOB_WALL_MS.labels(tenant=job.tenant).set(job.wall_ms)
        self.slo.observe(job.tenant, report.slo, wall_ms=job.wall_ms)
        self.recorder.record("finish", tenant=job.tenant, job=job.id,
                             state=str(job.state),
                             cost_per_h=report.total_cost_per_h,
                             qn_dispatches=report.qn_dispatches)

    def _fail(self, job: Job, err: Exception) -> None:
        job.state = JobState.FAILED
        job.error = f"{type(err).__name__}: {err}"
        job.finished_s = time.time()
        self.admission.release(job.id)
        self.scheduler.forget_job(job.id)
        _JOBS_FAILED.inc()
        _JOBS_FAILED.labels(tenant=job.tenant).inc()
        _JOB_WALL_MS.labels(tenant=job.tenant).set(job.wall_ms)
        self.slo.observe(job.tenant, None, wall_ms=job.wall_ms,
                         failed=True)
        self.recorder.record("fail", tenant=job.tenant, job=job.id,
                             error=job.error)
        if self.recorder_path:
            self.recorder.save(self.recorder_path)

    def run_until_complete(self, max_rounds: Optional[int] = None
                           ) -> Dict[str, Job]:
        """Drive rounds until every submitted job settles; spills the cache
        if a path is configured.  Returns all jobs by id."""
        limit = max_rounds or self.max_rounds
        rounds = 0
        with _obs_trace.span("service.run", cat="service",
                             jobs=len(self._jobs)):
            while self.step():
                rounds += 1
                if rounds > limit:
                    raise RuntimeError(
                        f"service did not settle within {limit} rounds "
                        f"(queued={len(self._queue)}, "
                        f"active={len(self._active)})")
            if self.cache.path:
                self.cache.save()
        return dict(self._jobs)

    # ------------------------------------------------------------- results
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_jobs(self) -> int:
        return len(self._active)

    def job(self, job_id: str) -> Job:
        return self._jobs[job_id]

    def result(self, job_id: str) -> dict:
        return self._jobs[job_id].summary()

    def dump_flight_recorder(self, path: Optional[str] = None) -> dict:
        """The flight-recorder ring as a JSON-ready dict; optionally also
        written to ``path``."""
        if path is not None:
            return self.recorder.save(path)
        return self.recorder.dump()

    def stats(self) -> dict:
        states: Dict[str, int] = {}
        for job in self._jobs.values():
            states[job.state] = states.get(job.state, 0) + 1
        return {"jobs": states, "rounds": self.rounds,
                "scheduler": self.scheduler.stats(),
                "cache": self.cache.stats(),
                "admission": self.admission.stats.as_dict(),
                "recorder": self.recorder.stats(),
                "qn": qn_sim.sim_stats(),
                "shard": _partition.shard_info(),
                "tenants": self.tenant_stats(),
                "slo": self.slo.summary()}

    def tenant_stats(self) -> Dict[str, dict]:
        """Per-tenant usage attribution, folded over every job the tenant
        submitted (a ``tag`` groups jobs into one tenant): QN points
        requested / served-from-cache / dispatched-first, scheduling
        rounds, job states, and wall time."""
        out: Dict[str, dict] = {}
        for job in self._jobs.values():
            t = out.setdefault(job.tenant, {
                "jobs": 0, "states": {}, "rounds": 0, "points": 0,
                "points_cached": 0, "points_dispatched": 0,
                "wall_ms": 0.0})
            t["jobs"] += 1
            t["states"][job.state] = t["states"].get(job.state, 0) + 1
            t["rounds"] += job.rounds
            t["points"] += job.points
            t["points_cached"] += job.points_cached
            t["points_dispatched"] += job.points_dispatched
            t["wall_ms"] += job.wall_ms
        return out

    def statz(self, *, recorder_tail: int = 64) -> dict:
        """The ``/statz`` document: per-tenant usage + SLO state, service
        stats, and the flight-recorder tail — one JSON-ready dict."""
        events = self.recorder.events()
        return {"stats": self.stats(),
                "tenants": self.tenant_stats(),
                "slo": self.slo.summary(),
                "jobs": {jid: j.summary()
                         for jid, j in sorted(self._jobs.items())},
                "recorder_tail": events[-recorder_tail:]}

    # ---------------------------------------------------------- scrape API
    def serve_http(self, host: str = "127.0.0.1", port: int = 0):
        """Start the scrape surface (``/metrics`` + ``/healthz`` +
        ``/statz``) on a daemon thread; returns the server handle (its
        ``.port`` is the bound ephemeral port when ``port=0``).  Idempotent
        per service: a second call returns the running server."""
        if self._http is None:
            from repro_torch.service.http import serve
            self._http = serve(self, host=host, port=port)
        return self._http

    def stop_http(self) -> None:
        if self._http is not None:
            self._http.stop()
            self._http = None
