"""Admission control: bound the concurrent in-flight event budget.

Cross-job fusion pads every lane of a fused dispatch to the batch-maximum
scan length and lane bucket (``qn_sim.response_time_batch``), so
batching stays profitable only while the padding waste is bounded — admit
too many heterogeneous jobs at once and one huge profile stretches every
lane.  The controller prices each job in *simulator events* (the actual
unit of device work: ``evaluators.workload_event_budget`` per lane x
window x replications x classes — workload-generic, so MapReduce and
Spark/Tez DAG classes are priced in the same currency) and keeps the sum
over active jobs under ``max_inflight_events``.

Policies for jobs that do not fit right now:

  * ``"queue"`` (default) — wait; oversize jobs (estimate alone above the
    budget) are admitted only when nothing else is in flight, so they
    degrade to a solo run instead of starving forever;
  * ``"shed"``  — reject immediately (state ``SHED``).

``max_queue`` (optional) bounds the *waiting* queue under both policies:
submissions arriving at a full queue are shed.

Private-cloud jobs are additionally admitted against **physical cores**:
a service fronting one finite cluster (``max_physical_cores``) keeps the
sum of active private jobs' core demands (``estimate_job_cores``) under
the metal actually available, so two tenants cannot both be promised the
same hosts — public-cloud jobs rent elastically and are charged 0 cores.

All decisions are counted (``AdmissionStats``) for the service dashboard.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.core.evaluators import workload_event_budget
from repro_torch.core.milp import rank_vm_types
from repro_torch.core.problem import Problem
from repro_torch.obs import metrics as _obs_metrics

ADMIT, DEFER, SHED = "admit", "defer", "shed"

# Registry twins of AdmissionStats' decision tallies (the dataclass stays
# the per-controller record; the counters aggregate process-wide across
# however many services/controllers a process runs).
_REG = _obs_metrics.registry()
_VERDICTS = {v: _REG.counter(f"admission.{v}") for v in
             (ADMIT, DEFER, SHED)}
_INFLIGHT_EVENTS = _REG.gauge("admission.inflight_events")
_INFLIGHT_CORES = _REG.gauge("admission.inflight_cores")


def estimate_job_events(problem: Problem, *, window: int, min_jobs: int,
                        warmup_jobs: int, replications: int,
                        race: bool = True) -> int:
    """Upper bound on the simulator events one scheduling round of this job
    can put in flight: per class, one full window of candidates times
    replications times the padded per-lane budget, summed over every
    VM-type lane the racer can have in flight at once (each profiled
    catalog entry is one potential ``class x vm`` lane; with a single-type
    catalog this is the pre-race estimate unchanged).  ``race=False`` jobs
    run exactly one lane per class, so they are charged only the costliest
    profiled lane — charging the raced footprint would needlessly defer or
    serialize them.  Event budgets depend only on task counts (not on nu),
    so this is computable at submission time."""
    total = 0
    for cls in problem.classes:
        lanes = 0
        for vm in problem.vm_types:
            try:
                prof = cls.profile_for(vm)
            except KeyError:
                continue
            budget = workload_event_budget(
                prof, min_jobs=min_jobs, warmup_jobs=warmup_jobs)
            lanes = lanes + budget if race else max(lanes, budget)
        total += window * replications * lanes
    return total


def estimate_job_cores(problem: Problem,
                       deployment: Optional[object] = None) -> int:
    """Physical cores one private-cloud job will contend for: the
    analytic initial solution's core demand (head of ``rank_vm_types``),
    capped at the deployment's own capacity — the coordinator never
    plans past it (it truncates to fit instead).  Public jobs
    (``deployment=None``) rent elastic capacity: charged 0."""
    if deployment is None:
        return 0
    try:
        ranking = rank_vm_types(problem)
    except ValueError:           # nothing analytically feasible: the run
        return 0                 # will fail at activation, charge nothing
    demand = sum(cands[0].nu * problem.vm_by_name(cands[0].vm_type).cores
                 for cands in ranking.values())
    return min(demand, deployment.total_cores)


@dataclass
class AdmissionStats:
    admitted: int = 0
    deferred: int = 0            # DEFER verdicts issued (re-tries re-count)
    shed: int = 0
    released: int = 0
    oversize_admitted: int = 0   # ran alone because estimate > budget
    inflight_events: int = 0
    peak_inflight_events: int = 0
    inflight_cores: int = 0      # physical cores promised to active jobs
    peak_inflight_cores: int = 0

    def as_dict(self) -> dict:
        return asdict(self)


class AdmissionController:
    """Event- and core-budget gate for the solver pool.  Not thread-safe
    on its own — the cooperative engine calls it from one scheduling
    loop.  ``max_physical_cores`` (optional) is the metal behind a
    service that fronts one private cluster: the sum of active jobs'
    core estimates stays under it."""

    def __init__(self, max_inflight_events: int = 16_000_000, *,
                 policy: str = "queue", max_queue: int = None,
                 max_physical_cores: Optional[int] = None):
        if policy not in ("queue", "shed"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.max_inflight_events = int(max_inflight_events)
        self.policy = policy
        self.max_queue = max_queue
        self.max_physical_cores = max_physical_cores
        self.stats = AdmissionStats()
        # job_id -> (admitted event estimate, admitted core estimate)
        self._active: Dict[str, tuple] = {}

    # ---------------------------------------------------------- submission
    def accept_submission(self, queue_len: int) -> bool:
        """Whether a new submission may even wait in the queue.
        ``max_queue`` bounds the waiting queue under BOTH policies (the
        policy only governs how in-flight pressure is handled); an
        over-limit submission is shed."""
        if self.max_queue is not None and queue_len >= self.max_queue:
            self.stats.shed += 1
            _VERDICTS[SHED].inc()
            return False
        return True

    # ----------------------------------------------------------- admission
    def try_admit(self, job_id: str, events: int, cores: int = 0,
                  tenant: Optional[str] = None) -> str:
        """ADMIT (and charge the budgets), DEFER (keep queued), or SHED.
        ``cores`` is the job's physical-core demand (0 for public jobs);
        it gates admission only when ``max_physical_cores`` is set.
        ``tenant`` additionally attributes the verdict to a tenant-labeled
        child of the process-wide ``admission.*`` counters."""

        def _count(verdict: str) -> None:
            _VERDICTS[verdict].inc()
            if tenant is not None:
                _VERDICTS[verdict].labels(tenant=tenant).inc()

        events = int(events)
        cores = int(cores)
        oversize = events > self.max_inflight_events
        if self.max_physical_cores is not None:
            oversize = oversize or cores > self.max_physical_cores
        if oversize:
            if self.policy == "shed":
                self.stats.shed += 1
                _count(SHED)
                return SHED
            if self._active:                  # oversize: wait for solitude
                self.stats.deferred += 1
                _count(DEFER)
                return DEFER
            self.stats.oversize_admitted += 1
        else:
            over_events = self.stats.inflight_events + events \
                > self.max_inflight_events
            over_cores = self.max_physical_cores is not None \
                and self.stats.inflight_cores + cores \
                > self.max_physical_cores
            if over_events or over_cores:
                self.stats.deferred += 1
                _count(DEFER)
                return DEFER
        self._active[job_id] = (events, cores)
        self.stats.admitted += 1
        _count(ADMIT)
        self.stats.inflight_events += events
        self.stats.inflight_cores += cores
        _INFLIGHT_EVENTS.set(self.stats.inflight_events)
        _INFLIGHT_CORES.set(self.stats.inflight_cores)
        self.stats.peak_inflight_events = max(
            self.stats.peak_inflight_events, self.stats.inflight_events)
        self.stats.peak_inflight_cores = max(
            self.stats.peak_inflight_cores, self.stats.inflight_cores)
        return ADMIT

    def release(self, job_id: str) -> None:
        events, cores = self._active.pop(job_id, (0, 0))
        self.stats.inflight_events -= events
        self.stats.inflight_cores -= cores
        _INFLIGHT_EVENTS.set(self.stats.inflight_events)
        _INFLIGHT_CORES.set(self.stats.inflight_cores)
        if events or cores:
            self.stats.released += 1
