"""Job model of the solver service: per-tenant request state.

A job is one capacity-planning ``Problem`` plus the simulation parameters
its tenant asked for.  Lifecycle::

    QUEUED --admission--> SOLVING --> DONE | INFEASIBLE
       |                     |
       +--> SHED             +--> FAILED

``INFEASIBLE`` still carries a full report — it means the optimizer
converged but at least one class cannot meet its deadline at any admitted
cluster size (the paper's "negative answer is an answer" case).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.optimizer import RunReport
from repro_torch.core.problem import Problem
from repro_torch.service.scheduler import SimSpec


class JobState:
    QUEUED = "queued"
    SOLVING = "solving"
    DONE = "done"
    INFEASIBLE = "infeasible"
    SHED = "shed"
    FAILED = "failed"


@dataclass
class Job:
    id: str
    problem: Problem
    spec: SimSpec
    window: int = 16
    race: bool = True     # race VM-type lanes at the QN tier (single-type
    #                       catalogs degenerate to the locked walk anyway)
    # {(class_name, vm_name): replay payload} — (m_list, r_list) for
    # MapReduce classes, a (n_stages, n_samples) array for DAG classes
    samples: Optional[Dict[Tuple[str, str], object]] = None
    tag: Optional[str] = None
    deployment: Optional[object] = None   # PrivateCloud | None (public)
    state: str = JobState.QUEUED
    submitted_s: float = field(default_factory=time.time)
    started_s: Optional[float] = None
    finished_s: Optional[float] = None
    report: Optional[RunReport] = None
    error: Optional[str] = None
    events_estimate: int = 0
    cores_estimate: int = 0       # physical cores (private-cloud jobs only)
    # per-tenant usage tallies, filled by the engine as rounds execute
    rounds: int = 0               # scheduling rounds this job took part in
    points: int = 0               # QN points requested across all rounds
    points_cached: int = 0        # ... served from the shared cache
    points_dispatched: int = 0    # ... this job was first requester of
    # engine internals: the resumable run generator + its pending windows
    _gen: object = None
    _pending: list = None

    @property
    def tenant(self) -> str:
        """The accounting identity metrics/SLOs attribute to: the
        submission ``tag`` when given (one tenant spanning many jobs),
        else the job id."""
        return self.tag or self.id

    @property
    def wall_ms(self) -> float:
        """Queue-to-settle wall time so far (ms)."""
        end = self.finished_s if self.finished_s is not None else time.time()
        return (end - self.submitted_s) * 1e3

    def samples_for(self, cls_name: str, vm_name: str):
        if self.samples and (cls_name, vm_name) in self.samples:
            return self.samples[(cls_name, vm_name)]
        return None

    def summary(self) -> dict:
        out = {"id": self.id, "state": self.state, "tag": self.tag,
               "tenant": self.tenant,
               "classes": len(self.problem.classes),
               "events_estimate": self.events_estimate,
               "cores_estimate": self.cores_estimate,
               "submitted_s": self.submitted_s,
               "started_s": self.started_s, "finished_s": self.finished_s,
               "rounds": self.rounds, "points": self.points,
               "points_cached": self.points_cached,
               "points_dispatched": self.points_dispatched,
               "error": self.error}
        if self.report is not None:
            out["total_cost_per_h"] = self.report.total_cost_per_h
            out["solutions"] = {k: v.as_dict()
                                for k, v in self.report.solutions.items()}
            out["deployment"] = self.report.deployment
            out["slo"] = self.report.slo
        return out


def parse_submission(text: str) -> Tuple[Problem, dict]:
    """Decode one JSON submission: ``{"problem": {...}, "solver": {...}}``
    (or a bare problem document).  Returns the problem and the solver
    keyword overrides (min_jobs, warmup_jobs, replications, seed, window,
    race, tag, deployment — the latter decoded to a ``PrivateCloud``)."""
    raw = json.loads(text)
    if "problem" in raw:
        solver = dict(raw.get("solver") or {})
        problem = Problem.from_json(json.dumps(raw["problem"]))
    else:
        solver = {}
        problem = Problem.from_json(text)
    if solver.get("deployment") is not None:
        from repro_torch.cloud.hosts import deployment_from_dict
        solver["deployment"] = deployment_from_dict(solver["deployment"])
    return problem, solver
