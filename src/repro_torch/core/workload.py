"""The Workload abstraction — pluggable per-class performance models.

The paper's evaluation plane is hardwired to MapReduce job profiles
(``JobProfile``: n_map/n_reduce task counts and durations).  Its §6 future
work — "characterization of complex workflows expressed as DAGs, e.g., Tez
or Spark jobs" — needs the same plane to accept other job structures, so
this module defines what the optimizer, evaluators, scheduler, and cache
actually require of a class's workload:

  * ``kind``          — a short tag (``"mapreduce"`` / ``"dag"``) every
                        dispatch point switches on; fusion keys and cache
                        hashes include it so kinds can never mix or collide;
  * ``scaled(speed)`` — the same workload on cores running ``speed``x
                        faster (per-VM-type profile fallback);
  * ``total_work``    — total core-milliseconds of one job;
  * generic (A, B) demand (``mva.workload_demand``) for the analytic tier;
  * a batched accurate-tier simulator (``qn_sim.response_time_batch`` /
    ``dag.response_time_batch``) routed per kind by
    ``evaluators.fused_eval_call``;
  * a per-lane event budget (``evaluators.workload_event_budget``) so
    admission control can price any kind.

Two first-class instances exist: ``problem.JobProfile`` (MapReduce) and
``DagJob`` below (a chain of fork-join stages, the ARIA-style Tez/Spark
abstraction).  ``docs/workloads.md`` walks through adding a third kind.

This module is deliberately dependency-free (hashlib/numpy only) so the
problem layer, the analytic tier, and the service cache can all import it
without cycles.  (The TPC-DS scenario catalog of the paper's §4
experiments lives in ``repro_torch.core.tpcds``.)
"""
from __future__ import annotations

import hashlib
from dataclasses import asdict, dataclass
from typing import Tuple

MAPREDUCE = "mapreduce"
DAG = "dag"


def workload_kind(w) -> str:
    """The dispatch tag of a workload (``"mapreduce"`` when the object
    predates the abstraction and carries no ``kind`` of its own)."""
    return getattr(w, "kind", MAPREDUCE)


# --------------------------------------------------------------------------
# The DAG workload: a chain of fork-join stages (Tez vertex / Spark stage)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Stage:
    """One DAG node / Spark stage: ``n_tasks`` parallel tasks of mean
    duration ``t_avg`` ms (``t_max`` feeds the analytic B term; ``cv`` the
    detailed simulator's lognormal spread)."""
    n_tasks: int
    t_avg: float                  # mean task duration [ms]
    t_max: float = 0.0            # max (for the analytic B term)
    cv: float = 0.35              # detailed-sim lognormal CV

    @property
    def max_or_est(self) -> float:
        return self.t_max if self.t_max > 0 else 2.5 * self.t_avg


@dataclass(frozen=True)
class DagJob:
    """A Tez/Spark-like job: a CHAIN of fork-join stages sharing the FCR
    (the paper's "DAG node or Spark stage is associated to a corresponding
    multi-server queue").  Usable wherever a ``JobProfile`` is — as an
    ``ApplicationClass`` per-VM-type profile value."""
    name: str
    stages: Tuple[Stage, ...]

    @property
    def kind(self) -> str:
        return DAG

    @property
    def total_work(self) -> float:
        """Total core-milliseconds of one job."""
        return sum(s.n_tasks * s.t_avg for s in self.stages)

    def scaled(self, speed: float) -> "DagJob":
        """The same chain on a VM type whose cores run ``speed``x faster."""
        f = 1.0 / speed
        return DagJob(self.name, tuple(
            Stage(s.n_tasks, s.t_avg * f, s.t_max * f, s.cv)
            for s in self.stages))


# --------------------------------------------------------------------------
# JSON round-trip (Problem profiles may mix kinds)
# --------------------------------------------------------------------------

def workload_to_dict(w) -> dict:
    """JSON-serializable form.  MapReduce profiles keep their historical
    flat schema; DAG jobs nest a ``stages`` list (the presence of that key
    is the decode discriminator)."""
    return asdict(w)


def workload_from_dict(d: dict):
    """Inverse of ``workload_to_dict``.  Returns a ``DagJob`` when the dict
    carries a ``stages`` list, else a ``JobProfile``."""
    if "stages" in d:
        return DagJob(name=d.get("name", "dag"),
                      stages=tuple(Stage(**s) for s in d["stages"]))
    from repro_torch.core.problem import JobProfile
    return JobProfile(**d)


# --------------------------------------------------------------------------
# Content digests (the service cache + the single-run evaluator caches)
# --------------------------------------------------------------------------

def samples_digest(samples) -> str:
    """Digest of replay task-duration lists (``None`` -> exponential mode).

    MapReduce replay samples are an ``(m_list, r_list)`` pair (digested
    unprefixed, byte-compatible with pre-PR-3 cache spills); DAG replay
    samples are one ``(n_stages, n_samples)`` array, digested with a
    ``dag:`` prefix.  Cross-kind aliasing is ruled out one level up:
    every consumer keys on the workload kind separately (``profile_hash``
    structure fields, scheduler fusion keys)."""
    if samples is None:
        return "exp"
    import numpy as np
    h = hashlib.sha1()
    if isinstance(samples, np.ndarray):
        h.update(b"dag:")
        h.update(np.asarray(samples, np.float32).tobytes())
        return h.hexdigest()[:16]
    ms, rs = samples
    h.update(np.asarray(ms, np.float32).tobytes())
    h.update(np.asarray(rs, np.float32).tobytes())
    return h.hexdigest()[:16]


def _structure_fields(prof) -> tuple:
    """The workload-structure part of ``profile_hash``: everything about
    the job itself that determines a QN estimate.  MapReduce keeps the
    historical field order (existing cache spills stay valid); DAG payloads
    carry a kind prefix plus per-stage (n_tasks, t_avg), so a DAG entry can
    never collide with a MapReduce one."""
    if workload_kind(prof) == DAG:
        return ("dag", len(prof.stages)) + tuple(
            (s.n_tasks, s.t_avg) for s in prof.stages)
    return (prof.n_map, prof.n_reduce, prof.m_avg, prof.r_avg)


def profile_hash(prof, think_ms: float, h_users: int, vm_slots: int, *,
                 min_jobs: int, warmup_jobs: int, replications: int,
                 samples=None, samples_dig: str = None) -> str:
    """Content hash of one evaluation context.  ``prof`` is the workload
    already scaled to the VM type (``cls.profile_for(vm)``), so VM speed is
    folded in; ``vm_slots`` covers the containers-per-VM mapping from nu to
    simulator slots.  The candidate ``nu`` and the ``seed`` stay out — they
    are separate key components.  ``samples_dig`` short-circuits the replay
    digest when the caller already computed it."""
    if samples_dig is None:
        samples_dig = samples_digest(samples)
    payload = "|".join(repr(x) for x in _structure_fields(prof) + (
        float(think_ms), int(h_users), int(vm_slots),
        int(min_jobs), int(warmup_jobs), int(replications),
        samples_dig))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]
