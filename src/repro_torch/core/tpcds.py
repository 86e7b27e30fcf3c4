"""TPC-DS scenario catalog — the paper's experimental subjects (§4.1).

Each Table-3 scenario (query, users, containers, dataset scale) becomes a
``WorkloadSpec`` for the detailed cluster simulator.  Task counts n^M / n^R
are the published ones; median task durations are *calibrated* once so the
detailed simulator's measured response time matches the published T for
that row — i.e. we rebuild a synthetic cluster with the same externally
observable behaviour, then test whether the QN model predicts it as well as
the paper claims (the ϑ error is NOT by construction: the QN sees only the
parsed profile, and abstracts service-time distributions, stragglers,
startup and first-wave shuffle away).

VM catalog mirrors §4.1: m4.xlarge (4 vCPU, 2 containers/core) and the
CINECA PICO 20-core node (1 container/core, faster cores).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cluster_sim import WorkloadSpec, simulate_cluster
from repro_torch.core.problem import VMType

# ---------------------------------------------------------------- VM types

# Pricing calibrated for the paper's qualitative findings: per unit of
# work m4 is slightly cheaper (0.0275 vs 0.90/20/1.35 = 0.0333 per
# container-hour-of-work), so scale-out wins at loose deadlines (Figs 5-6);
# CINECA's 1.35x faster cores give it a lower response-time floor, so at
# 20 users + tight deadlines it becomes the only feasible (hence cheaper)
# choice — the Fig 7 crossover.
M4_XLARGE = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   speed=1.0, containers_per_core=2)       # 8 containers
CINECA = VMType(name="CINECA", cores=20, sigma=0.35, pi=0.90,
                speed=1.35, containers_per_core=1)         # 20 containers

VM_CATALOG = [M4_XLARGE, CINECA]


# ------------------------------------------------------- Table 3 scenarios

@dataclass(frozen=True)
class Scenario:
    query: str
    users: int
    containers: int
    dataset_gb: int
    n_map: int
    n_reduce: int
    t_published_ms: float         # measured T from paper Table 3


TABLE3: Tuple[Scenario, ...] = (
    Scenario("Q1", 1, 240, 250, 500, 1, 55410),
    Scenario("Q1", 5, 40, 250, 144, 151, 637888),
    Scenario("Q2", 1, 240, 250, 65, 5, 36881),
    Scenario("Q2", 3, 20, 250, 4, 4, 95403),
    Scenario("Q3", 1, 240, 250, 750, 1, 76806),
    Scenario("Q4", 1, 240, 250, 524, 384, 92197),
    Scenario("Q1", 1, 60, 500, 287, 300, 378127),
    Scenario("Q3", 1, 100, 500, 757, 793, 401827),
    Scenario("Q3", 1, 120, 750, 1148, 1009, 661214),
    Scenario("Q4", 1, 60, 750, 868, 910, 808490),
    Scenario("Q3", 1, 80, 1000, 1560, 1009, 1019973),
    Scenario("Q5", 1, 80, 1000, 64, 68, 39206),
)

THINK_MS = 10_000.0               # §4.2: 10 s average think time


def _base_spec(s: Scenario) -> WorkloadSpec:
    """Uncalibrated spec: a plausible split of work between map and reduce."""
    # initial guess: all containers busy ~75% of T, reduce tasks ~60% of map
    waves_m = max(1.0, s.n_map / s.containers)
    guess_map = 0.6 * s.t_published_ms / (waves_m + 1.0)
    return WorkloadSpec(
        name=f"{s.query}-{s.dataset_gb}G",
        n_map=s.n_map, n_reduce=s.n_reduce,
        map_ms=max(guess_map, 500.0),
        reduce_ms=max(0.6 * guess_map, 300.0),
        cv=0.35, startup_ms=150.0,
        shuffle_first_ms=0.15 * max(guess_map, 500.0),
        straggler_p=0.02, straggler_mult=2.5,
    )


def calibrate(s: Scenario, *, tol: float = 0.02, max_iter: int = 18,
              seed: int = 7) -> WorkloadSpec:
    """Scale task durations until the detailed simulator reproduces the
    published T for the row's own (users, containers) configuration."""
    spec = _base_spec(s)
    scale = 1.0
    for _ in range(max_iter):
        test = replace(spec, map_ms=spec.map_ms * scale,
                       reduce_ms=spec.reduce_ms * scale,
                       shuffle_first_ms=spec.shuffle_first_ms * scale)
        mean, _ = simulate_cluster(
            test, slots=s.containers, h_users=s.users, think_ms=THINK_MS,
            max_jobs=30, warmup_jobs=4, seed=seed)
        err = mean / s.t_published_ms
        if abs(err - 1.0) <= tol:
            return test
        # multiplicative secant step (response is ~linear in durations)
        scale /= err ** 0.9
    return test


_CACHE_PATH = os.path.join(os.path.dirname(__file__), "_calibrated.json")


def calibrated_specs(use_cache: bool = True) -> Dict[int, WorkloadSpec]:
    """Calibrated spec per Table-3 row index (cached to JSON)."""
    if use_cache and os.path.exists(_CACHE_PATH):
        raw = json.loads(open(_CACHE_PATH).read())
        if len(raw) == len(TABLE3):
            return {int(k): WorkloadSpec(**v) for k, v in raw.items()}
    out = {}
    for i, s in enumerate(TABLE3):
        out[i] = calibrate(s)
    with open(_CACHE_PATH, "w") as f:
        json.dump({k: v.__dict__ for k, v in out.items()}, f, indent=1)
    return out


def spec_for_query_250g(query: str) -> WorkloadSpec:
    """250 GB profile spec of a query (for the Fig 5-7 scenarios)."""
    specs = calibrated_specs()
    for i, s in enumerate(TABLE3):
        if s.query == query and s.dataset_gb == 250 and s.users == 1:
            return specs[i]
    raise KeyError(query)


# -------------------------------------------------- Fig 5-7 scenario build

def scenario_problem(query: str, users: int, deadline_ms: float,
                     vm_types: Optional[List[VMType]] = None,
                     eta: float = 0.3, profile_seed: int = 55):
    """Single-class Problem for the cost-vs-deadline scenarios (§4.3).

    Profiles + replayer lists are extracted per VM type from dedicated
    profiling runs (the §4.1 methodology: same query, both deployments)."""
    from repro_torch.core.cluster_sim import profile_from_runs, replayer_lists
    from repro_torch.core.problem import ApplicationClass, Problem

    vms = vm_types if vm_types is not None else VM_CATALOG
    spec = spec_for_query_250g(query)
    profiles = {}
    samples = {}
    for vm in vms:
        prof = profile_from_runs(spec, speed=vm.speed, runs=20,
                                 slots=240, seed=profile_seed)
        profiles[vm.name] = prof
        samples[(f"{query}-{users}u", vm.name)] = replayer_lists(
            spec, speed=vm.speed, runs=20, slots=240, seed=profile_seed)
    cls = ApplicationClass(name=f"{query}-{users}u", h_users=users,
                           think_ms=THINK_MS, deadline_ms=deadline_ms,
                           eta=eta, profiles=profiles)
    return Problem(classes=[cls], vm_types=list(vms)), samples, spec
