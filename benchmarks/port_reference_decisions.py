"""Decisions of the JAX reference for the calls ``chip_smoke.py`` drives on
the card, printed as the JSON that ``chip_smoke.REFERENCE`` holds.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks.port_reference_decisions

The calls: the paper's §4.3 scenario (``scenario_problem("Q1", 10,
160_000.0)`` with its replay lists) through ``DSpace4Cloud.run()`` and
``.run_fast()`` at the defaults, and through the point-wise gait
``DSpace4Cloud(batched=False).run()`` at the defaults, each on a fresh
instance; and the quickstart problem through ``DSpace4Cloud(problem,
min_jobs=20, replications=1).run()`` in both gaits (the point-wise one
walks its two classes in two threads).  On a CPU host the real-size
batched calls take about half a minute each, the point-wise one a minute
or more.
"""
from __future__ import annotations

import json

from repro.core.optimizer import DSpace4Cloud
from repro.core.problem import ApplicationClass, JobProfile, Problem, VMType
from repro.core.tpcds import scenario_problem


def quickstart_problem() -> Problem:
    interactive = JobProfile(n_map=64, n_reduce=16, m_avg=4000, m_max=9000,
                             r_avg=2000, r_max=4500)
    batchy = JobProfile(n_map=400, n_reduce=64, m_avg=8000, m_max=18000,
                        r_avg=5000, r_max=11000)
    small = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   containers_per_core=2)
    big = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    return Problem(classes=[
        ApplicationClass(name="bi-dashboards", h_users=8, think_ms=10_000,
                         deadline_ms=60_000, eta=0.3,
                         profiles={"m4.xlarge": interactive,
                                   "c20.node": interactive.scaled(1.35)}),
        ApplicationClass(name="nightly-etl", h_users=2, think_ms=30_000,
                         deadline_ms=600_000, eta=0.5,
                         profiles={"m4.xlarge": batchy,
                                   "c20.node": batchy.scaled(1.35)}),
    ], vm_types=[small, big])


def main() -> None:
    prob, samples, _ = scenario_problem("Q1", 10, 160_000.0)
    reports = {
        "Q1-10u.run": DSpace4Cloud(prob, samples=samples).run(),
        "Q1-10u.run_fast": DSpace4Cloud(prob, samples=samples).run_fast(),
        "quickstart.run": DSpace4Cloud(quickstart_problem(), min_jobs=20,
                                       replications=1).run(),
        "Q1-10u.run_pointwise": DSpace4Cloud(prob, samples=samples,
                                             batched=False).run(),
        "quickstart.run_pointwise": DSpace4Cloud(
            quickstart_problem(), min_jobs=20, replications=1,
            batched=False).run(parallel=True),
    }
    print(json.dumps({name: {
        "qn_dispatches": r.qn_dispatches,
        "classes": {k: v.as_dict() for k, v in r.solutions.items()}}
        for name, r in reports.items()}, indent=1))


if __name__ == "__main__":
    main()
