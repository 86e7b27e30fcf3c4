"""Deadline tracking of one solve: ``solve_slo_summary`` computes the
deadline margin per class and the worst of them, attached to
``RunReport.slo`` by the optimizer epilogue.

The reference's service-side tracker (``SLOTracker``, P² quantiles,
labeled ``slo.*`` gauges) comes with the service port.
"""
from __future__ import annotations

import math
from typing import Dict


def solve_slo_summary(problem, solutions: Dict[str, object],
                      wall_s: float) -> dict:
    """Deadline margin of one solve.  Per class: ``margin_ms = D_i -
    T_i`` (negative or non-finite means the deadline is missed).  A class
    with no finite prediction, or marked infeasible, counts as a
    violation.  ``problem`` only needs ``.classes`` with ``name`` and
    ``deadline_ms``; ``solutions`` maps class name to anything with
    ``predicted_ms``/``feasible`` (a ``ClassSolution``)."""
    margins: Dict[str, float] = {}
    violations = 0
    for cls in problem.classes:
        sol = solutions.get(cls.name)
        if sol is None:
            continue
        pred = float(getattr(sol, "predicted_ms", math.inf))
        margin = cls.deadline_ms - pred
        margins[cls.name] = margin
        if not getattr(sol, "feasible", False) or not math.isfinite(
                margin) or margin < 0:
            violations += 1
    worst = min(margins.values()) if margins else math.inf
    return {
        "classes": len(margins),
        "margin_ms": margins,
        "worst_margin_ms": worst,
        "violations": violations,
        "met": violations == 0,
        "solve_wall_ms": float(wall_s) * 1e3,
    }
