"""Per-tenant SLO tracking: streaming latency/margin quantiles, deadline
violations, and error-budget burn rate.

The paper's objective is "meet every class deadline D_i at minimum cost";
this module is the runtime's answer to "*are* we meeting them, per
tenant?".  Two consumers:

  * ``solve_slo_summary(problem, solutions, wall_s)`` — pure function
    computing the deadline margin of ONE solve (per class and worst-of),
    attached to ``RunReport.slo`` by the optimizer epilogue;
  * ``SLOTracker`` — the service-side accumulator: one ``TenantSLO`` per
    tenant, fed a summary per finished job.  Latency and margin stream
    into **P² quantile estimators** (Jain & Chlamtac 1985) — five markers
    per quantile, O(1) memory, no sample buffers — so a tenant that
    submits a million jobs costs the same as one that submits ten.

Error budget: a tenant's objective allows ``budget`` fraction of solves
to miss their deadline (default 1%%).  ``burn_rate`` is the observed
violation fraction over that allowance — 1.0 means burning exactly the
budget, >1 means the tenant will exhaust it; the standard alerting
threshold semantics.

Everything surfaces as labeled ``slo.*`` gauges (tenant-labeled children
of process-global families) so the OpenMetrics exporter and ``/statz``
read one registry.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

from .metrics import registry as _registry

_REG = _registry()

# Gauge families; per-tenant values live in tenant-labeled children.
_G_MARGIN = _REG.gauge("slo.margin_ms",
                       "worst class deadline margin of the last solve")
_G_P95 = _REG.gauge("slo.solve_p95_ms", "P² p95 of solve wall time")
_G_BURN = _REG.gauge("slo.burn_rate",
                     "violation fraction over the allowed error budget")
_C_SOLVES = _REG.counter("slo.solves", "solves folded into SLO tracking")
_C_VIOL = _REG.counter("slo.violations",
                       "solves that missed a deadline (or failed)")
_G_TENANTS = _REG.gauge("slo.tenants", "tenants currently tracked")


class P2Quantile:
    """Streaming quantile via the P² algorithm (Jain & Chlamtac, CACM
    1985): five markers track (min, q/2, q, (1+q)/2, max); marker heights
    move by parabolic (fallback linear) interpolation as observations
    stream in.  O(1) memory and per-observation work; accuracy is
    typically within a percentile or two of the exact sample quantile
    (held against the reference's on one seeded stream in
    tests/test_torch_obs.py).
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1): {q}")
        self.q = float(q)
        self.n = 0
        self._first: list = []           # the five seed observations
        self._h: list = []               # marker heights
        self._pos: list = []             # marker positions (1-based)
        self._want: list = []            # desired positions
        self._inc = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    def observe(self, x: float) -> None:
        x = float(x)
        if math.isnan(x):
            return
        self.n += 1
        if self.n <= 5:
            self._first.append(x)
            if self.n == 5:
                self._first.sort()
                self._h = list(self._first)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                q = self.q
                self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q,
                              3.0 + 2.0 * q, 5.0]
            return
        h, pos, want = self._h, self._pos, self._want
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x >= h[i]:
                    k = i
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            want[i] += self._inc[i]
        for i in (1, 2, 3):
            d = want[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                d = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, d)
                if not h[i - 1] < hp < h[i + 1]:
                    hp = self._linear(i, d)
                h[i] = hp
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._h, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i])
            / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1])
            / (pos[i] - pos[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, pos = self._h, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])

    def value(self) -> float:
        """Current estimate; exact while n <= 5 (sorted seed sample)."""
        if self.n == 0:
            return 0.0
        if self.n <= 5:
            s = sorted(self._first)
            idx = min(len(s) - 1, max(0, round(self.q * (len(s) - 1))))
            return s[int(idx)]
        return self._h[2]


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


class TenantSLO:
    """One tenant's accumulated SLO state.  ``budget`` is the allowed
    violation fraction of the error budget (default 1%% of solves may
    miss their deadline)."""

    def __init__(self, tenant: str, budget: float = 0.01):
        self.tenant = tenant
        self.budget = float(budget)
        self.solves = 0
        self.violations = 0
        self.failures = 0
        self.last_margin_ms: float = math.inf
        self.worst_margin_ms: float = math.inf
        self.latency_p50 = P2Quantile(0.50)
        self.latency_p95 = P2Quantile(0.95)
        self.margin_p05 = P2Quantile(0.05)   # pessimistic tail of margin

    def observe(self, summary: Optional[dict], *, wall_ms: float,
                failed: bool = False) -> None:
        self.solves += 1
        self.latency_p50.observe(wall_ms)
        self.latency_p95.observe(wall_ms)
        if failed:
            self.failures += 1
            self.violations += 1
            self.last_margin_ms = -math.inf
            self.worst_margin_ms = -math.inf
            return
        if summary is None:
            return
        margin = float(summary.get("worst_margin_ms", math.inf))
        self.last_margin_ms = margin
        self.worst_margin_ms = min(self.worst_margin_ms, margin)
        if math.isfinite(margin):
            self.margin_p05.observe(margin)
        if not summary.get("met", False):
            self.violations += 1

    @property
    def burn_rate(self) -> float:
        if self.solves == 0:
            return 0.0
        return (self.violations / self.solves) / self.budget

    def summary(self) -> dict:
        return {
            "tenant": self.tenant,
            "solves": self.solves,
            "violations": self.violations,
            "failures": self.failures,
            "budget": self.budget,
            "burn_rate": self.burn_rate,
            "last_margin_ms": self.last_margin_ms,
            "worst_margin_ms": self.worst_margin_ms,
            "margin_p05_ms": self.margin_p05.value(),
            "solve_p50_ms": self.latency_p50.value(),
            "solve_p95_ms": self.latency_p95.value(),
        }


class SLOTracker:
    """Per-tenant SLO accumulator for the solver service.  Thread-safe;
    mirrors every observation into tenant-labeled ``slo.*`` gauges so the
    scrape surface and ``/statz`` stay consistent with ``summary()``."""

    def __init__(self, budget: float = 0.01):
        self.budget = float(budget)
        self._lock = threading.RLock()
        self._tenants: Dict[str, TenantSLO] = {}

    def tenant(self, name: str) -> TenantSLO:
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = TenantSLO(name, self.budget)
                _G_TENANTS.set(len(self._tenants))
            return t

    def observe(self, tenant: str, summary: Optional[dict], *,
                wall_ms: float, failed: bool = False) -> None:
        t = self.tenant(tenant)
        with self._lock:
            t.observe(summary, wall_ms=wall_ms, failed=failed)
            lbl = {"tenant": tenant}
            _C_SOLVES.inc()
            _C_SOLVES.labels(**lbl).inc()
            if failed or (summary is not None
                          and not summary.get("met", False)):
                _C_VIOL.inc()
                _C_VIOL.labels(**lbl).inc()
            m = t.last_margin_ms
            _G_MARGIN.labels(**lbl).set(
                m if math.isfinite(m) else (-1e18 if m < 0 else 1e18))
            _G_P95.labels(**lbl).set(t.latency_p95.value())
            _G_BURN.labels(**lbl).set(t.burn_rate)

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            return {name: t.summary()
                    for name, t in sorted(self._tenants.items())}
