"""Zero-dependency metrics registry: counters and gauges.

The port keeps a registry of its own, so its ``qn.*`` counters never mix
with the reference's when both packages run in one process (the parity
tests do).  Design constraints:

  * **bit-compatible accounting** — counters hold exact ints and all
    mutations share ONE registry lock, so multi-metric updates (e.g. the
    five ``qn.*`` counters of one fused dispatch) are atomic and a reader
    can never tear across them.  ``qn_sim.sim_stats()`` reads straight
    from this registry and reproduces the reference's dict;
  * **zero dependencies** — stdlib only; safe to import from every layer
    (kernels included) without cycles;
  * **cheap when idle** — an ``inc()`` is a lock + int add.

Metric names are dotted (``qn.dispatches``, ``qn.compiles``).  The
reference's labelled families (per-tenant children) belong to its service
plane, which is not ported yet.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional


class Counter:
    """Monotonic integer counter (resettable)."""

    kind = "counter"

    def __init__(self, name: str, lock: Optional[threading.RLock] = None,
                 help: str = ""):
        self.name = name
        self.help = help
        self._lock = lock if lock is not None else threading.RLock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class Gauge:
    """Last-written float value."""

    kind = "gauge"

    def __init__(self, name: str, lock: Optional[threading.RLock] = None,
                 help: str = ""):
        self.name = name
        self.help = help
        self._lock = lock if lock is not None else threading.RLock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


class MetricsRegistry:
    """Named metric store with get-or-create semantics.

    ``lock`` is shared by every metric the registry creates — acquire it
    (it is reentrant) to make a multi-metric update atomic."""

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, help: str):
        with self.lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self.lock, help)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumented layer reports into."""
    return _REGISTRY
