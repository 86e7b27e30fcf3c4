"""Zero-dependency metrics registry: counters, gauges, fixed-bucket
histograms, each a labelled family.

The port keeps a registry of its own (``registry()``), so its ``qn.*``,
``service.*``, ``fusion.*`` and ``cache.*`` metrics never mix with the
reference's when both packages run in one process (the parity tests do).
Design constraints:

  * **bit-compatible accounting** — counters hold exact ints and all
    mutations share ONE registry lock, so multi-metric updates (e.g. the
    five ``qn.*`` counters of one fused dispatch) are atomic and a
    snapshot can never tear across them.  ``qn_sim.sim_stats()`` and
    ``padding_stats()`` read straight from this registry and reproduce
    the reference's dicts;
  * **zero dependencies** — stdlib only; safe to import from every layer
    (kernels included) without cycles;
  * **cheap when idle** — an ``inc()`` is a lock + int add; no metric is
    sampled unless something calls ``snapshot()``.

Metric names are dotted (``qn.dispatches``, ``fusion.group_size``).

**Labels** (Prometheus-style): every metric is also a *family* — calling
``m.labels(tenant="job-0001")`` returns a child metric of the same kind
that shares the family's lock and bucket layout.  The bare metric keeps
its process-global meaning (``cache.hits`` is the total across every
label set — call sites increment both), so ``sim_stats()`` and the run
reports read the bare values.  Children appear in ``snapshot()`` under
``name{k="v",...}`` keys and render as label sets in the OpenMetrics
exporter (``repro_torch.obs.export``).  Cardinality is **bounded**: a
family accepts at most ``max_label_sets`` distinct children; further
label sets collapse into one ``_other`` overflow child and are counted in
``family.label_sets_dropped``.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: default bound on distinct label sets per metric family (overridable
#: per registry and per family) — sized for "hundreds of tenants", not
#: "one label set per request".
DEFAULT_MAX_LABEL_SETS = 256

#: the value every label collapses to once a family overflows its bound
OVERFLOW_LABEL_VALUE = "_other"


def labelset_key(kv: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    """Canonical child key: sorted ``(key, str(value))`` pairs."""
    return tuple(sorted((str(k), str(v)) for k, v in kv.items()))


def labeled_name(name: str, key: Tuple[Tuple[str, str], ...]) -> str:
    """Snapshot key of a labeled child: ``name{k="v",k2="v2"}``."""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class _Metric:
    """Shared family machinery: children, cardinality guard, reset."""

    def __init__(self, name: str, lock: Optional[threading.RLock] = None,
                 help: str = "", *,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self.name = name
        self.help = help
        self._lock = lock if lock is not None else threading.RLock()
        self.max_label_sets = int(max_label_sets)
        self.label_sets_dropped = 0
        self.labelset: Optional[Dict[str, str]] = None   # set on children
        self._children: Dict[tuple, "_Metric"] = {}

    # ------------------------------------------------------------- labels
    def _child_kwargs(self) -> dict:
        return {}

    def labels(self, **kv) -> "_Metric":
        """Get-or-create the child metric for this label set.  Children
        share the family lock (multi-metric updates stay atomic) and are
        bounded by ``max_label_sets``: once the family is full, every NEW
        label set maps to the single ``_other`` overflow child and
        ``label_sets_dropped`` counts the collapse."""
        if not kv:
            raise ValueError(f"{self.name}: labels() needs at least one "
                             "label")
        if self.labelset is not None:
            raise TypeError(f"{self.name}: labeled child metrics cannot "
                            "be labeled again")
        key = labelset_key(kv)
        with self._lock:
            m = self._children.get(key)
            if m is None:
                if len(self._children) >= self.max_label_sets:
                    self.label_sets_dropped += 1
                    key = labelset_key(
                        {k: OVERFLOW_LABEL_VALUE for k, _ in key})
                    m = self._children.get(key)
                    if m is None:
                        m = self._make_child(key)
                else:
                    m = self._make_child(key)
            return m

    def _make_child(self, key: tuple) -> "_Metric":
        child = type(self)(self.name, self._lock, self.help,
                           **self._child_kwargs())
        child.labelset = dict(key)
        self._children[key] = child
        return child

    def children(self) -> Dict[tuple, "_Metric"]:
        """Point-in-time copy of the child map (labelset key -> metric)."""
        with self._lock:
            return dict(self._children)

    # -------------------------------------------------------------- reset
    def _reset_self(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        """Zero this metric AND every labeled child (objects survive, so
        cached references in instrumented modules stay valid)."""
        with self._lock:
            self._reset_self()
            for c in self._children.values():
                c._reset_self()


class Counter(_Metric):
    """Monotonic integer counter (resettable)."""

    kind = "counter"

    def __init__(self, name: str, lock: Optional[threading.RLock] = None,
                 help: str = "", *,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        super().__init__(name, lock, help, max_label_sets=max_label_sets)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)

    def _reset_self(self) -> None:
        self.value = 0

    def snapshot(self):
        return int(self.value)


class Gauge(_Metric):
    """Last-written float value."""

    kind = "gauge"

    def __init__(self, name: str, lock: Optional[threading.RLock] = None,
                 help: str = "", *,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        super().__init__(name, lock, help, max_label_sets=max_label_sets)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def _reset_self(self) -> None:
        self.value = 0.0

    def snapshot(self):
        return float(self.value)


class Histogram(_Metric):
    """Fixed-bucket histogram: ``buckets`` are ascending upper bounds
    (``le``); one implicit ``+inf`` bucket catches the tail, so the bucket
    counts always sum to ``count`` (held against the reference's in
    ``tests/test_torch_obs.py``)."""

    kind = "histogram"

    def __init__(self, name: str, lock: Optional[threading.RLock] = None,
                 help: str = "", *,
                 buckets: Sequence[float] = (1, 2, 5, 10, 25, 50, 100),
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(
                tuple(buckets)):
            raise ValueError(f"buckets must be strictly ascending: {buckets}")
        super().__init__(name, lock, help, max_label_sets=max_label_sets)
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)   # + the +inf tail
        self.count = 0
        self.sum = 0.0

    def _child_kwargs(self) -> dict:
        return {"buckets": self.buckets}

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.bucket_counts[bisect_left(self.buckets, v)] += 1
            self.count += 1
            self.sum += v

    def _reset_self(self) -> None:
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0

    def snapshot(self):
        """Buckets + count/sum, plus the derived ``mean`` and the raw
        ``bounds`` list — exporters (``repro_torch.obs.export``) read the
        bounds straight from here instead of re-deriving them from the
        stringed bucket keys."""
        les = [str(b) for b in self.buckets] + ["+inf"]
        return {"buckets": dict(zip(les, list(self.bucket_counts))),
                "count": int(self.count), "sum": float(self.sum),
                "mean": (float(self.sum) / self.count if self.count
                         else 0.0),
                "bounds": list(self.buckets)}


class MetricsRegistry:
    """Named metric store with get-or-create semantics.

    ``lock`` is shared by every metric the registry creates — acquire it
    (it is reentrant) to make a multi-metric update atomic with respect to
    ``snapshot()``/``reset()``."""

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, help: str, **kw):
        with self.lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self.lock, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "", *,
                  buckets: Sequence[float] = (1, 2, 5, 10, 25, 50, 100),
                  ) -> Histogram:
        return self._get(name, Histogram, help, buckets=buckets)

    # ------------------------------------------------------------ reading
    def names(self) -> Iterable[str]:
        with self.lock:
            return sorted(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, object]:
        """Consistent point-in-time view: ``{name: value}`` (counters and
        gauges flat, histograms as ``{"buckets", "count", "sum"}``).
        Labeled children follow their family under ``name{k="v",...}``
        keys, so pre-label consumers that index by bare name are
        unaffected and per-tenant readers filter on the brace."""
        with self.lock:
            out: Dict[str, object] = {}
            for name, m in sorted(self._metrics.items()):
                if prefix is not None and not name.startswith(prefix):
                    continue
                out[name] = m.snapshot()
                for key, child in sorted(m._children.items()):
                    out[labeled_name(name, key)] = child.snapshot()
            return out

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero every metric (or only those under ``prefix``); metric
        objects and registrations survive, so cached references in
        instrumented modules stay valid."""
        with self.lock:
            for name, m in self._metrics.items():
                if prefix is None or name.startswith(prefix):
                    m.reset()


def counter_delta(before: Dict[str, object],
                  after: Dict[str, object]) -> Dict[str, object]:
    """Per-name difference of two ``snapshot()``s, for scalar metrics —
    the per-solve / per-benchmark view over the process-global registry.
    Histogram entries are passed through from ``after`` (deltas of bucket
    maps are rarely what a report wants)."""
    out: Dict[str, object] = {}
    for name, v in after.items():
        if isinstance(v, dict):
            out[name] = v
        else:
            b = before.get(name, 0)
            out[name] = v - (b if not isinstance(b, dict) else 0)
    return out


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumented layer reports into."""
    return _REGISTRY
