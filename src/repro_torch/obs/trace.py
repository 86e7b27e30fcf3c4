"""Span tracing for the solve → fusion → kernel stack.

A :class:`Tracer` records a tree of timed spans per process:
``solve → tier (kkt/amva/qn) → race_round → fused_dispatch →
kernel:{cuda,plain}``, each span carrying its arguments (a kernel span
holds the dispatch's lanes, scan length, ``max_slots`` and ``h_users``).
Service runs add ``service.run → service_round → flush`` above the
dispatch.  ``summary()`` aggregates the spans per name for
``RunReport.telemetry``; export is Chrome trace-event JSON
(``to_chrome()``/``save()``) loadable in Perfetto or
``chrome://tracing``, and ``validate_chrome_trace`` checks its schema.
The reference's JAX profiler bridge has no counterpart: on the card,
``torch.profiler`` sees the kernels themselves.

Design rules, learned from the propose/receive architecture:

  * spans are **per-thread stacks** (``threading.local``);
  * a span must **never be held across a generator yield**
    (``sweep_requests``/``race_requests``/``run_steps`` suspend
    mid-round): instrumentation lives in the loops that run them and in code that runs to
    completion inside one round;
  * tracing is **opt-in and zero-overhead when off** — the module-level
    ``span()`` helper is a no-op context manager unless a tracer is
    installed, so the hot path pays one global read per call site.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


@dataclass
class Span:
    sid: int
    parent: Optional[int]
    name: str
    cat: str
    ts_us: float
    dur_us: float
    tid: int
    depth: int
    args: Dict[str, Any] = field(default_factory=dict)


class Tracer:
    """Collects completed spans; thread-safe; bounded by ``max_spans``
    (excess spans are counted in ``dropped``, never raised)."""

    def __init__(self, *, max_spans: int = 200_000):
        self.spans: List[Span] = []
        self.dropped = 0
        self.max_spans = max_spans
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._sid = itertools.count(1)
        self._local = threading.local()

    # ------------------------------------------------------------ recording
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, *, cat: str = "repro",
             **args: Any) -> Iterator[Span]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        s = Span(sid=next(self._sid),
                 parent=parent.sid if parent else None,
                 name=name, cat=cat, ts_us=self._now_us(), dur_us=0.0,
                 tid=threading.get_ident(), depth=len(stack),
                 args=dict(args))
        stack.append(s)
        try:
            yield s
        finally:
            stack.pop()
            s.dur_us = self._now_us() - s.ts_us
            with self._lock:
                if len(self.spans) < self.max_spans:
                    self.spans.append(s)
                else:
                    self.dropped += 1

    # ------------------------------------------------------------ reading
    def by_name(self, name: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def find(self, **kw: Any) -> List[Span]:
        with self._lock:
            return [s for s in self.spans
                    if all(getattr(s, k, None) == v for k, v in kw.items())]

    def chain(self, span: Span) -> List[str]:
        """Ancestor names root→span (inclusive), for span-tree assertions."""
        with self._lock:
            by_sid = {s.sid: s for s in self.spans}
        names, cur = [], span
        while cur is not None:
            names.append(cur.name)
            cur = by_sid.get(cur.parent) if cur.parent is not None else None
        return names[::-1]

    def summary(self) -> Dict[str, Any]:
        """Aggregate per-name stats — this is what
        ``RunReport.telemetry["spans"]`` carries."""
        with self._lock:
            spans = list(self.spans)
            dropped = self.dropped
        agg: Dict[str, Dict[str, float]] = {}
        for s in spans:
            a = agg.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                        "max_ms": 0.0})
            a["count"] += 1
            a["total_ms"] += s.dur_us / 1e3
            a["max_ms"] = max(a["max_ms"], s.dur_us / 1e3)
        for a in agg.values():
            a["total_ms"] = round(a["total_ms"], 3)
            a["max_ms"] = round(a["max_ms"], 3)
        return {"spans": dict(sorted(agg.items())),
                "n_spans": len(spans), "dropped": dropped,
                "max_depth": max((s.depth for s in spans), default=-1) + 1}

    # ------------------------------------------------------------ export
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object: "X" complete events (+ one "M"
        process_name metadata event).  Perfetto reconstructs nesting from
        time containment per (pid, tid)."""
        with self._lock:
            spans = list(self.spans)
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "repro_torch"},
        }]
        for s in spans:
            args = {k: v for k, v in s.args.items()
                    if isinstance(v, (str, int, float, bool, type(None)))}
            args["sid"] = s.sid
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({"name": s.name, "cat": s.cat, "ph": "X",
                           "ts": round(s.ts_us, 3),
                           "dur": round(s.dur_us, 3),
                           "pid": 1, "tid": s.tid, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path) -> Dict[str, Any]:
        obj = self.to_chrome()
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


def validate_chrome_trace(obj: Any) -> int:
    """Validate a Chrome trace-event JSON object; returns the number of
    duration ("X") events.  Raises ``ValueError`` on any schema problem —
    ``chip_smoke.py``'s service drive runs its trace through this."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    n_x = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "M", "B", "E", "i", "C"):
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"event {i}: missing name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                raise ValueError(f"event {i}: {k} must be an int")
        if ph == "X":
            n_x += 1
            for k in ("ts", "dur"):
                v = ev.get(k)
                if not isinstance(v, (int, float)) or v < 0:
                    raise ValueError(f"event {i}: bad {k}: {v!r}")
            if "args" in ev and not isinstance(ev["args"], dict):
                raise ValueError(f"event {i}: args must be an object")
    if n_x == 0:
        raise ValueError("trace has no duration events")
    return n_x


# ---------------------------------------------------------------- active
# One installed tracer per process.  Call sites use the module-level
# span() helper, which no-ops (single global read) when nothing is
# installed.
_ACTIVE: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def uninstall() -> Optional[Tracer]:
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    return t


def active() -> Optional[Tracer]:
    return _ACTIVE


@contextmanager
def _noop() -> Iterator[None]:
    yield None


def span(name: str, *, cat: str = "repro", **args: Any):
    """Open a span on the installed tracer, or no-op if tracing is off."""
    t = _ACTIVE
    if t is None:
        return _noop()
    return t.span(name, cat=cat, **args)


@contextmanager
def tracing(**kw: Any) -> Iterator[Tracer]:
    """``with tracing() as t:`` — install a fresh tracer for the block and
    uninstall it after (restoring any previously-installed tracer)."""
    prev = _ACTIVE
    t = install(Tracer(**kw))
    try:
        yield t
    finally:
        install(prev) if prev is not None else uninstall()
