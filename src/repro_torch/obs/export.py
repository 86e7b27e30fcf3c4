"""OpenMetrics text exposition for the metrics registry.

``render_openmetrics()`` turns one consistent registry snapshot into the
OpenMetrics text format (the Prometheus scrape wire format): dotted repo
names become underscore metric names (``qn.dispatches`` →
``qn_dispatches``), counters gain the mandatory ``_total`` sample
suffix, histograms expose *cumulative* ``_bucket{le=...}`` series plus
``_sum``/``_count``, labeled children render as proper label sets, and
the payload terminates with ``# EOF``.

``parse_openmetrics()`` is the matching reader — not a full spec parser,
but strict about everything we emit (type lines, label quoting, the EOF
terminator, cumulative bucket monotonicity).  The round-trip
``parse(render(reg))`` is asserted in tests and again by
``chip_smoke.py``'s scrape of a live service, so the exposition is
validated on every run, not trusted.  The rendering is the reference's,
so either package's parser reads the other's payload.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, labeled_name
from .metrics import registry as _registry

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def metric_name(dotted: str) -> str:
    """OpenMetrics-legal name for a dotted registry name."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", dotted)
    if not _NAME_OK.match(name):
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    """Sample value formatting: integers stay integral, non-finite uses
    the OpenMetrics spellings (+Inf/-Inf/NaN)."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(labelset: Optional[Dict[str, str]],
            extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs: List[Tuple[str, str]] = []
    if labelset:
        pairs.extend(sorted(labelset.items()))
    if extra:
        pairs.extend(extra)
    if not pairs:
        return ""
    def esc(v: str) -> str:
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs) + "}"


def _render_one(lines: List[str], name: str, m) -> None:
    """All samples of one metric family (base series + labeled children),
    in the order OpenMetrics requires: TYPE/HELP once, then samples."""
    lines.append(f"# TYPE {name} {m.kind}")
    if m.help:
        lines.append(f"# HELP {name} {m.help}")
    series = [(None, m)] + [(dict(k), c) for k, c in sorted(
        m.children().items())]
    for labelset, s in series:
        if m.kind == "counter":
            lines.append(f"{name}_total{_labels(labelset)} "
                         f"{_fmt(s.snapshot())}")
        elif m.kind == "gauge":
            lines.append(f"{name}{_labels(labelset)} {_fmt(s.snapshot())}")
        else:                                             # histogram
            snap = s.snapshot()
            cum = 0
            bounds = list(snap["bounds"]) + [math.inf]
            counts = list(snap["buckets"].values())
            for le, n in zip(bounds, counts):
                cum += n
                le_s = "+Inf" if math.isinf(le) else _fmt(le)
                lines.append(
                    f"{name}_bucket{_labels(labelset, [('le', le_s)])} "
                    f"{cum}")
            lines.append(f"{name}_sum{_labels(labelset)} "
                         f"{_fmt(snap['sum'])}")
            lines.append(f"{name}_count{_labels(labelset)} "
                         f"{snap['count']}")


def render_openmetrics(reg: Optional[MetricsRegistry] = None) -> str:
    """The whole registry as one OpenMetrics text payload.  Taken under
    the registry lock, so the scrape is a consistent point-in-time view
    even while solver threads are mutating counters."""
    reg = reg if reg is not None else _registry()
    lines: List[str] = []
    with reg.lock:
        for dotted in reg.names():
            _render_one(lines, metric_name(dotted), reg.get(dotted))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------- parsing

_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$')
_LABEL = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|'
                    r'\\.)*)"')


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)


def parse_openmetrics(text: str) -> Dict[str, dict]:
    """Parse an OpenMetrics payload we rendered: returns ``{family:
    {"type", "help", "samples": {sample_key: value}}}`` where
    ``sample_key`` is the full sample name with its label string.
    Raises ``ValueError`` on anything malformed — missing ``# EOF``,
    samples before a TYPE line, bad label quoting, non-monotonic
    cumulative buckets — which makes it the validator the scrape smoke
    runs against a live endpoint."""
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("payload does not end with # EOF")
    fams: Dict[str, dict] = {}
    current: Optional[str] = None
    for ln in lines[:-1]:
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            _, _, rest = ln.partition("# TYPE ")
            parts = rest.split(" ")
            if len(parts) != 2 or parts[1] not in (
                    "counter", "gauge", "histogram"):
                raise ValueError(f"bad TYPE line: {ln!r}")
            current = parts[0]
            if not _NAME_OK.match(current):
                raise ValueError(f"bad metric name: {current!r}")
            if current in fams:
                raise ValueError(f"duplicate TYPE for {current!r}")
            fams[current] = {"type": parts[1], "help": "", "samples": {}}
            continue
        if ln.startswith("# HELP "):
            _, _, rest = ln.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            if name != current:
                raise ValueError(f"HELP for {name!r} outside its family")
            fams[name]["help"] = help_text
            continue
        if ln.startswith("#"):
            raise ValueError(f"unexpected comment line: {ln!r}")
        m = _SAMPLE.match(ln)
        if not m:
            raise ValueError(f"malformed sample line: {ln!r}")
        sample = m.group("name")
        fam = _family_of(sample, fams)
        if fam is None or fam != current:
            raise ValueError(f"sample {sample!r} outside its TYPE block")
        raw = m.group("labels")
        if raw:
            stripped = _LABEL.sub("", raw).replace(",", "")
            if stripped:
                raise ValueError(f"bad label syntax in {ln!r}")
        fams[fam]["samples"][ln.rsplit(" ", 1)[0]] = _parse_value(
            m.group("value"))
    _check_histograms(fams)
    return fams


def _family_of(sample: str, fams: Dict[str, dict]) -> Optional[str]:
    """Map a sample name back to its family (counters sample as
    ``_total``; histograms as ``_bucket``/``_sum``/``_count``)."""
    if sample in fams and fams[sample]["type"] == "gauge":
        return sample
    for suffix in ("_total", "_bucket", "_sum", "_count"):
        if sample.endswith(suffix):
            base = sample[: -len(suffix)]
            if base in fams:
                return base
    return None


def _check_histograms(fams: Dict[str, dict]) -> None:
    for name, fam in fams.items():
        if fam["type"] != "histogram":
            continue
        by_series: Dict[str, List[Tuple[float, float]]] = {}
        for key, v in fam["samples"].items():
            if not key.startswith(f"{name}_bucket"):
                continue
            labels = key[len(f"{name}_bucket"):]
            le = None
            rest = []
            for lm in _LABEL.finditer(labels):
                if lm.group("k") == "le":
                    le = _parse_value(lm.group("v"))
                else:
                    rest.append((lm.group("k"), lm.group("v")))
            if le is None:
                raise ValueError(f"bucket sample without le: {key!r}")
            by_series.setdefault(str(sorted(rest)), []).append((le, v))
        for series in by_series.values():
            series.sort(key=lambda t: t[0])
            if not series or not math.isinf(series[-1][0]):
                raise ValueError(f"{name}: histogram missing +Inf bucket")
            counts = [c for _, c in series]
            if counts != sorted(counts):
                raise ValueError(f"{name}: non-cumulative buckets")


__all__ = ["render_openmetrics", "parse_openmetrics", "metric_name",
           "labeled_name"]
