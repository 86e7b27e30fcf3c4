"""The port's telemetry plane (``repro_torch.obs``) against the reference's
(``repro.obs``), in one process: the labelled metric families and their
cardinality guard, histograms, snapshots and resets on two fresh
registries fed the same calls; the P² quantile and the per-tenant SLO
tracker on one seeded stream (exact floats); the OpenMetrics text each
package renders, parsed by both parsers; the Chrome trace export checked
by both validators; the flight recorder's ring; and the provenance stamp
(no JAX key, nothing raised without a card).  The ``qn.*`` counters that
``sim_stats()`` and ``padding_stats()`` read stay exact ints on the new
metric base."""
import json
import math

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.obs import export as ref_export
from repro.obs import metrics as ref_metrics
from repro.obs import slo as ref_slo
from repro_torch import obs
from repro_torch.core import qn_sim
from repro_torch.obs import export, metrics, recorder, slo, trace

torch.set_num_threads(1)


def _drive(m, *, max_label_sets=4):
    """One sequence of label, histogram and reset calls on registry
    module ``m``; returns the snapshots taken along the way."""
    reg = m.MetricsRegistry()
    c = reg.counter("svc.points", "points requested")
    g = reg.gauge("svc.inflight")
    h = reg.histogram("svc.round_ms", buckets=(1, 5, 25, 100))
    c.max_label_sets = max_label_sets
    snaps = []
    rng = np.random.default_rng(0)
    for i in range(12):
        t = f"tenant-{i % 7}"
        c.inc(3)
        c.labels(tenant=t).inc(i)
        g.labels(tenant=t, kind="dag" if i % 2 else "mr").set(i / 3)
        v = float(rng.exponential(20.0))
        h.observe(v)
        h.labels(tenant=t).observe(v)
        if i == 6:
            snaps.append(reg.snapshot())
            reg.reset("svc.round")
    snaps.append(reg.snapshot())
    snaps.append(reg.snapshot("svc.g"))
    snaps.append(sorted(reg.names()))
    snaps.append(c.label_sets_dropped)
    snaps.append(sorted(c.children()))
    return snaps


def test_labelled_families_match_the_reference():
    assert _drive(metrics) == _drive(ref_metrics)


@pytest.mark.parametrize("bound", [1, 3, 7])
def test_cardinality_guard_collapses_to_other_at_the_same_count(bound):
    got, want = _drive(metrics, max_label_sets=bound), \
        _drive(ref_metrics, max_label_sets=bound)
    assert got == want
    keys = got[-1]
    assert len(keys) == bound + (1 if bound < 7 else 0)
    if bound < 7:
        assert (("tenant", metrics.OVERFLOW_LABEL_VALUE),) in keys
        assert got[-2] > 0


def test_metric_kinds_and_errors_match_the_reference():
    for m in (metrics, ref_metrics):
        reg = m.MetricsRegistry()
        reg.counter("a")
        with pytest.raises(TypeError):
            reg.gauge("a")
        with pytest.raises(ValueError):
            reg.histogram("h", buckets=(5, 1))
        with pytest.raises(ValueError):
            reg.counter("b").labels()
        with pytest.raises(TypeError):
            reg.counter("b").labels(t="x").labels(u="y")
    before = {"a": 1, "h": {"count": 1}, "b": 5}
    after = {"a": 4, "h": {"count": 2}, "c": 2, "b": 5}
    assert metrics.counter_delta(before, after) == \
        ref_metrics.counter_delta(before, after)
    assert metrics.labeled_name("x", metrics.labelset_key({"b": 1, "a": 2})) \
        == ref_metrics.labeled_name(
            "x", ref_metrics.labelset_key({"b": 1, "a": 2}))


def test_port_registry_is_its_own_and_sim_stats_read_it():
    assert obs.registry() is not ref_obs.registry()
    snap = obs.registry().snapshot("qn.")
    stats = qn_sim.sim_stats()
    assert all(snap[f"qn.{k}"] == v and type(v) is int
               for k, v in stats.items())
    pad = qn_sim.padding_stats()
    assert set(pad) == {"bucket_padded_lanes", "bucket_padded_events",
                        "shard_padded_lanes", "shard_padded_events",
                        "batch_padded_events", "events_total",
                        "events_useful"}
    assert qn_sim.dispatch_count() == stats["dispatches"]


def test_p2_quantile_equals_the_reference_on_a_seeded_stream():
    xs = np.random.default_rng(5).lognormal(3.0, 1.0, 2000)
    for q in (0.05, 0.5, 0.95):
        a, b = slo.P2Quantile(q), ref_slo.P2Quantile(q)
        vals = []
        for i, x in enumerate(xs):
            a.observe(x)
            b.observe(x)
            if i in (0, 3, 4, 5, 99, 1999):
                vals.append((a.value(), b.value()))
        assert all(u == v for u, v in vals), (q, vals)
    with pytest.raises(ValueError):
        slo.P2Quantile(1.0)


def test_slo_tracker_equals_the_reference():
    rng = np.random.default_rng(9)
    a, b = slo.SLOTracker(budget=0.05), ref_slo.SLOTracker(budget=0.05)
    for i in range(40):
        tenant = f"t{i % 3}"
        wall = float(rng.uniform(5, 500))
        if i % 11 == 10:
            a.observe(tenant, None, wall_ms=wall, failed=True)
            b.observe(tenant, None, wall_ms=wall, failed=True)
            continue
        margin = float(rng.normal(1000, 800))
        summary = {"worst_margin_ms": margin, "met": margin >= 0}
        a.observe(tenant, summary, wall_ms=wall)
        b.observe(tenant, summary, wall_ms=wall)
    assert a.summary() == b.summary()
    snap = obs.registry().snapshot("slo.")
    assert snap['slo.burn_rate{tenant="t0"}'] == a.tenant("t0").burn_rate


def _registry_with_series(m):
    reg = m.MetricsRegistry()
    reg.counter("cache.hits", "hits").inc(3)
    reg.counter("cache.hits").labels(tenant='a"b').inc(2)
    reg.gauge("slo.margin_ms").labels(tenant="t").set(-math.inf)
    reg.gauge("qn.padded_waste_ratio").set(0.25)
    h = reg.histogram("service.round_ms", "round wall",
                      buckets=(1, 5, 10))
    for v in (0.5, 3, 7, 70):
        h.observe(v)
        h.labels(tenant="t").observe(v)
    return reg


def test_openmetrics_parses_with_both_parsers():
    text = export.render_openmetrics(_registry_with_series(metrics))
    assert text == ref_export.render_openmetrics(
        _registry_with_series(ref_metrics))
    got, want = export.parse_openmetrics(text), \
        ref_export.parse_openmetrics(text)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["service_round_ms"]["samples"][
        'service_round_ms_bucket{le="+Inf"}'] == 4
    live = export.render_openmetrics()
    assert export.parse_openmetrics(live).keys() == \
        ref_export.parse_openmetrics(live).keys()


@pytest.mark.parametrize("bad", [
    "# TYPE a counter\na_total 1\n",                        # no EOF
    "a_total 1\n# EOF\n",                                   # no TYPE
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\n"
    "h_bucket{le=\"+Inf\"} 1\n# EOF\n",                     # not cumulative
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\n# EOF\n",    # no +Inf
    "# TYPE a counter\na_total{x=1} 1\n# EOF\n",            # bad label
])
def test_openmetrics_parser_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        ref_export.parse_openmetrics(bad)
    with pytest.raises(ValueError):
        export.parse_openmetrics(bad)


def test_chrome_trace_passes_both_validators(tmp_path):
    with trace.tracing() as t:
        with trace.span("service.run", cat="service", jobs=2):
            with trace.span("service_round", cat="service", round=1):
                with trace.span("fused_dispatch", cat="fusion",
                                kind="mapreduce", obj=object()):
                    with trace.span("kernel:plain", cat="kernel",
                                    lanes=4):
                        pass
    chrome = t.save(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == chrome
    assert trace.validate_chrome_trace(chrome) == 4
    assert ref_obs.validate_chrome_trace(chrome) == 4
    (k,) = t.find(name="kernel:plain")
    assert t.chain(k) == ["service.run", "service_round", "fused_dispatch",
                          "kernel:plain"]
    fused = [e for e in chrome["traceEvents"]
             if e["name"] == "fused_dispatch"][0]
    assert "obj" not in fused["args"] and fused["args"]["kind"] == \
        "mapreduce"
    with pytest.raises(ValueError):
        trace.validate_chrome_trace({"traceEvents": [chrome["traceEvents"][0]]})


def test_flight_recorder_ring_matches_the_reference(tmp_path):
    from repro.obs.recorder import FlightRecorder as RefRecorder
    a, b = recorder.FlightRecorder(3), RefRecorder(3)
    for i in range(5):
        a.record("round", tenant=f"t{i % 2}", n=i)
        b.record("round", tenant=f"t{i % 2}", n=i)
    assert a.stats() == b.stats() == {"capacity": 3, "recorded": 5,
                                      "buffered": 3, "dropped": 2}
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("t",
                                                                  "wall")}
                         for e in evs]
    assert strip(a.events()) == strip(b.events())
    assert strip(a.events("round")) == strip(a.events())[-3:]
    dump = a.save(tmp_path / "fr.json")
    assert "jax" not in dump["provenance"]
    a.clear()
    assert a.stats()["recorded"] == 0
    with pytest.raises(ValueError):
        recorder.FlightRecorder(0)


def test_provenance_has_no_jax_key_and_degrades_without_a_card():
    p = obs.provenance()
    assert "jax" not in p
    assert p["torch"] == torch.__version__
    assert p["python"] and p["platform"]
    assert p["shard"]["spec"] == "off" and p["shard"]["shards"] == 1
    if not torch.cuda.is_available():
        assert p["device"] is None and p["devices"] == 0
