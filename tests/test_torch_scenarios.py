"""The repo's benchmarked public-cloud scenarios, the paper's Table 3 and
its serving analogue: the port (``benchmarks/torch_scenarios.py``) against
the live reference (``benchmarks/port_reference_decisions.py``, the same
keywords), in one process on the CPU at small budgets.

Replay-mode numbers must be equal bit for bit; exponential-mode response
times (vm_race's steady, turbo and value lanes) within a relative 1e-3,
room for the one-ulp ``log1p`` differences of the exponential draws
(the quick vm_race budgets measured a largest relative difference of
2.1e-7 when this test was written, torch 2.13 CPU against JAX 0.9.0).
Budgets, on one worker (~50 s in all): the ``race=False`` cases ~3 s
each, the vm_race pair ~22 s (computed once for its four tests), the two
Table 3 rows ~5 s, each serving tau ~4 s, the serving closed loop ~2 s.
"""
import json

import numpy as np
import pytest
import torch

from benchmarks import port_reference_decisions as ref
from benchmarks import torch_scenarios as port
from repro.core.optimizer import DSpace4Cloud as RefD
from repro.core.problem import ApplicationClass, JobProfile, Problem, VMType
from repro_torch.core import interop
from repro_torch.core.optimizer import DSpace4Cloud

torch.set_num_threads(1)    # the plain event loop is many tiny ops

M4 = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
            containers_per_core=2)
C20 = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)


def _replay_problem():
    """One class, two VM types both analytically feasible, replay lists
    from a numpy seed; 8 maps and 2 reduces keep the plain loop fast."""
    prof = JobProfile(n_map=8, n_reduce=2, m_avg=3000, m_max=7000,
                      r_avg=1500, r_max=3500)
    g = np.random.default_rng(3)
    samples = {}
    for vm in (M4, C20):
        f = 1.0 / vm.speed
        samples[("small", vm.name)] = (
            (g.lognormal(np.log(3000), 0.4, 256) * f).astype(np.float32),
            (g.lognormal(np.log(1500), 0.4, 128) * f).astype(np.float32))
    return Problem(classes=[ApplicationClass(
        name="small", h_users=4, think_ms=10_000, deadline_ms=9_000,
        eta=0.3, profiles={"m4.xlarge": prof, "c20.node": prof.scaled(1.35)})],
        vm_types=[M4, C20]), samples


def _decisions(rep):
    return {"dispatches": rep.qn_dispatches, "evals": rep.evals,
            "lanes": sorted(rep.traces),
            "classes": {k: v.as_dict() for k, v in rep.solutions.items()}}


@pytest.mark.parametrize("gait", ["run", "run_fast", "run_pointwise"])
def test_race_false_decisions_equal_the_reference(gait):
    """``DSpace4Cloud(race=False)`` locks each class to its analytic
    argmin (one lane) in every gait, with the reference's decisions,
    dispatches and replay-mode ``predicted_ms`` bit for bit; with the
    race on, the same problem runs two lanes (~3 s a case)."""
    prob, samples = _replay_problem()
    batched = gait != "run_pointwise"
    call = "run_fast" if gait == "run_fast" else "run"
    kw = dict(min_jobs=4, replications=1, batched=batched)
    want = _decisions(getattr(RefD(prob, samples=samples, race=False,
                                   **kw), call)())
    pprob = interop.problem_from_reference(prob.to_json())
    psamples = interop.samples_from_reference(samples)
    got = _decisions(getattr(DSpace4Cloud(pprob, samples=psamples,
                                          race=False, device="cpu", **kw),
                             call)())
    assert got == want
    assert len(got["lanes"]) == 1
    if batched:
        raced = DSpace4Cloud(pprob, samples=psamples, device="cpu", **kw)
        assert len(getattr(raced, call)().traces) == 2


@pytest.fixture(scope="module")
def vm_race_pair():
    """vm_race at the reference's quick budgets, in both packages."""
    kw = dict(min_jobs=8, replications=1)
    return ref.vm_race(**kw), port.vm_race("cpu", **kw)


def test_vm_race_decisions_equal_the_reference(vm_race_pair):
    """Locked against raced: the reference's VM types, nu, costs and
    dispatch counts (1.300 -> 1.105, steady -> turbo, 1 -> 2 dispatches
    at these budgets); exponential-mode response times within 1e-3."""
    want, got = vm_race_pair
    for k in ("locked", "raced", "single_type"):
        assert port.mismatches(want[k], got[k], rel=1e-3) == [], k
    assert (got["locked"]["vm_type"], got["raced"]["vm_type"]) == \
        ("steady", "turbo")
    assert got["raced"]["cost_per_h"] < got["locked"]["cost_per_h"]
    assert (got["locked"]["dispatches"], got["raced"]["dispatches"]) == \
        (want["locked"]["dispatches"], want["raced"]["dispatches"])


def test_vm_race_prunes_the_reference_lane(vm_race_pair):
    """Lower-bound pruning retires the same lane with the same bound
    (micro, 2.4), and the mixed fusion group's replay lane (micro) gives
    the reference's response times bit for bit."""
    want, got = vm_race_pair
    assert port.mismatches(want["lanes"], got["lanes"], rel=1e-3) == []
    assert port.mismatches(want["lanes"]["etl@micro"],
                           got["lanes"]["etl@micro"]) == []
    assert got["lanes_pruned"] == want["lanes_pruned"] == 1
    assert got["lanes"]["etl@micro"]["pruned"]
    assert got["lanes"]["etl@micro"]["bound"] == 2.4


def test_vm_race_lanes_match_solo_sweeps(vm_race_pair):
    """Every raced lane's points equal a solo sweep of that lane."""
    want, got = vm_race_pair
    assert want["parity_bit_exact"] and got["parity_bit_exact"]


def test_vm_race_single_type_degenerates_to_locked(vm_race_pair):
    want, got = vm_race_pair
    assert want["degenerate_single_type"] and got["degenerate_single_type"]
    st = got["single_type"]
    assert st["raced"]["dispatches"] == st["locked"]["dispatches"]


@pytest.mark.parametrize("row", [3, 11])
def test_table3_row_equals_the_reference(row):
    """Table 3's smallest rows (Q2, 3 users, 4/4 tasks; Q5, 64/68) at
    reduced budgets (T over 10 jobs, tau over 2 jobs past the 8 warm-up
    ones, one replication: 512 and 4096 events): T and tau equal the
    reference's bit for bit (~2 s a row)."""
    kw = dict(rows=[row], max_jobs=10, min_jobs=2, replications=1)
    want, got = ref.table3(**kw), port.table3("cpu", **kw)
    assert port.mismatches(want, got) == []
    r = got["rows"][0]
    assert r["kernels"] == {} and r["launches"] == 0    # the plain loop
    assert np.isfinite(r["tau_ms"]) and r["T_ms"] > 0


@pytest.mark.parametrize("solo_ms", ref.SOLO_MS)
def test_serving_tau_equals_the_reference(solo_ms):
    """The serving analogue's tau for a fixed profiled round time, at the
    reference's 12 requests on 3 slots (2048 events, 2 replications:
    ~4 s)."""
    assert port.serving_tau(solo_ms, device="cpu") == \
        ref.serving_tau(solo_ms)


def test_serving_closed_loop_on_the_cpu():
    """The serving analogue end to end on granite-3-2b's smoke config at a
    small size (4 requests, 2 slots, 3 tokens): tau from the measured
    round time equals the reference's tau from the same round time; T and
    theta are measurements, only checked to be finite."""
    out = port.serving_qn("cpu", n_requests=4, slots=2, prompt_len=8,
                          gen_len=3, runs=1)
    assert out["qn_tau_ms"] == ref.serving_tau(out["solo_latency_ms"],
                                               n_requests=4, slots=2)
    assert all(np.isfinite(out[k]) and out[k] > 0
               for k in ("solo_latency_ms", "qn_tau_ms", "engine_T_ms"))
    assert out["n_layers"] == 2 and out["prefills"] == 2 + 1 + 6
    json.dumps(out)


def test_cost_deadline_summaries_match_the_reference_benchmark():
    """The crossover and cost monotonicity rules of the port's
    cost_deadline equal ``benchmarks/cost_deadline.py``'s on a grid with a
    CINECA-only region, a cheaper-CINECA deadline and an infeasible
    point."""
    from benchmarks.cost_deadline import _crossover
    pts = []
    for d, m4, cin in ((300, 2.0, 3.0), (200, 4.0, 3.5), (100, None, 5.0),
                       (80, None, None)):
        for vm, c in (("m4.xlarge", m4), ("CINECA", cin)):
            pts.append({"deadline_s": d, "vm": vm, "feasible": c is not None,
                        **({"cost_per_h": c} if c is not None else {})})
    assert port.crossover(pts) == _crossover(pts) == 200
    assert port.mono_cost(pts) == ref.mono_cost(pts) is True
    pts[0]["cost_per_h"] = 9.0
    assert port.mono_cost(pts) == ref.mono_cost(pts) is False


@pytest.mark.parametrize("case", [
    ({"a": 1.0}, {"a": 1.0, "b": 2}, 0.0, []),
    ({"a": [1, 2]}, {"a": [1, 2, 3]}, 0.0, ["a"]),
    ({"predicted_ms": 1000.0}, {"predicted_ms": 1000.5}, 1e-3, []),
    ({"predicted_ms": 1000.0}, {"predicted_ms": 1002.0}, 1e-3,
     ["predicted_ms"]),
    ({"cost": 1000.0}, {"cost": 1000.5}, 1e-3, ["cost"]),
    ({"x": {"predicted_ms": [1.0, 2.0]}}, {"x": {"predicted_ms": [1.0, 2.0]}},
     0.0, []),
    ({"f": True}, {"f": 1}, 0.0, ["f"]),
    ({"c": None}, {"c": 200}, 0.0, ["c"]),
    ({"n": 7}, {"n": 7.0}, 0.0, []),
])
def test_mismatches(case):
    """The comparison ``chip_smoke.py`` holds the port to: ``got`` may hold
    more keys, the tolerance applies only under ``predicted_ms``, and a bool
    is not a number."""
    want, got, rel, diff = case
    assert port.mismatches(want, got, rel=rel) == diff
