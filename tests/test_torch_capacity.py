"""The TPU capacity planner (``core/capacity``), ``ElasticPlan.
replan_capacity`` and the ``plan`` CLI: the port against the live
reference in one process on the CPU.

Slots, step times, KV bytes, profiles, serving problems, the KKT plans and
the training plans are host arithmetic in float64 and must be equal
exactly.  A QN-verified plan's decision and its QN dispatch count must be
equal; its predicted_ms within a relative 1e-3 (exponential mode, the
planner's contract: the one-ulp ``log1p`` differences of the draws).
Budgets on one worker: each QN plan ~0.3 s in the port and ~1 s in the
reference; the drive as ``chip_smoke.py`` runs it ~6 s a package.
"""
import json
import sys

import pytest
import torch

from benchmarks import port_reference_decisions as ref_drive
from benchmarks import torch_scenarios as port_drive
from repro.configs.registry import ARCH_IDS
from repro.core import capacity as rc
from repro.core import qn_sim as ref_qn_sim
from repro.distributed.fault import ElasticPlan as RefElasticPlan
from repro.launch import plan as ref_plan
from repro_torch.core import capacity as pc
from repro_torch.core import qn_sim as port_qn_sim
from repro_torch.distributed.fault import ElasticPlan
from repro_torch.launch import plan as port_plan

torch.set_num_threads(1)    # the plain event loop is many tiny ops

QN_REL = 1e-3
SERVING = {spec[0]: spec for spec in port_drive.CAPACITY_SERVING}


def _costs(mod):
    return {k: mod.CellCost(*v) for k, v in port_drive.CAPACITY_COSTS.items()}


def _every_arch_costs(mod):
    """Synthetic costs for every registry arch (each arch's own scale; the
    SSM arch without a prefill cell, which takes the state-build branch)."""
    out = {}
    for i, arch in enumerate(ARCH_IDS):
        f = 1.0 + 0.37 * i
        out[(arch, "train_4k")] = mod.CellCost(4.5e12 * f, 6.0e11 / f,
                                               2.0e7 * f)
        out[(arch, "decode_32k")] = mod.CellCost(2.0e9 * f, 3.0e9 * f,
                                                 5.0e6 / f)
        if arch != "mamba2-780m":
            out[(arch, "prefill_32k")] = mod.CellCost(1.2e12 * f,
                                                      2.5e11 * f, 1.0e7)
    return out


def _decisions(sols):
    return {k: {f: v.as_dict()[f] for f in port_drive.DECISION_KEYS}
            for k, v in sols.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_slots_step_times_and_profiles_every_arch_and_slice(arch):
    assert pc.kv_bytes_per_token(arch) == rc.kv_bytes_per_token(arch)
    ref_costs, port_costs = _every_arch_costs(rc), _every_arch_costs(pc)
    assert [s.name for s in pc.SLICE_CATALOG] == \
        [s.name for s in rc.SLICE_CATALOG]
    for r_slc, p_slc in zip(rc.SLICE_CATALOG, pc.SLICE_CATALOG):
        assert (p_slc.hourly_reserved, p_slc.hourly_preemptible) == \
            (r_slc.hourly_reserved, r_slc.hourly_preemptible)
        for key, cost in ref_costs.items():
            assert pc.step_time_ms(port_costs[key], p_slc) == \
                rc.step_time_ms(cost, r_slc), (key, p_slc.name)
        for spec in port_drive.CAPACITY_SERVING:
            kw = dict(zip(("name", "arch", "prompt_len", "gen_len",
                           "h_sessions", "think_ms", "deadline_ms"),
                          (spec[0], arch, *spec[2:])))
            r_cls, p_cls = rc.ServingClass(**kw), pc.ServingClass(**kw)
            assert pc.slice_slots(p_cls, p_slc) == \
                rc.slice_slots(r_cls, r_slc), (spec[0], p_slc.name)
            r_prof = rc.serving_profile(r_cls, r_slc, ref_costs)
            p_prof = pc.serving_profile(p_cls, p_slc, port_costs)
            assert vars(p_prof) == vars(r_prof), (spec[0], p_slc.name)


@pytest.mark.parametrize("name", list(SERVING))
def test_serving_problem_and_kkt_plan(name):
    r_pl = rc.TPUCapacityPlanner(_costs(rc))
    p_pl = pc.TPUCapacityPlanner(_costs(pc), device="cpu")
    r_cls, p_cls = rc.ServingClass(*SERVING[name]), \
        pc.ServingClass(*SERVING[name])
    r_prob, p_prob = r_pl.serving_problem(r_cls), p_pl.serving_problem(p_cls)
    vm_fields = ("name", "cores", "sigma", "pi", "speed",
                 "containers_per_core")
    assert [[getattr(v, f) for f in vm_fields] for v in p_prob.vm_types] == \
        [[getattr(v, f) for f in vm_fields] for v in r_prob.vm_types]
    (r_app,), (p_app,) = r_prob.classes, p_prob.classes
    assert {k: vars(v) for k, v in p_app.profiles.items()} == \
        {k: vars(v) for k, v in r_app.profiles.items()}
    assert (p_app.h_users, p_app.think_ms, p_app.deadline_ms, p_app.eta) \
        == (r_app.h_users, r_app.think_ms, r_app.deadline_ms, r_app.eta)
    assert _decisions(p_pl.plan_serving([p_cls], use_qn=False)) == \
        _decisions(r_pl.plan_serving([r_cls], use_qn=False))


@pytest.mark.parametrize("name", list(SERVING))
def test_qn_verified_serving_plan(name):
    r_pl = rc.TPUCapacityPlanner(_costs(rc))
    p_pl = pc.TPUCapacityPlanner(_costs(pc), device="cpu")
    d0 = ref_qn_sim.dispatch_count()
    want = _decisions(r_pl.plan_serving([rc.ServingClass(*SERVING[name])]))
    r_disp = ref_qn_sim.dispatch_count() - d0
    d0 = port_qn_sim.dispatch_count()
    got = _decisions(p_pl.plan_serving([pc.ServingClass(*SERVING[name])]))
    assert port_qn_sim.dispatch_count() - d0 == r_disp >= 1
    w, g = want[name], got[name]
    assert {k: g[k] for k in g if k != "predicted_ms"} == \
        {k: w[k] for k in w if k != "predicted_ms"}
    assert abs(g["predicted_ms"] - w["predicted_ms"]) <= \
        QN_REL * w["predicted_ms"]


@pytest.mark.parametrize("deadline_h", [24.0, 12.0, 6.0])
def test_training_plans(deadline_h):
    for costs in (_costs, _every_arch_costs):
        r_pl = rc.TPUCapacityPlanner(costs(rc))
        p_pl = pc.TPUCapacityPlanner(costs(pc), device="cpu")
        archs = sorted({a for a, s in costs(rc) if s == "train_4k"})
        kw = [dict(name=f"t-{a}", arch=a, steps=200_000,
                   deadline_h=deadline_h) for a in archs]
        assert _decisions(p_pl.plan_training(
            [pc.TrainClass(**k) for k in kw])) == \
            _decisions(r_pl.plan_training([rc.TrainClass(**k) for k in kw]))
    p_pl = pc.TPUCapacityPlanner(_costs(pc), device="cpu")
    with pytest.raises(KeyError, match="train_4k"):
        p_pl.plan_training([pc.TrainClass(name="x", arch="gemma3-27b")])


def _record(tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(port_drive.capacity_record()))
    return str(path)


def test_load_dryrun_and_replan_capacity(tmp_path):
    path = _record(tmp_path)
    want, got = rc.load_dryrun(path), pc.load_dryrun(path)
    assert sorted(got) == sorted(want) == sorted(port_drive.CAPACITY_COSTS)
    assert {k: vars(v) for k, v in got.items()} == \
        {k: vars(v) for k, v in want.items()}
    # the analytic memory model replaced the record's bytes
    assert all(got[k].bytes_per_dev != v[1]
               for k, v in port_drive.CAPACITY_COSTS.items())
    for steps, deadline_h in ((120_000, 12.0), (200_000, 24.0),
                              (1_000_000, 12.0)):
        assert _decisions(ElasticPlan.replan_capacity(
            "granite-3-2b", steps, deadline_h, dryrun_path=path,
            device="cpu")) == _decisions(RefElasticPlan.replan_capacity(
                "granite-3-2b", steps, deadline_h, dryrun_path=path))


def test_load_dryrun_without_a_model_keeps_the_record_bytes(tmp_path):
    """An arch the registry does not know leaves the analytic memory
    model's ``try`` in both packages: the record's own bytes are kept."""
    path = tmp_path / "dryrun.json"
    rec = dict(port_drive.capacity_record()[0], arch="no-such-arch")
    path.write_text(json.dumps([rec]))
    want, got = rc.load_dryrun(str(path)), pc.load_dryrun(str(path))
    assert {k: vars(v) for k, v in got.items()} == \
        {k: vars(v) for k, v in want.items()}
    assert got[("no-such-arch", "train_4k")].bytes_per_dev == \
        rec["cost_analysis"]["bytes_accessed"]


@pytest.mark.parametrize("label", list(port_drive.CAPACITY_CLI))
def test_plan_cli_prints_the_references_plan(label, tmp_path, capsys,
                                             monkeypatch):
    path = _record(tmp_path)
    argv = [*port_drive.CAPACITY_CLI[label], "--dryrun", path]
    monkeypatch.setattr(sys, "argv", ["plan", *argv])
    ref_plan.main()
    want = json.loads(capsys.readouterr().out)
    port_plan.main([*argv, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    rel = QN_REL if label in port_drive.CAPACITY_QN_PARTS else 0.0
    assert port_drive.mismatches(want, got, rel=rel) == []
    assert got["class"] == want["class"]


def test_capacity_drive_equals_the_references():
    """The drive ``chip_smoke.py``'s [capacity] phase runs on the card, on
    the CPU here, against the reference script's part of the same name."""
    want = ref_drive.capacity()
    got = port_drive.capacity("cpu")
    assert port_drive.capacity_mismatches(want, got) == []
    assert port_drive.capacity_mismatches(
        want, {**got, "replan": {}}) == ["replan.replan-granite-3-2b"]
    assert sum(v["qn"]["dispatches"] for v in got["serving"].values()) == 5
    assert set(got["walls"]) >= {f"{c}.qn" for c in SERVING}


def test_planner_without_a_device_raises_on_a_cpu_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    path = _record(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.TPUCapacityPlanner(_costs(pc))
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.TPUCapacityPlanner(_costs(pc), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticPlan.replan_capacity("granite-3-2b", 1000, 12.0,
                                    dryrun_path=path)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_plan.main(["train", "--arch", "granite-3-2b", "--dryrun",
                        path])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_drive.capacity()
    assert pc.TPUCapacityPlanner(_costs(pc), device="cpu").device == \
        torch.device("cpu")


@pytest.mark.cuda
def test_capacity_drive_on_the_card_equals_the_cpus():
    """The drive on the card (its QN probes on qn_event_wide and
    qn_event_general) against the same drive on the CPU's plain versions:
    every number equal but the QN plans' predicted_ms, within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    on_cpu = port_drive.capacity("cpu")
    on_card = port_drive.capacity("cuda")
    on_cpu.pop("walls")
    assert port_drive.capacity_mismatches(on_cpu, on_card) == []
