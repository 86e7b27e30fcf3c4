"""The port's private-cloud plane (``repro_torch.cloud``) against the
reference's (``repro.cloud``), in one process on the CPU (``device="cpu"``:
the kernels' plain versions and the feasibility check's CPU path).

Mirrors ``tests/test_private_cloud.py`` case by case, each case run on
both packages with the same seeded inputs (``min_jobs=8``, 1
replication): the packers' assignments, ``feasibility_batch``'s masks
(padding, overloads, unplaced VMs, non-integer memory), the JSON round
trip and the interop carry-over, the coordinator's unbounded, shift and
fallback cases, bit-exact degeneracy in ``run`` and ``run_fast``, fused
coordination probes and ``run_steps``' rids, the service's private job
against its solo run, ``estimate_job_cores`` and both admission cases,
and ``plan_day`` (contracts, cache hits, private windows, idle hours,
uneven profiles).  The slice as a whole is ``test_torch_cloud_slice.py``
(the two files split the time, each about a minute alone).  Tolerances: decisions, deployment summaries, assignments,
dispatch counts and masks exactly; a ``predicted_ms`` within a relative
1e-3 (``torch_scenarios.mismatches``: the one-ulp ``log1p`` differences of
exponential draws; every one came out bit-identical when this was
written, torch 2.13 CPU against JAX 0.9.0).
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks import torch_scenarios as port_scen
from repro import cloud as ref_cloud
from repro.cloud import placement as ref_placement
from repro.cloud import windows as ref_windows
from repro.core import pricing as ref_pricing
from repro.core import qn_sim as ref_qn_sim
from repro.core.optimizer import DSpace4Cloud as RefD
from repro.core.problem import ApplicationClass as RefClass
from repro.core.problem import ClassSolution as RefSolution
from repro.core.problem import JobProfile as RefProfile
from repro.core.problem import Problem as RefProblem
from repro.core.problem import VMType as RefVM
from repro.service import AdmissionController as RefAdmission
from repro.service import SolverService as RefService
from repro.service import estimate_job_cores as ref_estimate_cores
from repro_torch import cloud
from repro_torch.cloud import placement, windows
from repro_torch.core import interop, pricing, qn_sim
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.core.problem import ApplicationClass, ClassSolution, \
    JobProfile, Problem, VMType
from repro_torch.service import AdmissionController, SolverService, \
    estimate_job_cores, parse_submission

torch.set_num_threads(1)    # the plain event loop is many tiny ops

KW = dict(min_jobs=8, replications=1, seed=3, window=8)
SVC_KW = dict(min_jobs=8, replications=1, seed=3)


def _ns(cloud_mod, placement_mod, windows_mod, pricing_mod, qn, P, AC,
        Profile, VM, Sol, D, Service, Admission, est, dev):
    roomy = VM(name="roomy", cores=4, sigma=0.05, pi=0.20)
    dense = VM(name="dense", cores=2, sigma=0.055, pi=0.22,
               containers_per_core=2)
    return SimpleNamespace(
        cloud=cloud_mod, placement=placement_mod, windows=windows_mod,
        pricing=pricing_mod, qn=qn, P=P, AC=AC, VM=VM, Sol=Sol, D=D,
        Service=Service, Admission=Admission, estimate_cores=est,
        dev=dev, ROOMY=roomy, DENSE=dense,
        PROF=Profile(n_map=24, n_reduce=6, m_avg=2000, r_avg=900,
                     m_max=4000, r_max=1800))


REF = _ns(ref_cloud, ref_placement, ref_windows, ref_pricing, ref_qn_sim,
          RefProblem, RefClass, RefProfile, RefVM, RefSolution, RefD,
          RefService, RefAdmission, ref_estimate_cores, {})
PORT = _ns(cloud, placement, windows, pricing, qn_sim, Problem,
           ApplicationClass, JobProfile, VMType, ClassSolution,
           lambda *a, **k: DSpace4Cloud(*a, device="cpu", **k),
           lambda **k: SolverService(device="cpu", **k), AdmissionController,
           estimate_job_cores, {"device": "cpu"})
PKGS = pytest.mark.parametrize("ns", [REF, PORT], ids=["reference", "port"])


def make_problem(ns, n_classes=3, deployment=None, vm_types=None):
    vms = vm_types or (ns.ROOMY, ns.DENSE)
    classes = [
        ns.AC(name=f"c{i}", h_users=4, think_ms=6000.0,
              deadline_ms=11_000.0, eta=0.25,
              profiles={vm.name: ns.PROF for vm in vms})
        for i in range(n_classes)]
    return ns.P(classes=classes, vm_types=list(vms), deployment=deployment)


def sols_for(ns, problem, assign):
    """{name: (vm_name, nu)} -> ClassSolution dict (analytic costs)."""
    out = {}
    for name, (vm_name, nu) in assign.items():
        cls = next(c for c in problem.classes if c.name == name)
        r, s, cost = ns.pricing.optimal_mix(nu, cls.eta,
                                            problem.vm_by_name(vm_name))
        out[name] = ns.Sol(vm_type=vm_name, nu=nu, reserved=r, spot=s,
                           cost_per_h=cost, predicted_ms=1.0, feasible=True)
    return out


def hosts(ns, count, cores, **kw):
    return ns.cloud.PrivateCloud(hosts=ns.cloud.homogeneous_hosts(
        count, cores, **kw))


def decisions(sols) -> dict:
    return {k: v.as_dict() for k, v in sols.items()}


def equal(want, got):
    """Exact but for ``predicted_ms``, within a relative 1e-3."""
    assert port_scen.mismatches(want, got, rel=1e-3) == []


def both(fn):
    """``fn`` on the reference and on the port; returns (want, got)."""
    return fn(REF), fn(PORT)


def placement_dict(pl) -> dict:
    return {**pl.summary(), "assignment": pl.assignment.tolist(),
            "labels": pl.vm_labels}


# ---------------------------------------------------------------- pricing

@pytest.mark.parametrize("nus,eta,sigma,pi", [
    ([2, 3, 4, 6, 6, 1], 0.25, 0.05, 0.20),
    ([5, 0, 7], 0.5, 0.30, 0.20),       # spot priced out: quantile climb
    ([0, 0], 0.3, 0.05, 0.20), ([9], 0.3, 0.05, 0.20), ([], 0.3, 0.1, 0.2)])
def test_day_mix_and_host_energy_equal_the_reference(nus, eta, sigma, pi):
    want = ref_pricing.optimal_day_mix(nus, eta, RefVM("v", 4, sigma, pi))
    got = pricing.optimal_day_mix(nus, eta, VMType("v", 4, sigma, pi))
    assert got == want
    assert pricing.day_mix_cost(nus, eta, VMType("v", 4, sigma, pi)) == \
        ref_pricing.day_mix_cost(nus, eta, RefVM("v", 4, sigma, pi))
    hs = [cloud.Host(name=f"h{i}", cores=8, energy_cost_per_h=0.1 * i)
          for i in range(5)]
    rhs = [ref_cloud.Host(name=f"h{i}", cores=8, energy_cost_per_h=0.1 * i)
           for i in range(5)]
    assert pricing.host_energy_cost(hs) == ref_pricing.host_energy_cost(rhs)


# -------------------------------------------------------------- placement

def test_pack_ffd_respects_host_capacity():
    cores = np.array([6, 4, 4, 4, 2, 2, 2], np.float32)   # packs exactly
    mem = np.array([8.0] * 7, np.float32)
    want, got = both(lambda ns: ns.placement.pack_ffd(
        cores, mem, hosts(ns, 3, 8)))
    assert got.tolist() == want.tolist()
    assert (got >= 0).all()
    for h in range(3):
        assert cores[got == h].sum() <= 8


def test_pack_prefers_low_energy_hosts():
    def run(ns):
        c = ns.cloud.PrivateCloud(hosts=[
            ns.cloud.Host(name="hot", cores=16, energy_cost_per_h=2.0),
            ns.cloud.Host(name="cool", cores=16, energy_cost_per_h=0.5)])
        prob = make_problem(ns, 1, vm_types=(ns.ROOMY,))
        return ns.placement.pack(prob, sols_for(ns, prob,
                                                {"c0": ("roomy", 3)}),
                                 c, **ns.dev)
    want, got = both(run)
    assert placement_dict(got) == placement_dict(want)
    assert got.feasible and got.hosts_used == 1
    assert got.energy_cost_per_h == pytest.approx(0.5)


def test_pack_reports_overcommit():
    def run(ns):
        prob = make_problem(ns, 1, vm_types=(ns.ROOMY,))
        return ns.placement.pack(prob, sols_for(ns, prob,
                                                {"c0": ("roomy", 5)}),
                                 hosts(ns, 2, 4), **ns.dev)
    want, got = both(run)
    assert placement_dict(got) == placement_dict(want)
    assert not got.feasible and got.unplaced >= 1
    assert got.cores_total == 8


def test_pack_empty_fleet_is_trivially_feasible():
    want, got = both(lambda ns: ns.placement.pack(
        make_problem(ns, 1), {}, hosts(ns, 2, 4), **ns.dev))
    assert placement_dict(got) == placement_dict(want)
    assert got.feasible and got.hosts_used == 0
    assert got.energy_cost_per_h == 0.0


def _np_feasible(asg, vc, vmem, hc, hm):
    for v in range(len(asg)):
        if vc[v] > 0 and asg[v] < 0:
            return False
    for h in range(len(hc)):
        m = asg == h
        if vc[m].sum() > hc[h] + 1e-6 or vmem[m].sum() > hm[h] + 1e-6:
            return False
    return True


def _feasibility(*args):
    """The reference's mask and the port's CPU mask on the same inputs."""
    return (ref_placement.feasibility_batch(*args),
            placement.feasibility_batch(*args, device="cpu"))


def test_feasibility_batch_matches_numpy_reference():
    rng = np.random.default_rng(0)
    hc = np.array([8, 8, 16], np.float32)
    hm = np.array([32, 32, 64], np.float32)
    b, v = 24, 7
    asg = rng.integers(-1, 3, size=(b, v))
    vc = rng.choice([0.0, 2.0, 4.0, 6.0], size=(b, v)).astype(np.float32)
    vmem = (vc * 4).astype(np.float32)
    want, got = _feasibility(asg, vc, vmem, hc, hm)
    assert got.dtype == np.bool_ and got.shape == (b,)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [_np_feasible(asg[i], vc[i], vmem[i], hc, hm)
                            for i in range(b)]
    assert any(got) and not all(got)     # the sample spans both verdicts


def test_feasibility_batch_pads_across_fleet_sizes():
    hc = np.array([8, 8], np.float32)
    hm = np.array([32, 32], np.float32)
    fleets = [
        (np.array([0, 1]), np.array([8.0, 8.0]), np.array([4.0, 4.0])),
        (np.array([0, 0, 1, 1]), np.array([4.0] * 4), np.array([4.0] * 4)),
        (np.array([0, 0]), np.array([8.0, 8.0]), np.array([4.0, 4.0])),
    ]
    padded = placement.pad_batch(fleets)
    for x, y in zip(padded, ref_placement.pad_batch(fleets)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert padded[0].shape == (3, 4)     # padded to the largest fleet
    want, got = _feasibility(*padded, hc, hm)
    assert got.tolist() == want.tolist() == [True, True, False]


def test_feasibility_batch_host_index_past_the_catalog_counts_nothing():
    """A host index past ``H`` matches no host in the reference's one-hot
    (placed, summed nowhere); the port's spare column does the same."""
    hc = np.array([4, 4], np.float32)
    hm = np.array([16, 16], np.float32)
    asg = np.array([[0, 5], [0, 1], [-1, 1]])
    vc = np.array([[4.0, 9.0], [4.0, 4.0], [4.0, 4.0]], np.float32)
    want, got = _feasibility(asg, vc, vc * 4, hc, hm)
    assert got.tolist() == want.tolist() == [True, True, False]


def test_feasibility_batch_non_integer_memory_equals_the_reference():
    """Non-integer ``vm_memory_gb`` (sums that are not exact in float32),
    with each host's memory set to within a few ulps of its float64 load
    so that the order of the float32 sum could decide: the port's masks
    equal the reference's on every case drawn."""
    rng = np.random.default_rng(7)
    b, v, h = 256, 24, 4
    asg = rng.integers(-1, h, size=(b, v))
    asg[:, 0] = 0
    vc = rng.choice([1.0, 2.0, 4.0], size=(b, v)).astype(np.float32)
    vmem = rng.choice([0.1, 0.3, 1.7, 2.35, 3.9], size=(b, v)) \
        .astype(np.float32)
    hc = np.full(h, 64.0, np.float32)
    load = np.zeros((b, h))
    for i in range(b):
        np.add.at(load[i], asg[i][asg[i] >= 0],
                  vmem[i][asg[i] >= 0].astype(np.float64))
    for shift in (-3e-6, -1e-6, 0.0, 1e-6, 3e-6):
        hm = (load.max(axis=0) + shift).astype(np.float32)
        want, got = _feasibility(asg, vc, vmem, hc, hm)
        assert got.tolist() == want.tolist(), shift


def test_fleet_expansion_counts_every_vm():
    def run(ns):
        c = ns.cloud.PrivateCloud(hosts=ns.cloud.homogeneous_hosts(4, 8),
                                  vm_memory_gb={"dense": 3.0})
        prob = make_problem(ns, 2)
        return ns.placement.fleet_of(prob, sols_for(
            ns, prob, {"c0": ("roomy", 2), "c1": ("dense", 3)}), c)
    (wc, wm, wl), (cores, mem, labels) = both(run)
    assert cores.dtype == wc.dtype and mem.dtype == wm.dtype
    assert cores.tolist() == wc.tolist() and mem.tolist() == wm.tolist()
    assert labels == wl
    assert sorted(labels).count("c1@dense") == 3
    assert mem[np.asarray(labels) == "c1@dense"].tolist() == [3.0] * 3
    assert cores.sum() == 2 * 4 + 3 * 2


# ------------------------------------------------------------ hosts + JSON

def _lab_cloud(ns):
    return ns.cloud.PrivateCloud(
        hosts=ns.cloud.homogeneous_hosts(3, 8, energy_cost_per_h=0.4,
                                         hosts_per_rack=2),
        vm_memory_gb={"dense": 6.0}, name="lab")


def test_private_cloud_json_round_trip_via_problem():
    doc = make_problem(PORT, 1, deployment=_lab_cloud(PORT)).to_json()
    assert doc == make_problem(REF, 1, deployment=_lab_cloud(REF)).to_json()
    back = Problem.from_json(doc)
    assert back.deployment == _lab_cloud(PORT)
    assert back.deployment.total_cores == 24
    assert back.deployment.vm_mem(PORT.DENSE) == 6.0
    assert [h.rack for h in back.deployment.hosts] == \
        ["rack0", "rack0", "rack1"]
    assert back.to_json() == doc
    # and the public problem stays deployment-free
    assert Problem.from_json(make_problem(PORT, 1).to_json()) \
        .deployment is None


def test_interop_carries_the_reference_deployment_across():
    rdoc = make_problem(REF, 2, deployment=_lab_cloud(REF)).to_json()
    prob = interop.problem_from_reference(rdoc)
    assert isinstance(prob.deployment, cloud.PrivateCloud)
    assert prob.deployment == _lab_cloud(PORT)
    assert prob.to_json() == rdoc
    assert cloud.deployment_from_dict(None) is None
    assert interop.problem_from_reference(
        make_problem(REF, 1).to_json()).deployment is None


# ----------------------------------------------------- joint (stub tier)

def _stub(boundary_by_vm):
    """T = D * nu*(vm) / nu: monotone, feasible from the boundary up."""
    def evaluate(cls, vm, nu):
        return cls.deadline_ms * boundary_by_vm[vm.name] / nu
    return evaluate


def _plan_dict(plan) -> dict:
    return {"summary": plan.summary(),
            "solutions": decisions(plan.solutions),
            "baseline": decisions(plan.baseline),
            "placement": placement_dict(plan.placement)}


def test_coordinate_unbounded_returns_base_untouched():
    def run(ns):
        prob = make_problem(ns, 2)
        base = sols_for(ns, prob, {"c0": ("roomy", 4), "c1": ("roomy", 4)})
        lanes = {n: [(ns.ROOMY, 4), (ns.DENSE, 4)] for n in ("c0", "c1")}

        def poison(cls, vm, nu):             # must never be called
            raise AssertionError("unbounded coordination probed the QN")
        plan = ns.cloud.coordinate(prob, hosts(ns, 32, 8), base, lanes,
                                   poison, **ns.dev)
        assert plan.solutions is base
        return plan
    want, got = both(run)
    assert _plan_dict(got) == _plan_dict(want)
    assert not got.coordinated and got.placement.feasible
    assert got.probe_rounds == 0


def test_coordinate_shifts_to_core_efficient_lane():
    def run(ns):
        prob = make_problem(ns, 3)
        # roomy fleet needs 3*4*4 = 48 cores; dense fits in 24
        base = sols_for(ns, prob, {n: ("roomy", 4) for n in
                                   ("c0", "c1", "c2")})
        lanes = {n: [(ns.ROOMY, 4), (ns.DENSE, 4)] for n in
                 ("c0", "c1", "c2")}
        return ns.cloud.coordinate(prob, hosts(ns, 6, 4), base, lanes,
                                   _stub({"roomy": 4, "dense": 4}),
                                   **ns.dev)
    want, got = both(run)
    equal(_plan_dict(want), _plan_dict(got))
    assert got.coordinated and not got.used_fallback
    assert got.placement.feasible and got.violations == 0
    assert all(s.vm_type == "dense" for s in got.solutions.values())
    assert got.dual_price > 0
    assert got.objective <= got.baseline_objective


def test_coordinate_falls_back_to_truncation_but_beats_baseline():
    # a single VM type: pricing cores cannot shift anything, so the plan
    # degrades gracefully, truncated analytic estimates on the port's MVA
    def run(ns):
        prob = make_problem(ns, 2, vm_types=(ns.ROOMY,))
        base = sols_for(ns, prob, {"c0": ("roomy", 4), "c1": ("roomy", 4)})
        lanes = {n: [(ns.ROOMY, 4)] for n in ("c0", "c1")}
        return ns.cloud.coordinate(prob, hosts(ns, 2, 4), base, lanes,
                                   _stub({"roomy": 4}), **ns.dev)
    want, got = both(run)
    equal(_plan_dict(want), _plan_dict(got))
    assert got.coordinated and got.used_fallback
    assert got.placement.feasible and got.violations >= 1
    assert (got.violations, got.cost_per_h) <= \
        (want.summary()["baseline_violations"],
         want.summary()["baseline_cost_per_h"])


# --------------------------------------------------- real QN, end to end

def _report(rep) -> dict:
    return {"classes": decisions(rep.solutions), "qn": rep.qn_dispatches,
            "deployment": rep.deployment}


@pytest.mark.parametrize("gait", ["run", "run_fast"])
def test_unbounded_private_cloud_is_bit_exact_with_public(gait):
    def run(ns):
        prob = make_problem(ns, 2)
        big = hosts(ns, 40, 8, energy_cost_per_h=0.4)
        pub = getattr(ns.D(prob, **KW), gait)()
        priv = getattr(ns.D(prob, deployment=big, **KW), gait)()
        assert priv.solutions == pub.solutions       # bit-exact
        assert pub.deployment is None
        assert json.loads(pub.to_json())["deployment"] is None
        return priv
    want, got = both(run)
    equal(_report(want), _report(got))
    assert not got.deployment["coordinated"]
    assert got.deployment["placement"]["feasible"]
    assert json.loads(got.to_json())["deployment"] == got.deployment


@pytest.fixture(scope="module")
def overcommitted():
    """make_problem(3) on 6 x 4 cores (energy 0.3), ``run()`` in both
    packages, with each run's dispatch delta."""
    def run(ns):
        prob = make_problem(ns, 3)
        c = hosts(ns, 6, 4, energy_cost_per_h=0.3)
        d0 = ns.qn.dispatch_count()
        rep = ns.D(prob, deployment=c, **KW).run()
        return rep, ns.qn.dispatch_count() - d0
    return both(run)


def test_overcommitted_cluster_coordinates_with_fused_probes(overcommitted):
    (want, d_want), (rep, d_got) = overcommitted
    equal(_report(want), _report(rep))
    assert d_got == d_want
    dep = rep.deployment
    assert dep["coordinated"] and dep["placement"]["feasible"]
    assert dep["violations"] == 0
    assert all(s.vm_type == "dense" for s in rep.solutions.values())
    assert dep["objective"] <= dep["baseline_objective"]
    # one fusion group: every coordination probe round is one dispatch
    assert d_got <= 1 + dep["probe_rounds"] and dep["probe_rounds"] >= 1
    assert set(rep.traces) >= {f"joint:c{i}@dense" for i in range(3)}


def test_problem_document_deployment_is_honoured(overcommitted):
    (_, _), (solo, _) = overcommitted
    doc = make_problem(PORT, 3, deployment=hosts(
        PORT, 6, 4, energy_cost_per_h=0.3)).to_json()
    rep = DSpace4Cloud(Problem.from_json(doc), device="cpu", **KW).run()
    assert rep.deployment == solo.deployment
    assert rep.solutions == solo.solutions


def test_run_steps_yields_coordination_requests_with_rids(overcommitted):
    (_, _), (solo, _) = overcommitted
    tool = DSpace4Cloud(make_problem(PORT, 3),
                        deployment=hosts(PORT, 6, 4, energy_cost_per_h=0.3),
                        device="cpu", **KW)
    gen = tool.run_steps()
    reqs, rounds = next(gen), 0
    while True:
        rounds += 1
        assert reqs and all("@" in r.rid for r in reqs)
        results = {r.rid: tool.evaluate.evaluate_frontier(r.cls, r.vm,
                                                          r.nus)
                   for r in reqs}
        try:
            reqs = gen.send(results)
        except StopIteration as stop:
            rep = stop.value
            break
    assert rep.solutions == solo.solutions
    assert rep.deployment == solo.deployment
    # the race's rounds, then the coordinator's probe rounds
    assert rounds > rep.deployment["probe_rounds"] >= 1


# ----------------------------------------------------------------- service

def test_service_private_job_matches_solo_run(overcommitted):
    (want, _), (solo, _) = overcommitted

    def run(ns):
        svc = ns.Service(window=KW["window"])
        prob = make_problem(ns, 3)
        c = hosts(ns, 6, 4, energy_cost_per_h=0.3)
        jid = svc.submit(prob, deployment=c, **SVC_KW)
        jid2 = svc.submit(json.dumps({
            "problem": json.loads(prob.to_json()),
            "solver": {**SVC_KW, "tag": "json", "window": KW["window"],
                       "deployment": c.to_dict()}}))
        jobs = svc.run_until_complete()
        assert jobs[jid].cores_estimate == jobs[jid2].cores_estimate > 0
        return jobs[jid], jobs[jid2], svc.stats()
    (rjob, rjob2, rstats), (job, job2, stats) = both(run)
    for j in (job, job2):
        assert j.report.solutions == solo.solutions
        assert j.report.deployment == solo.deployment
        assert port_scen.job_equal(j.report, solo)
        assert j.summary()["deployment"] == solo.deployment
    equal(_report(rjob.report)["classes"], _report(job.report)["classes"])
    assert job.report.deployment == rjob.report.deployment
    assert stats["rounds"] == rstats["rounds"]
    assert stats["scheduler"] == rstats["scheduler"]
    assert stats["admission"] == rstats["admission"]


def test_a_json_submission_decodes_its_deployment():
    c = hosts(PORT, 6, 4)
    doc = json.dumps({"problem": json.loads(make_problem(PORT, 1).to_json()),
                      "solver": {"deployment": c.to_dict(), "seed": 3}})
    prob, solver = parse_submission(doc)
    assert solver["deployment"] == c and solver["seed"] == 3
    assert prob.deployment is None


@PKGS
def test_estimate_job_cores_public_vs_private(ns):
    prob = make_problem(ns, 2)
    assert ns.estimate_cores(prob, None) == 0
    est = ns.estimate_cores(prob, hosts(ns, 64, 8))
    assert est > 0
    assert ns.estimate_cores(prob, hosts(ns, 1, 4)) == 4   # capped
    if ns is PORT:
        assert est == ref_estimate_cores(make_problem(REF, 2),
                                         hosts(REF, 64, 8))


@PKGS
def test_admission_defers_private_jobs_beyond_core_budget(ns):
    ctl = ns.Admission(max_physical_cores=24)
    assert ctl.try_admit("a", events=10, cores=20) == "admit"
    assert ctl.try_admit("b", events=10, cores=20) == "defer"
    assert ctl.try_admit("pub", events=10, cores=0) == "admit"
    ctl.release("a")
    assert ctl.try_admit("b", events=10, cores=20) == "admit"
    assert ctl.stats.peak_inflight_cores == 20
    ctl.release("b")
    ctl.release("pub")
    assert ctl.stats.inflight_cores == 0


@PKGS
def test_admission_oversize_private_job_runs_alone(ns):
    ctl = ns.Admission(max_physical_cores=16)
    assert ctl.try_admit("a", events=10, cores=8) == "admit"
    # demands more metal than the service fronts: waits for solitude
    assert ctl.try_admit("big", events=10, cores=40) == "defer"
    ctl.release("a")
    assert ctl.try_admit("big", events=10, cores=40) == "admit"
    assert ctl.stats.oversize_admitted == 1


def test_service_admits_private_jobs_against_the_cluster_cores():
    """Two private tenants on one 24-core cluster: the second waits for
    the first (cores), a public tenant is admitted beside it; rounds,
    admission stats and decisions equal the reference's."""
    def run(ns):
        c = hosts(ns, 6, 4)
        svc = ns.Service(window=KW["window"], admission=ns.Admission(
            max_physical_cores=c.total_cores))
        jids = [svc.submit(make_problem(ns, 1), deployment=c, tag=t,
                           **SVC_KW) for t in ("p1", "p2")]
        jids.append(svc.submit(make_problem(ns, 1), tag="pub", **SVC_KW))
        jobs = svc.run_until_complete()
        return ([decisions(jobs[j].report.solutions) for j in jids],
                [jobs[j].cores_estimate for j in jids], svc.stats())
    (wdec, wcores, wstats), (dec, cores, stats) = both(run)
    equal(wdec, dec)
    assert cores == wcores and cores[2] == 0 and cores[0] > 12
    assert stats["admission"] == wstats["admission"]
    assert stats["admission"]["deferred"] > 0
    assert stats["rounds"] == wstats["rounds"]


# ----------------------------------------------------------------- windows

def _day(plan) -> dict:
    return {**port_scen.day_summary(plan),
            "windows": [decisions(r.solutions) for r in plan.reports],
            "deployments": [r.deployment for r in plan.reports]}


def test_plan_day_contracts_and_fusion():
    day = {"c0": [2] * 3 + [4] * 3, "c1": [2] * 6}

    def run(ns):
        prob = make_problem(ns, 2)
        d0 = ns.qn.dispatch_count()
        single = ns.D(prob, **KW).run()
        d_single = max(1, ns.qn.dispatch_count() - d0)
        plan = ns.windows.plan_day(prob, day, **KW, **ns.dev)
        assert single.solutions
        return plan, d_single
    (want, d_want), (plan, d_single) = both(run)
    equal(_day(want), _day(plan))
    assert d_single == d_want and len(plan.reports) == 6
    # two distinct concurrency levels -> about two single-window budgets
    assert plan.qn_dispatches <= 4 * d_single
    for c in plan.contracts:
        assert (c.reserved, c.spots, c.day_cost) == pricing.optimal_day_mix(
            c.nus, 0.25, PORT.DENSE if c.vm_type == "dense" else PORT.ROOMY)
    assert plan.vm_day_cost >= plan.naive_hourly_cost - 1e-9
    assert len(plan.summary()["slo"]["window_margin_ms"]) == 6


def test_plan_day_constant_profile_windows_are_cache_hits():
    day = {"c0": [4] * 5, "c1": [4] * 5}

    def run(ns):
        d0 = ns.qn.dispatch_count()
        plan = ns.windows.plan_day(make_problem(ns, 2), day, **KW, **ns.dev)
        return plan, ns.qn.dispatch_count() - d0
    (want, d_want), (plan, d_day) = both(run)
    equal(_day(want), _day(plan))
    assert d_day == d_want == plan.qn_dispatches
    sols0 = plan.reports[0].solutions
    assert all(r.solutions == sols0 for r in plan.reports[1:])


def test_plan_day_private_cloud_validates_every_window():
    day = {f"c{i}": [4, 4, 2] for i in range(3)}

    def run(ns):
        c = hosts(ns, 6, 4, energy_cost_per_h=0.3)
        return ns.windows.plan_day(make_problem(ns, 3), day, deployment=c,
                                   **KW, **ns.dev)
    want, plan = both(run)
    equal(_day(want), _day(plan))
    assert plan.windows_feasible == [True, True, True]
    assert plan.energy_day_cost > 0
    for rep in plan.reports:
        assert rep.deployment["placement"]["feasible"]


def test_plan_day_idle_hours_drop_classes():
    day = {"c0": [0, 4], "c1": [4, 4]}
    want, plan = both(lambda ns: ns.windows.plan_day(
        make_problem(ns, 2), day, **KW, **ns.dev))
    equal(_day(want), _day(plan))
    assert "c0" not in plan.reports[0].solutions
    assert "c0" in plan.reports[1].solutions
    c0 = next(c for c in plan.contracts if c.cls == "c0")
    assert c0.nus[0] == 0


def test_plan_day_rejects_uneven_profiles():
    with pytest.raises(ValueError, match="uneven"):
        windows.plan_day(make_problem(PORT, 2),
                         {"c0": [1, 2], "c1": [1, 2, 3]}, device="cpu", **KW)


def test_plan_day_is_reexported_lazily():
    assert cloud.plan_day is windows.plan_day
    assert cloud.DayPlan is windows.DayPlan
    with pytest.raises(AttributeError):
        cloud.no_such_name
