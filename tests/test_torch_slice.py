"""The port's Figure-3 planner against the reference, end to end on the CPU.

Two small problems, each planned by ``DSpace4Cloud.run()`` and
``.run_fast()`` in both packages (fresh instances per call):

  * ``EXP`` — two classes on two VM types, exponential service times,
    shaped like ``examples/quickstart.py`` with small task counts; the race
    prunes a lane in each class;
  * ``REPLAY`` — one class in JMT-replayer mode on duration lists made
    from a numpy seed.

Decisions must be equal: VM type, nu, reserved/spot, cost, and the
number of fused dispatches.  ``predicted_ms`` came out bit-identical in
all four pairs when this test was written (torch 2.13 CPU, JAX 0.9.0); the
stated tolerance is a relative 1e-3, room for one-ulp differences of the
exponential think draws.  The problem and its evaluation cache carry
across through ``repro_torch.core.interop`` (JSON and numpy only).
"""
import numpy as np
import pytest
import torch

from repro.core import milp as ref_milp
from repro.core.optimizer import DSpace4Cloud as RefD
from repro.core.problem import ApplicationClass, JobProfile, Problem, VMType
from repro.core.tpcds import scenario_problem as ref_scenario_problem
from repro_torch.core import interop, milp
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.core.tpcds import scenario_problem
from repro_torch.core.workload import profile_hash, samples_digest

torch.set_num_threads(1)    # the plain event loop is many tiny ops

M4 = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
            containers_per_core=2)
C20 = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
KW = dict(min_jobs=4)


def _exp_problem():
    inter = JobProfile(n_map=16, n_reduce=4, m_avg=4000, m_max=6000,
                       r_avg=2000, r_max=3000)
    batchy = JobProfile(n_map=12, n_reduce=3, m_avg=9000, m_max=14000,
                        r_avg=6000, r_max=9000)
    return Problem(classes=[
        ApplicationClass(name="bi", h_users=8, think_ms=2_000,
                         deadline_ms=20_000, eta=0.3,
                         profiles={"m4.xlarge": inter,
                                   "c20.node": inter.scaled(1.35)}),
        ApplicationClass(name="etl", h_users=4, think_ms=5_000,
                         deadline_ms=30_000, eta=0.5,
                         profiles={"m4.xlarge": batchy,
                                   "c20.node": batchy.scaled(1.35)})],
        vm_types=[M4, C20]), None


def _replay_problem():
    prof = JobProfile(n_map=20, n_reduce=5, m_avg=3000, m_max=7000,
                      r_avg=1500, r_max=3500)
    g = np.random.default_rng(0)
    samples = {}
    for vm in (M4, C20):
        f = 1.0 / vm.speed
        samples[("rep", vm.name)] = (
            (g.lognormal(np.log(3000), 0.4, 256) * f).astype(np.float32),
            (g.lognormal(np.log(1500), 0.4, 64) * f).astype(np.float32))
    return Problem(classes=[ApplicationClass(
        name="rep", h_users=8, think_ms=2_000, deadline_ms=9_000, eta=0.3,
        profiles={"m4.xlarge": prof, "c20.node": prof.scaled(1.35)})],
        vm_types=[M4, C20]), samples


PROBLEMS = {"exp": _exp_problem, "replay": _replay_problem}
CALLS = [(p, m) for p in PROBLEMS for m in ("run", "run_fast")]


def _port_args(prob, samples):
    return (interop.problem_from_reference(prob.to_json()),
            None if samples is None
            else interop.samples_from_reference(samples))


@pytest.fixture(scope="module")
def reports():
    out = {}
    for name, mode in CALLS:
        prob, samples = PROBLEMS[name]()
        ref_cache = {}
        ref = getattr(RefD(prob, samples=samples, cache=ref_cache, **KW),
                      mode)()
        pprob, psamples = _port_args(prob, samples)
        port = getattr(DSpace4Cloud(pprob, samples=psamples, device="cpu",
                                    **KW), mode)()
        out[name, mode] = (ref, port, ref_cache)
    return out


@pytest.mark.parametrize("call", CALLS, ids=lambda c: ".".join(c))
def test_decisions_equal(reports, call):
    ref, port, _ = reports[call]
    assert port.solutions.keys() == ref.solutions.keys()
    for name, want in ref.solutions.items():
        got = port.solutions[name]
        for k in ("vm_type", "nu", "reserved", "spot", "cost_per_h",
                  "feasible"):
            assert getattr(got, k) == getattr(want, k), (name, k)
        assert got.predicted_ms == pytest.approx(want.predicted_ms, rel=1e-3)
    assert port.total_cost_per_h == ref.total_cost_per_h
    assert port.qn_dispatches == ref.qn_dispatches > 0


@pytest.mark.parametrize("call", CALLS, ids=lambda c: ".".join(c))
def test_search_and_accounting_equal(reports, call):
    ref, port, _ = reports[call]
    assert port.telemetry["qn"] == ref.telemetry["qn"]
    assert port.evals == ref.evals
    assert {k: (t.vm, t.pruned, [m[0] for m in t.moves])
            for k, t in port.traces.items()} == \
        {k: (t.vm, t.pruned, [m[0] for m in t.moves])
         for k, t in ref.traces.items()}
    assert port.slo["violations"] == ref.slo["violations"]


def test_the_race_prunes_a_lane(reports):
    _, port, _ = reports["exp", "run"]
    assert any(t.pruned for t in port.traces.values())
    assert {s.vm_type for s in port.solutions.values()} == \
        {"m4.xlarge", "c20.node"}


@pytest.mark.parametrize("call", CALLS, ids=lambda c: ".".join(c))
def test_reference_cache_carries_across(reports, call):
    """A cache the reference filled makes the port's run make no
    dispatch, and reproduce the reference's decisions exactly."""
    ref, _, ref_cache = reports[call]
    prob, samples = PROBLEMS[call[0]]()
    pprob, psamples = _port_args(prob, samples)
    port = getattr(DSpace4Cloud(
        pprob, samples=psamples, device="cpu",
        cache=interop.cache_from_reference(ref_cache), **KW), call[1])()
    assert port.qn_dispatches == 0
    assert {k: s.as_dict() for k, s in port.solutions.items()} == \
        {k: s.as_dict() for k, s in ref.solutions.items()}


@pytest.mark.parametrize("name", PROBLEMS)
def test_rankings_and_hashes_equal(name):
    prob, samples = PROBLEMS[name]()
    pprob, psamples = _port_args(prob, samples)
    assert pprob.to_json() == prob.to_json()
    assert {k: [s.as_dict() for s in v]
            for k, v in milp.rank_vm_types(pprob).items()} == \
        {k: [s.as_dict() for s in v]
         for k, v in ref_milp.rank_vm_types(prob).items()}
    from repro.core.workload import profile_hash as ref_hash
    from repro.core.workload import samples_digest as ref_digest
    for cls, pcls in zip(prob.classes, pprob.classes):
        for vm, pvm in zip(prob.vm_types, pprob.vm_types):
            key = (cls.name, vm.name)
            s = None if samples is None else samples[key]
            ps = None if psamples is None else psamples[key]
            assert samples_digest(ps) == ref_digest(s)
            kw = dict(min_jobs=6, warmup_jobs=8, replications=2)
            assert profile_hash(pcls.profile_for(pvm), pcls.think_ms,
                                pcls.h_users, pvm.slots, samples=ps, **kw) \
                == ref_hash(cls.profile_for(vm), cls.think_ms, cls.h_users,
                            vm.slots, samples=s, **kw)


def test_real_size_scenario_builds_identically():
    """The paper's §4.3 scenario from the port's own copies of the
    cluster simulator and TPC-DS catalog equals the reference's, and so
    does its analytic ranking."""
    prob, samples, spec = scenario_problem("Q1", 10, 160_000.0)
    rprob, rsamples, rspec = ref_scenario_problem("Q1", 10, 160_000.0)
    assert prob.to_json() == rprob.to_json()
    assert spec.__dict__ == rspec.__dict__
    assert samples.keys() == rsamples.keys()
    for k in samples:
        for a, b in zip(samples[k], rsamples[k]):
            assert np.array_equal(a, b)
    assert {k: [s.as_dict() for s in v]
            for k, v in milp.rank_vm_types(prob).items()} == \
        {k: [s.as_dict() for s in v]
         for k, v in ref_milp.rank_vm_types(rprob).items()}


def test_unported_options_raise(reports):
    """The private-cloud options the port once refused now plan as the
    reference's: a reference problem document with a ``deployment``
    carries across through ``interop`` (hosts, memory, name), and the
    replay problem on a cluster of half its public plan's cores gives the
    reference's decisions, deployment summary and dispatches (replay mode:
    exact), whether the deployment comes in the document or as the
    keyword."""
    from repro.cloud import PrivateCloud as RefCloud
    from repro.cloud import homogeneous_hosts as ref_hosts
    from repro_torch.cloud import PrivateCloud, homogeneous_hosts
    pub, _, _ = reports["replay", "run"]
    sol = pub.solutions["rep"]
    n_hosts = max(1, sol.nu * {"m4.xlarge": 4, "c20.node": 20}[
        sol.vm_type] // 8)
    prob, samples = _replay_problem()
    prob.deployment = RefCloud(hosts=ref_hosts(n_hosts, 4,
                                               energy_cost_per_h=0.2),
                               vm_memory_gb={"c20.node": 64.0}, name="lab")
    pprob, psamples = _port_args(prob, samples)
    assert pprob.deployment == PrivateCloud(
        hosts=homogeneous_hosts(n_hosts, 4, energy_cost_per_h=0.2),
        vm_memory_gb={"c20.node": 64.0}, name="lab")
    assert pprob.to_json() == prob.to_json()
    want = RefD(prob, samples=samples, **KW).run()
    got = DSpace4Cloud(pprob, samples=psamples, device="cpu", **KW).run()
    keyword = DSpace4Cloud(
        _port_args(_replay_problem()[0], None)[0], samples=psamples,
        deployment=pprob.deployment, device="cpu", **KW).run()
    assert want.deployment["coordinated"]
    for rep in (got, keyword):
        assert {k: s.as_dict() for k, s in rep.solutions.items()} == \
            {k: s.as_dict() for k, s in want.solutions.items()}
        assert rep.deployment == want.deployment
        assert rep.qn_dispatches == want.qn_dispatches


def test_interop_rejects_malformed_state():
    with pytest.raises(ValueError):
        interop.cache_from_reference({("abc", "m4.xlarge", 1, 0): 1.0})
    with pytest.raises(ValueError):
        interop.cache_from_reference({("0" * 16, "m4.xlarge", 1, 0): -1.0})
    with pytest.raises(ValueError):
        interop.samples_from_reference({("c", "vm"): ([], [1.0])})
