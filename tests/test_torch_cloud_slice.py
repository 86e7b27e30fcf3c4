"""The private-cloud slice as a whole, the port against the reference on
the CPU (``device="cpu"``): the point-wise gait coordinating on a private
cluster, ``benchmarks/torch_scenarios.private_cloud_bench``'s day on the
over-committed cluster, and ``private_cloud_real``'s path (the drive
``chip_smoke.py`` [cloud] runs at real size on the card) on a small
replay problem.  The case-by-case mirror of ``tests/test_private_cloud.py``
is ``test_torch_cloud.py``, whose helpers these use.  Tolerances as there:
decisions, deployment summaries, assignments, dispatch counts and masks
exactly; a ``predicted_ms`` within a relative 1e-3 (exponential mode).
"""
import numpy as np
import torch

from benchmarks import port_reference_decisions as ref_scen
from benchmarks import torch_scenarios as port_scen
from repro.core.problem import ApplicationClass as RefClass
from repro.core.problem import JobProfile as RefProfile
from repro.core.problem import Problem as RefProblem
from repro.core.problem import VMType as RefVM
from repro_torch.core.problem import ApplicationClass, JobProfile, \
    Problem, VMType
from test_torch_cloud import KW, _day, _report, both, equal, hosts, \
    make_problem

torch.set_num_threads(1)    # the plain event loop is many tiny ops


def test_pointwise_gait_coordinates_like_the_reference():
    """``batched=False`` on an over-committed cluster (one class, 8 cores
    for a 16-core public plan): Algorithm 1, then the coordinator's probes
    one scalar simulation each."""
    def run(ns):
        prob = make_problem(ns, 1)
        c = hosts(ns, 2, 4, energy_cost_per_h=0.3)
        d0 = ns.qn.dispatch_count()
        rep = ns.D(prob, deployment=c, batched=False, **KW).run(
            parallel=False)
        return rep, ns.qn.dispatch_count() - d0
    (want, d_want), (got, d_got) = both(run)
    equal(_report(want), _report(got))
    assert d_got == d_want
    assert got.deployment["coordinated"]


def test_day_on_the_overcommitted_cluster_equals_the_reference():
    """``private_cloud_bench``'s private day, cut to one window of its
    second level and one of its fourth: every window coordinated,
    contracts, costs, rounds, dispatches and the one batched feasibility
    mask."""
    day = {f"c{i}": [2, 6] for i in range(3)}

    def run(ns):
        c = hosts(ns, 6, 4, energy_cost_per_h=0.3)
        return ns.windows.plan_day(make_problem(ns, 3), day, deployment=c,
                                   **KW, **ns.dev)
    want, plan = both(run)
    equal(_day(want), _day(plan))
    assert plan.windows_feasible == want.windows_feasible


def test_real_drive_path_equals_the_reference_on_a_small_replay_problem(
        monkeypatch):
    """``private_cloud_real``'s path (two replay classes merged, the
    cluster sized from the public plan, three gaits, the service with a
    public tenant and a core budget) with a small replay problem in place
    of the §4.3 scenarios: replay mode, so every number is exact; the
    service's private job equals its solo ``run()`` bit for bit."""
    def small(P, AC, Profile, VM):
        def scenario(query, users, deadline_ms):
            prof = Profile(n_map=8, n_reduce=2, m_avg=3000, m_max=7000,
                           r_avg=1500, r_max=3500)
            vms = [VM(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                      containers_per_core=2),
                   VM(name="CINECA", cores=20, sigma=0.35, pi=0.90,
                      speed=1.2)]
            g = np.random.default_rng(len(query) + int(query[1:]))
            name = f"{query}-{users}u"
            samples = {(name, vm.name): (
                g.lognormal(np.log(3000), 0.4, 256).astype(np.float32),
                g.lognormal(np.log(1500), 0.4, 128).astype(np.float32))
                for vm in vms}
            cls = AC(name=name, h_users=4, think_ms=500.0,
                     deadline_ms=deadline_ms / 15, eta=0.3,
                     profiles={vm.name: prof for vm in vms})
            return P(classes=[cls], vm_types=vms), samples, None
        return scenario

    monkeypatch.setattr(ref_scen, "scenario_problem",
                        small(RefProblem, RefClass, RefProfile, RefVM))
    monkeypatch.setattr(port_scen, "scenario_problem",
                        small(Problem, ApplicationClass, JobProfile, VMType))
    monkeypatch.setattr(port_scen, "REAL_HOST_CORES", 4)
    monkeypatch.setattr(port_scen, "REAL_INFLIGHT_EVENTS", 10 ** 9)
    kw = dict(min_jobs=4, replications=1)
    want = ref_scen.private_cloud_real(**kw)
    got = port_scen.private_cloud_real("cpu", **kw)
    assert port_scen.mismatches(want, got) == []
    assert got["service_equal_solo"]
    assert got["capacity_cores"] < got["demand_cores"]
    assert got["run"]["deployment"]["coordinated"]
    assert got["service"]["jobs"]["job-0000"]["tenant"] == "private"
