"""The port's multi-tenant solver service (``repro_torch.service``) against
the reference's (``repro.service``), in one process on the CPU
(``device="cpu"``: the kernels' plain versions), at cut budgets.

Each drive runs on both packages with the same problems and budgets
(``benchmarks/torch_scenarios.py`` against
``benchmarks/port_reference_decisions.py``): decisions, job states,
rounds, fused dispatches, points requested, dispatched, cached and
deduplicated, cache and admission stats and the per-tenant split are
equal; exponential-mode response times within a relative 1e-3 (the
one-ulp ``log1p`` differences of the draws), replay-mode ones exactly.
Each service estimate equals the port's own solo ``run()`` bit for bit.
The two registries are compared by deltas only: both packages name their
metrics alike.  Budgets, on one worker (~60 s in all).
"""
import json

import numpy as np
import pytest
import torch

from benchmarks import port_reference_decisions as ref
from benchmarks import torch_scenarios as port
from repro.core.problem import ApplicationClass as RefClass
from repro.core.problem import JobProfile as RefProfile
from repro.core.problem import Problem as RefProblem
from repro.core.problem import VMType as RefVM
from repro.core.workload import DagJob as RefDag
from repro.core.workload import Stage as RefStage
from repro.service import AdmissionController as RefAdmission
from repro.service import EvalCache as RefCache
from repro.service import SolverService as RefService
from repro.service import estimate_job_events as ref_estimate
from repro_torch.core import interop
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.core.problem import ApplicationClass, JobProfile, \
    Problem, VMType
from repro_torch.obs import registry
from repro_torch.service import AdmissionController, EvalCache, JobState, \
    SolverService, estimate_job_events, parse_submission

torch.set_num_threads(1)    # the plain event loop is many tiny ops

CUT = dict(min_jobs=8, replications=1)


# ------------------------------------------------------------- the drives

@pytest.fixture(scope="module")
def serve_many_pair():
    return ref.serve_many(**CUT), port.serve_many("cpu", **CUT)


def test_serve_many_equals_the_reference(serve_many_pair):
    want, got = serve_many_pair
    assert port.mismatches(want, got, rel=1e-3) == []
    assert got["rounds"] > 1 and got["scheduler"]["fused_dispatches"] > 1
    assert got["points_cached"] > 0
    assert got["timing"]["dispatches"] == \
        got["scheduler"]["fused_dispatches"]
    assert got["jobs"]["job-0004"]["tenant"] == "json-tenant"


def test_serve_many_estimates_equal_solo_runs_bit_for_bit():
    svc = SolverService(window=port.SERVE_MANY_WINDOW, device="cpu")
    probs = [port.serve_many_problem(i) for i in range(2)]
    jids = [svc.submit(p, **CUT) for p in probs]
    jobs = svc.run_until_complete()
    for jid, p in zip(jids, probs):
        solo = DSpace4Cloud(p, window=port.SERVE_MANY_WINDOW, device="cpu",
                            **CUT).run()
        assert port.job_equal(jobs[jid].report, solo)


def _mixed(P, Dag, Stage, AC, VM, Profile):
    small = VM(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
               containers_per_core=2)
    big = VM(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    bi = Profile(n_map=16, n_reduce=4, m_avg=4000, m_max=9000, r_avg=2000,
                 r_max=4500)
    chain = Dag("etl", stages=(Stage(12, 900, 2200), Stage(6, 700, 1700),
                               Stage(2, 1500, 3200)))
    return P(classes=[
        AC(name="bi", h_users=3, think_ms=10_000, deadline_ms=30_000,
           eta=0.3, profiles={"m4.xlarge": bi, "c20.node": bi.scaled(1.35)}),
        AC(name="etl", h_users=2, think_ms=9_000, deadline_ms=9_000,
           eta=0.3, profiles={"m4.xlarge": chain,
                              "c20.node": chain.scaled(1.35)}),
    ], vm_types=[small, big])


def test_mixed_mapreduce_and_dag_problem_equals_the_reference():
    """One MapReduce and one DAG class in one problem, submitted twice
    (once as JSON): every round one fused dispatch a workload kind, the
    repeat job folded into the same lanes."""
    from repro_torch.core.workload import DagJob, Stage
    kw = dict(min_jobs=4, replications=1)
    want = ref.spark_dag_service(
        problem=_mixed(RefProblem, RefDag, RefStage, RefClass, RefVM,
                       RefProfile), **kw)
    got = port.spark_dag_service(
        "cpu", problem=_mixed(Problem, DagJob, Stage, ApplicationClass,
                              VMType, JobProfile), **kw)
    assert port.mismatches(want, got, rel=1e-3) == []
    assert got["solo_equal"] == [True, True]
    sched = got["scheduler"]
    assert sched["points_dispatched"] * 2 == sched["points_requested"]
    assert got["points_deduped"] == sched["points_dispatched"]
    assert sched["fused_dispatches"] == 2 * got["rounds"]


def test_service_throughput_warm_trace_and_scrape_equal_the_reference():
    """Three of service_throughput's tenants: solo against the service,
    a warm resubmission with no dispatch, the traced span chain and the
    HTTP scrape of the live service (in process, on localhost)."""
    want = ref.service_throughput(n_jobs=3, **CUT)
    got = port.service_throughput("cpu", n_jobs=3, trace=True, http=True,
                                  **CUT)
    assert port.mismatches(want, got, rel=1e-3) == []
    assert got["parity"] and got["warm_parity"]
    assert got["warm_dispatches"] == 0 and got["warm_hit_rate"] == 1.0
    assert got["service_dispatches"] == 1 == max(got["solo_dispatches"])
    tr = got["trace"]
    assert tr["deepest_kernel_chain"][0] == "service.run"
    assert tr["deepest_kernel_chain"][-3:] == ["flush", "fused_dispatch",
                                               "kernel:plain"]
    sc = got["scrape"]
    assert sc["tenants"] == 3 and sc["metric_families"] > 10
    assert sc["split"]["points_dispatched"] == \
        sc["scheduler"]["points_dispatched"]


def test_q1_tenants_path_equals_the_reference_on_a_small_replay_problem(
        monkeypatch):
    """The Q1 drive's code path (tenants sharing one class name and
    profile, replay lists, admission deferring the later tenants) with a
    small replay problem in place of the §4.3 scenario: replay mode, so
    every number is exact; each job equals its solo run."""
    from repro.core.tpcds import THINK_MS

    def small(P, AC, Profile, VM):
        def scenario(query, users, deadline_ms):
            prof = Profile(n_map=8, n_reduce=2, m_avg=3000, m_max=7000,
                           r_avg=1500, r_max=3500)
            vm = VM(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                    containers_per_core=2)
            g = np.random.default_rng(3)
            name = f"{query}-{users}u"
            samples = {(name, vm.name): (
                g.lognormal(np.log(3000), 0.4, 256).astype(np.float32),
                g.lognormal(np.log(1500), 0.4, 128).astype(np.float32))}
            cls = AC(name=name, h_users=4, think_ms=THINK_MS / 20,
                     deadline_ms=deadline_ms / 15, eta=0.3,
                     profiles={vm.name: prof})
            return P(classes=[cls], vm_types=[vm]), samples, None
        return scenario

    monkeypatch.setattr(ref, "scenario_problem",
                        small(RefProblem, RefClass, RefProfile, RefVM))
    monkeypatch.setattr(port, "scenario_problem",
                        small(Problem, ApplicationClass, JobProfile, VMType))
    kw = dict(min_jobs=6, replications=2)
    want = ref.q1_tenants(**kw)
    got = port.q1_tenants("cpu", **kw)
    assert port.mismatches(want, got) == []
    assert got["solo_equal"] == [True] * 4
    assert got["cache"]["hits"] + got["points_deduped"] > 0
    assert [j["tenant"] for j in got["jobs"].values()] == \
        [f"Q1-{d}s" for d in port.Q1_TENANT_DEADLINES_S]


# ------------------------------------------------------------ the cache

def test_reference_spill_loads_and_serves_with_no_dispatch(tmp_path):
    spill = str(tmp_path / "spill.json")
    probs = [ref.serve_many_problem(i) for i in range(2)]
    svc = RefService(window=8, cache_path=spill)
    for p in probs:
        svc.submit(p, **CUT)
    want = svc.run_until_complete()
    rows = json.load(open(spill))
    assert rows and all(len(r) == 5 for r in rows)
    cache = EvalCache(spill)
    assert len(cache) == len(rows)
    warm = SolverService(window=8, cache=cache, device="cpu")
    jids = [warm.submit(interop.problem_from_reference(p.to_json()), **CUT)
            for p in probs]
    d0 = warm.scheduler.fused_dispatches
    got = warm.run_until_complete()
    assert warm.scheduler.fused_dispatches == d0 == 0
    assert warm.scheduler.points_dispatched == 0
    assert cache.hit_rate == 1.0
    for jid, (_, job) in zip(jids, sorted(want.items())):
        assert {k: v.as_dict() for k, v in
                got[jid].report.solutions.items()} == \
            {k: v.as_dict() for k, v in job.report.solutions.items()}
    # and the port's spill loads in the reference, row for row
    out = str(tmp_path / "port.json")
    cache.save(out)
    assert sorted(map(tuple, json.load(open(out)))) == \
        sorted(map(tuple, rows))
    assert len(RefCache(out)) == len(rows)


def test_cache_counts_hits_per_tenant():
    before = registry().snapshot("cache.")
    c = EvalCache()
    c.put(("d", "vm", 1, 0), 5.0)
    assert c.lookup(("d", "vm", 1, 0), tenant="a") == 5.0
    assert c.lookup(("d", "vm", 2, 0), tenant="a") is None
    assert c.lookup(("d", "vm", 2, 0)) is None
    after = registry().snapshot("cache.")
    delta = lambda k: after.get(k, 0) - before.get(k, 0)
    assert (delta("cache.hits"), delta("cache.misses"),
            delta('cache.hits{tenant="a"}'),
            delta('cache.misses{tenant="a"}')) == (1, 2, 1, 1)
    assert c.stats() == {"entries": 1, "hits": 1, "misses": 2,
                         "hit_rate": 1 / 3}


# ------------------------------------------------------------- admission

VM_A = dict(name="vm", cores=2, sigma=0.05, pi=0.20)
KW = dict(min_jobs=6, replications=1, seed=3)


def _one_class(P, AC, Profile, VM, deadline_ms, name="c", n_map=8,
               m_avg=1500.0, think=8000.0):
    prof = Profile(n_map=n_map, n_reduce=2, m_avg=m_avg, m_max=2 * m_avg,
                   r_avg=700 if m_avg < 1e6 else m_avg,
                   r_max=1500 if m_avg < 1e6 else 2 * m_avg)
    cls = AC(name=name, h_users=2, think_ms=think, deadline_ms=deadline_ms,
             eta=0.25, profiles={"vm": prof})
    return P(classes=[cls], vm_types=[VM(**VM_A)])


def _tight(est, probs):
    return max(est(p, window=4, min_jobs=6, warmup_jobs=8, replications=1)
               for p in probs)


# case -> (problems as (deadline, n_map[, m_avg]), admission kw or a
# function of the problems and estimator)
ADMISSION = {
    "tight_budget": ([(45_000.0, 8), (45_000.0, 10), (45_000.0, 12)],
                     lambda probs, est: dict(
                         max_inflight_events=_tight(est, probs))),
    "shed_oversize": ([(45_000.0, 8)],
                      lambda probs, est: dict(max_inflight_events=10,
                                              policy="shed")),
    "queue_oversize": ([(45_000.0, 8)],
                       lambda probs, est: dict(max_inflight_events=10,
                                               policy="queue")),
    "fifo": ([(30_000.0, 8), (45_000.0, 40), (60_000.0, 8)],
             lambda probs, est: dict(
                 max_inflight_events=_tight(est, [probs[0], probs[2]]),
                 policy="queue")),
    "max_queue_shed": ([(30_000.0, 8), (45_000.0, 8)],
                       lambda probs, est: dict(max_inflight_events=10**9,
                                               policy="shed", max_queue=1)),
    "max_queue_queue": ([(30_000.0, 8), (45_000.0, 8)],
                        lambda probs, est: dict(max_inflight_events=10**9,
                                                policy="queue",
                                                max_queue=1)),
    "failed_job_releases": ([(10.0, 4, 1e9), (60_000.0, 8)],
                            lambda probs, est: {}),
    "infeasible": ([(3_500.0, 8)], lambda probs, est: {}),
}


def _admission_case(case, P, AC, Profile, VM, Service, Admission, est,
                    **dev):
    specs, adm_kw = ADMISSION[case]
    probs = [_one_class(P, AC, Profile, VM, d, n_map=n,
                        **({"m_avg": rest[0], "think": 1000.0}
                           if rest else {}))
             for d, n, *rest in specs]
    adm = Admission(**adm_kw(probs, est))
    svc = Service(window=4, admission=adm, **dev)
    jids = [svc.submit(p, **KW) for p in probs]
    queued = [svc.job(j).state for j in jids]
    jobs = svc.run_until_complete()
    return {"queued": queued,
            "states": [jobs[j].state for j in jids],
            "errors": [bool(jobs[j].error) for j in jids],
            "started_order": sorted(
                range(len(jids)),
                key=lambda i: (jobs[jids[i]].started_s or float("inf"), i)),
            "admission": adm.stats.as_dict(),
            "scheduler": svc.scheduler.stats(), "rounds": svc.rounds,
            "digests_left": len(svc.scheduler._digests),
            "nu": [{k: (v.nu, v.feasible) for k, v in
                    jobs[j].report.solutions.items()}
                   if jobs[j].report else None for j in jids]}


@pytest.mark.parametrize("case", sorted(ADMISSION))
def test_admission_cases_equal_the_reference(case):
    want = _admission_case(case, RefProblem, RefClass, RefProfile, RefVM,
                           RefService, RefAdmission, ref_estimate)
    got = _admission_case(case, Problem, ApplicationClass, JobProfile,
                          VMType, SolverService, AdmissionController,
                          estimate_job_events, device="cpu")
    assert got == want
    assert got["digests_left"] == 0
    adm = got["admission"]
    assert adm["inflight_events"] == 0
    if case == "tight_budget":
        assert adm["deferred"] > 0 and got["scheduler"][
            "fused_dispatches"] >= 3
    elif case == "shed_oversize":
        assert got["states"] == [JobState.SHED] and adm["admitted"] == 0
    elif case == "queue_oversize":
        assert adm["oversize_admitted"] == 1
    elif case == "fifo":
        assert adm["oversize_admitted"] == 1
        assert got["started_order"].index(2) > got["started_order"].index(1)
    elif case.startswith("max_queue"):
        assert got["queued"] == [JobState.QUEUED, JobState.SHED]
    elif case == "failed_job_releases":
        assert got["states"][0] == JobState.FAILED and got["errors"][0]
    else:
        assert got["states"] == [JobState.INFEASIBLE]


def test_unknown_solver_option_rejected_at_intake():
    doc = json.dumps({"problem": json.loads(_one_class(
        Problem, ApplicationClass, JobProfile, VMType, 45_000.0).to_json()),
        "solver": {"min_job": 6}})
    with pytest.raises(ValueError, match="min_job"):
        SolverService(device="cpu").submit(doc)


def test_submission_json_roundtrip():
    prob = _one_class(Problem, ApplicationClass, JobProfile, VMType,
                      45_000.0)
    doc = json.dumps({"problem": json.loads(prob.to_json()),
                      "solver": {"min_jobs": 6, "replications": 1,
                                 "seed": 3, "window": 4, "tag": "t1"}})
    p2, solver = parse_submission(doc)
    assert p2.to_json() == prob.to_json()
    svc = SolverService(device="cpu")
    jid = svc.submit(doc)
    job = svc.job(jid)
    assert job.tag == "t1" and job.window == 4 and job.tenant == "t1"
    assert job.spec.min_jobs == 6 and job.spec.seed == 3
    jobs = svc.run_until_complete()
    assert jobs[jid].state == JobState.DONE
    summary = svc.result(jid)
    assert summary["deployment"] is None and "total_cost_per_h" in summary


# ------------------------------------------------- deployment and device

def test_a_deployment_raises_at_submit():
    """A private ``deployment`` (the keyword, a JSON submission's
    ``solver.deployment`` or the problem's own field) no longer raises: the
    three jobs plan on the cluster as the reference's service plans them
    (decisions, deployment summaries, rounds, dispatches and admission
    stats equal), each equal to its solo run bit for bit, and are charged
    the cluster's cores."""
    from repro.cloud import PrivateCloud as RefCloud
    from repro.cloud import homogeneous_hosts as ref_hosts
    from repro_torch.cloud import PrivateCloud, homogeneous_hosts

    def run(P, AC, Profile, VM, Cloud, hosts, Service, dev):
        # 2 VMs meet 7 s publicly; one 2-core host holds one: truncated
        prob = _one_class(P, AC, Profile, VM, 7_000.0)
        cloud = Cloud(hosts=hosts(1, 2, energy_cost_per_h=0.1))
        svc = Service(**dev)
        own = _one_class(P, AC, Profile, VM, 7_000.0)
        own.deployment = cloud
        jids = [svc.submit(prob, deployment=cloud, **KW),
                svc.submit(json.dumps({
                    "problem": json.loads(prob.to_json()),
                    "solver": {"deployment": cloud.to_dict(), **KW}})),
                svc.submit(own.to_json(), **KW)]
        jobs = svc.run_until_complete()
        return prob, cloud, [jobs[j] for j in jids], svc.stats()

    _, _, want, wstats = run(RefProblem, RefClass, RefProfile, RefVM,
                             RefCloud, ref_hosts, RefService, {})
    prob, cloud, got, stats = run(Problem, ApplicationClass, JobProfile,
                                  VMType, PrivateCloud, homogeneous_hosts,
                                  SolverService, {"device": "cpu"})
    solo = DSpace4Cloud(prob, deployment=cloud, device="cpu", **KW).run()
    assert solo.deployment["coordinated"] and solo.deployment["used_fallback"]
    for w, g in zip(want, got):
        assert g.state == "infeasible"
        assert g.state == w.state and g.cores_estimate == w.cores_estimate
        assert g.cores_estimate == cloud.total_cores
        assert port.mismatches(
            {k: v.as_dict() for k, v in w.report.solutions.items()},
            {k: v.as_dict() for k, v in g.report.solutions.items()},
            rel=1e-3) == []
        assert g.report.deployment == w.report.deployment
        assert g.summary()["deployment"] == solo.deployment
        assert port.job_equal(g.report, solo)
    assert stats["rounds"] == wstats["rounds"]
    assert stats["scheduler"] == wstats["scheduler"]
    assert stats["admission"] == wstats["admission"]


def test_service_without_a_device_raises_on_a_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverService()
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverService(device="cuda")
    assert SolverService(device="cpu").device == torch.device("cpu")


# ------------------------------------------------------------ the scrape

def test_scrape_endpoints_in_process():
    import urllib.error
    import urllib.request

    from repro.obs.export import parse_openmetrics as ref_parse
    from repro_torch.obs.export import parse_openmetrics
    from repro_torch.service.http import _clean, healthz, serve
    svc = SolverService(window=4, device="cpu")
    # an infeasible job: its report holds an infinite margin somewhere
    for d in (60_000.0, 3_500.0):
        svc.submit(_one_class(Problem, ApplicationClass, JobProfile, VMType,
                              d), tag=f"t{int(d)}", **KW)
    svc.run_until_complete()
    handle = svc.serve_http()
    assert svc.serve_http() is handle
    try:
        get = lambda p: urllib.request.urlopen(handle.url + p, timeout=30)
        with get("/metrics") as r:
            assert r.headers["Content-Type"].startswith(
                "application/openmetrics-text")
            text = r.read().decode()
        with get("/healthz") as r:
            health = json.loads(r.read())
        with get("/statz") as r:
            statz = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
        with pytest.raises(OSError):        # the port is taken: no fallback
            serve(svc, host=handle.host, port=handle.port)
    finally:
        svc.stop_http()
    fams = parse_openmetrics(text)
    assert fams.keys() == ref_parse(text).keys()
    assert 'fusion_points_total{tenant="t60000"}' in \
        fams["fusion_points"]["samples"]
    assert health == json.loads(json.dumps(_clean(healthz(svc))))
    assert health["ok"] and health["rounds"] == svc.rounds
    assert set(statz["tenants"]) == {"t60000", "t3500"}
    assert statz["stats"]["scheduler"] == svc.scheduler.stats()
    assert statz["stats"]["shard"]["shards"] == 1
    assert _clean({"a": [float("inf"), -float("inf"), float("nan")]}) == \
        {"a": ["inf", "-inf", "nan"]}
