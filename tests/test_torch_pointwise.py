"""The port's point-wise gait against the reference's, on the CPU.

The paper's Algorithm 1 one probe at a time: ``qn_sim.simulate`` /
``response_time`` (one single-lane ``qn_event`` dispatch per
replication), ``evaluators.make_qn_evaluator``,
``hillclimb.optimize_class``/``hill_climb`` and
``DSpace4Cloud(batched=False)``.  Decisions, dispatch counts and searched
points must be equal; response times agree within a relative 1e-3 in
exponential mode (room for the one-ulp exponential draws, as in
``test_torch_slice.py``) and bit for bit in replay mode.  A scalar probe
must equal the same candidate's lane of the port's own batched call
exactly.  The problems are ``test_torch_slice.py``'s, at ``min_jobs=4``
and one replication, so the walks stay short on the plain event loop.
"""
import numpy as np
import pytest
import torch

from repro.core import qn_sim as ref_qn
from repro.core.evaluators import make_qn_evaluator as ref_make_qn
from repro.core.hillclimb import hill_climb as ref_hill_climb
from repro.core.hillclimb import optimize_class as ref_optimize_class
from repro.core.optimizer import DSpace4Cloud as RefD
from repro.core.problem import ApplicationClass, ClassSolution, JobProfile, \
    Problem, VMType
from repro.core.workload import DagJob as RefDagJob
from repro.core.workload import Stage as RefStage
from repro_torch.core import evaluators, hillclimb, qn_sim
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.core.problem import ClassSolution as PortSolution
from repro_torch.core.workload import DagJob, Stage
from repro_torch.obs import trace
from test_torch_slice import PROBLEMS, _port_args

torch.set_num_threads(1)    # the plain event loop is many tiny ops

KW = dict(min_jobs=4, replications=1)
DECIDED = ("vm_type", "nu", "reserved", "spot", "cost_per_h", "feasible")


def _assert_same_decisions(port, ref):
    assert port.solutions.keys() == ref.solutions.keys()
    for name, want in ref.solutions.items():
        got = port.solutions[name]
        for k in DECIDED:
            assert getattr(got, k) == getattr(want, k), (name, k)
        assert got.predicted_ms == pytest.approx(want.predicted_ms, rel=1e-3)
    assert port.total_cost_per_h == ref.total_cost_per_h
    assert port.qn_dispatches == ref.qn_dispatches > 0


def _moves(report):
    return {k: [m[0] for m in t.moves] for k, t in report.traces.items()}


# ------------------------------------------------------------ scalar gait

SIM_CASES = [  # n_map, n_reduce, h_users, slots, n_events
    (6, 2, 3, 4, 700), (1, 1, 5, 1, 600), (12, 3, 2, 40, 300)]


@pytest.mark.parametrize("case", SIM_CASES, ids=str)
def test_simulate_matches_the_reference(case):
    nm, nr, h, slots, ne = case
    kw = dict(n_map=nm, n_reduce=nr, m_avg=1200.0, r_avg=500.0,
              think_ms=9000.0, h_users=h, slots=slots, n_events=ne,
              warmup_jobs=4, seed=7)
    ref_s0 = ref_qn.sim_stats()
    want = ref_qn.simulate(ref_qn.QNParams(**kw), replications=2)
    ref_delta = {k: v - ref_s0[k] for k, v in ref_qn.sim_stats().items()}
    s0 = qn_sim.sim_stats()
    with trace.tracing() as tracer:
        got = qn_sim.simulate(qn_sim.QNParams(**kw), replications=2,
                              device="cpu")
    delta = {k: v - s0[k] for k, v in qn_sim.sim_stats().items()}
    assert got[0] == pytest.approx(want[0], rel=1e-3)
    assert got[1] == want[1] > 0
    assert delta == ref_delta
    pow2 = 1 << (ne - 1).bit_length()
    assert delta == {"dispatches": 2, "lanes": 2, "padded_lanes": 0,
                     "events_total": 2 * pow2, "events_useful": 2 * pow2}
    spans = tracer.by_name("kernel:scalar")
    assert [sp.args for sp in spans] == [{"events": pow2}] * 2


def _replay_lists(seed):
    g = np.random.default_rng(seed)
    return (g.lognormal(np.log(700), 0.5, 96).astype(np.float32),
            g.lognormal(np.log(250), 0.5, 40).astype(np.float32))


def test_response_time_replay_matches_the_reference_exactly():
    ms, rs = _replay_lists(2)
    kw = dict(n_map=12, n_reduce=3, m_avg=0.0, r_avg=0.0, think_ms=5000.0,
              h_users=2, min_jobs=4, warmup_jobs=4, seed=9, replications=2)
    want = ref_qn.response_time(slots=5, m_samples=ms, r_samples=rs, **kw)
    with trace.tracing() as tracer:
        got = qn_sim.response_time(slots=5, m_samples=ms, r_samples=rs,
                                   device="cpu", **kw)
    assert got == want
    assert [sp.args for sp in tracer.by_name("kernel:scalar")] == \
        [{"events": 512, "replay": True}] * 2       # pow2(1.5*34*8)


@pytest.mark.parametrize("replay", [False, True])
def test_scalar_probe_equals_its_batched_lane(replay):
    ms, rs = _replay_lists(4) if replay else (None, None)
    kw = dict(n_map=6, n_reduce=2, m_avg=1200.0, r_avg=500.0,
              think_ms=9000.0, h_users=3, min_jobs=4, warmup_jobs=4,
              seed=11, replications=2, m_samples=ms, r_samples=rs,
              device="cpu")
    slots = [2, 3, 5]                   # 3 lanes: padded to the lane grid
    scalar = [qn_sim.response_time(slots=s, **kw) for s in slots]
    batched = qn_sim.response_time_batch(slots=np.asarray(slots), **kw)
    assert np.array_equal(np.asarray(scalar), batched)


def test_response_time_events_follow_the_reference_budget():
    """``QNParams.n_events`` comes from ``events_needed`` and is bucketed
    to pow2, as the reference's ``response_time`` does."""
    s0 = qn_sim.sim_stats()
    qn_sim.response_time(n_map=3, n_reduce=1, m_avg=50.0, r_avg=20.0,
                         think_ms=500.0, h_users=1, slots=2, min_jobs=2,
                         warmup_jobs=2, replications=1, device="cpu")
    ne = qn_sim.sim_stats()["events_total"] - s0["events_total"]
    assert ne == qn_sim.padded_event_budget(3, 1, min_jobs=2,
                                            warmup_jobs=2) == 128


# ---------------------------------------------------------- evaluators

def test_qn_evaluator_caches_and_evaluates_dag_profiles():
    """The point-wise evaluator caches under the reference's key and
    refuses no DAG profile: a chain's evaluation (replay mode, one
    ``dag_event`` dispatch) equals the reference's ``make_qn_evaluator``
    bit for bit and lands in the cache under the reference's key."""
    prob, _ = PROBLEMS["exp"]()
    pprob, _ = _port_args(prob, None)
    cls, vm = pprob.classes[0], pprob.vm_types[0]
    cache = {}
    ev = evaluators.make_qn_evaluator(min_jobs=2, replications=1, cache=cache,
                                      device="cpu")
    s0 = qn_sim.sim_stats()["dispatches"]
    t = ev(cls, vm, 3)
    assert ev(cls, vm, 3) == t and len(cache) == 1
    assert qn_sim.sim_stats()["dispatches"] - s0 == 1     # the second hit
    (key,) = cache
    assert key[1:] == (vm.name, 3, 0)
    stages = ((4, 100.0), (2, 50.0))
    smp = {("dag", vm.name): np.random.default_rng(3).lognormal(
        np.log(80.0), 0.4, (2, 64)).astype(np.float32)}
    dag_cls = ApplicationClass(name="dag", h_users=2, think_ms=1000.0,
                               deadline_ms=5000.0, profiles={
                                   vm.name: DagJob("d", tuple(
                                       Stage(*s) for s in stages))})
    ref_job = RefDagJob("d", tuple(RefStage(*s) for s in stages))
    ref_cls = ApplicationClass(name="dag", h_users=2, think_ms=1000.0,
                               deadline_ms=5000.0,
                               profiles={vm.name: ref_job})
    ref_cache, dag_cache = {}, {}
    want = ref_make_qn(min_jobs=2, replications=1, cache=ref_cache,
                       samples=smp)(ref_cls, vm, 2)
    ev = evaluators.make_qn_evaluator(min_jobs=2, replications=1,
                                      cache=dag_cache, samples=smp,
                                      device="cpu")
    s0 = qn_sim.sim_stats()["dispatches"]
    assert ev(dag_cls, vm, 2) == want and np.isfinite(want)
    assert qn_sim.sim_stats()["dispatches"] - s0 == 1
    assert dag_cache == ref_cache


# ------------------------------------------------- Algorithm 1 end to end

# EXP has two classes, so ``parallel`` walks them in two threads; REPLAY
# has one, which ``hill_climb`` walks in the caller's thread either way
RUNS = [("exp", True), ("exp", False), ("replay", True)]


@pytest.fixture(scope="module")
def pointwise():
    """``run(parallel=...)`` of ``batched=False`` in both packages, each
    with its own cache, on fresh instances."""
    out = {}
    for name, par in RUNS:
        prob, samples = PROBLEMS[name]()
        ref_cache, cache = {}, {}
        ref = RefD(prob, samples=samples, batched=False, cache=ref_cache,
                   **KW).run(parallel=par)
        pprob, psamples = _port_args(prob, samples)
        port = DSpace4Cloud(pprob, samples=psamples, batched=False,
                            cache=cache, device="cpu", **KW).run(parallel=par)
        out[name, par] = (ref, port, ref_cache, cache)
    return out


def _run_id(run):
    return f"{run[0]}-{'parallel' if run[1] else 'serial'}"


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_pointwise_decisions_equal(pointwise, run):
    ref, port, _, _ = pointwise[run]
    _assert_same_decisions(port, ref)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_pointwise_search_and_accounting_equal(pointwise, run):
    ref, port, _, _ = pointwise[run]
    assert port.telemetry["qn"] == ref.telemetry["qn"]
    assert port.evals == ref.evals == port.qn_dispatches   # 1 replication
    assert _moves(port) == _moves(ref)
    assert port.initial.keys() == ref.initial.keys()
    for k, s in ref.initial.items():
        assert port.initial[k].as_dict() == s.as_dict()


def test_threads_do_not_change_the_walk(pointwise):
    _, par, _, _ = pointwise["exp", True]
    _, ser, _, _ = pointwise["exp", False]
    assert {k: s.as_dict() for k, s in par.solutions.items()} == \
        {k: s.as_dict() for k, s in ser.solutions.items()}
    assert {k: t.moves for k, t in par.traces.items()} == \
        {k: t.moves for k, t in ser.traces.items()}
    assert par.telemetry["qn"] == ser.telemetry["qn"]


@pytest.mark.parametrize("run", [("exp", True), ("replay", True)],
                         ids=_run_id)
def test_pointwise_cache_answers_a_batched_run(pointwise, run):
    """The point-wise walk's cache, handed to a batched run of the same
    problem: the race re-probes only what the walk did not, with the
    reference's dispatch count and decisions."""
    name = run[0]
    _, _, ref_cache, cache = pointwise[run]
    prob, samples = PROBLEMS[name]()
    ref = RefD(prob, samples=samples, cache=dict(ref_cache), **KW).run()
    pprob, psamples = _port_args(prob, samples)
    port = DSpace4Cloud(pprob, samples=psamples, cache=dict(cache),
                        device="cpu", **KW).run()
    _assert_same_decisions(port, ref)
    assert port.telemetry["qn"] == ref.telemetry["qn"]


def _stall_problem():
    """One class whose deadline (2 s) lies between the analytic model's
    asymptote (~1.15 s: the initial solution proposes nu = 1) and the
    QN's fork-join floor (~2.2 s: no nu can meet it), so the walk climbs
    until ``stall_patience`` increments bring no gain."""
    prof = JobProfile(n_map=4, n_reduce=1, m_avg=1000, m_max=1500,
                      r_avg=500, r_max=800)
    vm = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                containers_per_core=2)
    return Problem(classes=[ApplicationClass(
        name="s", h_users=2, think_ms=5000, deadline_ms=2000, eta=0.3,
        profiles={"m4.xlarge": prof})], vm_types=[vm])


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["parallel", "serial"])
def test_hill_climb_matches_the_reference(parallel):
    """``hill_climb`` with the point-wise evaluator, called directly: the
    stall class beside a class whose looser deadline (3 s) the walk meets
    and then descends to nu = 1, in two worker threads or one after the
    other; verdicts and walks are the reference's."""
    prob = _stall_problem()
    (cls,), (vm,) = prob.classes, prob.vm_types
    loose = ApplicationClass(name="f", h_users=2, think_ms=5000,
                             deadline_ms=3000, eta=0.3,
                             profiles=dict(cls.profiles))
    prob = Problem(classes=[cls, loose], vm_types=[vm])
    init = {c.name: ClassSolution(vm_type=vm.name, nu=nu, reserved=nu,
                                  spot=0, cost_per_h=0.0, predicted_ms=0.0,
                                  feasible=True)
            for c, nu in zip(prob.classes, (1, 3))}
    pprob, _ = _port_args(prob, None)
    pinit = {k: PortSolution(**s.as_dict()) for k, s in init.items()}
    want, want_tr = ref_hill_climb(prob, init, ref_make_qn(**KW),
                                   parallel=parallel)
    got, got_tr = hillclimb.hill_climb(
        pprob, pinit, evaluators.make_qn_evaluator(device="cpu", **KW),
        parallel=parallel)
    assert {k: s.as_dict() for k, s in got.items()} == \
        {k: s.as_dict() for k, s in want.items()}
    assert {k: t.moves for k, t in got_tr.items()} == \
        {k: t.moves for k, t in want_tr.items()}
    assert [m[0] for m in got_tr["s"].moves] == list(range(1, 8))
    assert [m[0] for m in got_tr["f"].moves] == [3, 2, 1]


def test_stall_path_gives_the_reference_verdict():
    prob = _stall_problem()
    pprob, _ = _port_args(prob, None)
    (cls,), (vm,) = prob.classes, prob.vm_types
    (pcls,), (pvm,) = pprob.classes, pprob.vm_types
    want = ref_optimize_class(cls, vm, 1, ref_make_qn(min_jobs=4,
                                                      replications=1))
    tr = hillclimb.HCTrace(cls=pcls.name)
    got = hillclimb.optimize_class(
        pcls, pvm, 1, evaluators.make_qn_evaluator(
            min_jobs=4, replications=1, device="cpu"), trace=tr)
    assert got.as_dict() == want.as_dict()
    assert not got.feasible and got.nu == 7         # 1 + stall_patience
    assert [m[0] for m in tr.moves] == list(range(1, 8)) and tr.evals == 7


def test_run_fast_and_run_steps_with_batched_false_match_the_reference():
    """``run_fast`` races with scalar probes, and ``run_steps`` proposes
    the batched gait's windows whatever the evaluator; both as the
    reference's do, on the stall problem with 4-point windows."""
    prob = _stall_problem()
    pprob, _ = _port_args(prob, None)
    ref_d = RefD(prob, batched=False, window=4, **KW)
    port_d = DSpace4Cloud(pprob, batched=False, window=4, device="cpu", **KW)
    ref, port = ref_d.run(), port_d.run()
    _assert_same_decisions(port, ref)
    assert _moves(port) == _moves(ref) == {"s@m4.xlarge": list(range(1, 8))}
    ref, port = ref_d.run_fast(), port_d.run_fast()
    _assert_same_decisions(port, ref)
    assert _moves(port) == _moves(ref)

    def drive(d):
        gen, results, windows = d.run_steps(), None, []
        while True:
            try:
                reqs = gen.send(results) if results is not None \
                    else next(gen)
            except StopIteration as stop:
                return stop.value, windows
            windows.append([(r.rid, list(r.nus)) for r in reqs])
            results = {r.rid: np.asarray([d.evaluate(r.cls, r.vm, int(n))
                                          for n in r.nus]) for r in reqs}

    (ref, ref_w), (port, port_w) = drive(ref_d), drive(port_d)
    assert port_w == ref_w and len(port_w) > 1
    for name, want in ref.solutions.items():
        got = port.solutions[name]
        assert all(getattr(got, k) == getattr(want, k) for k in DECIDED)
