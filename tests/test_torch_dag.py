"""The port's DAG workloads (``repro_torch.core.dag``, ``kernels.dag_event``)
against the reference's ``repro.core.dag`` (JAX on the CPU).

1. Tables: the plain ``dag_streams`` against ``jax.random`` drawn as the
   reference's ``_dag_sim`` draws them (``dag.py:91-131``): the replay
   indices bit for bit, the unit exponentials within one ulp (torch's
   ``log1p`` is not XLA's) and the initial think clocks (a unit draw times
   think_ms) within two.  On CPU tensors no kernel is launched.
2. The event loop: the plain ``dag_event`` fed the reference's own tables
   gives the reference's ``(mean, count)`` per lane bit for bit against
   ``_dag_sim``'s batched program, in replay mode and in exponential mode
   (whose two multiply-adds XLA contracts: ``fma32`` in the plain
   version, ``__fmaf_rn`` in the kernel), on mixed chain lengths padded to
   the stage bucket, padding lanes, a single-slot lane and short budgets.
3. End to end: ``dag_response_time`` and ``response_time_batch`` on their
   own draws against the reference's (``tests/test_dag.py``'s JOB3, JOB2,
   mixed chain lengths, replay): replay mode bit for bit, exponential
   mode within a relative 1e-3 (room for a one-ulp draw to move an
   event); inside the port scalar equals batched bit for bit; dispatch
   accounting, budgets and ``simulate_dag_cluster`` equal.
4. The planner on a small mixed MapReduce + DAG problem: ``run()`` in both
   gaits and ``run_fast()`` give the reference's decisions and dispatch
   counts.
Budgets are small (``min_jobs`` 8, ``warmup_jobs`` 3, as the reference's
own ``FAST``), so the plain loop (one Python iteration per event) stays
quick.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dag as ref_dag
from repro.core import evaluators as ref_ev
from repro.core import qn_sim as ref_qn
from repro.core import shapes as ref_shapes
from repro.core.optimizer import DSpace4Cloud as RefD
from repro.core.problem import ApplicationClass, JobProfile, Problem, \
    VMType
from repro_torch.core import dag, evaluators, interop, qn_sim, shapes
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.kernels.dag_event import ops as dag_ops

torch.set_num_threads(1)    # the plain loop is many tiny ops

FAST = dict(min_jobs=8, warmup_jobs=3, replications=2)
JOB3 = ref_dag.DagJob(name="tez-3stage", stages=(
    ref_dag.Stage(n_tasks=40, t_avg=1000, t_max=2500),
    ref_dag.Stage(n_tasks=16, t_avg=800, t_max=2000),
    ref_dag.Stage(n_tasks=4, t_avg=1500, t_max=3000)))
JOB2 = ref_dag.DagJob(name="b", stages=(ref_dag.Stage(8, 1000, 2500),
                                        ref_dag.Stage(4, 500, 1200)))
# chains of 1..4 stages for the kernel-level lanes
CHAINS = [(6,), (8, 4), (10, 4, 2), (6, 5, 3, 2)]


def _port(job):
    return dag.DagJob(job.name, tuple(
        dag.Stage(s.n_tasks, s.t_avg, s.t_max, s.cv) for s in job.stages))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _ref_tables(think_ms, seeds, nea, *, H, E, NS=None):
    """The tables of ``_dag_sim`` (``dag.py:91-131``), one lane per seed:
    ``k0, key = split(key)``; service draws from ``fold_in(key, i)``;
    think draws from ``fold_in(key, i + n_events_active)``."""
    def lane(tm, sd, ne):
        k0, key = jax.random.split(jax.random.key(sd))
        think0 = jax.random.exponential(k0, (H,)) * tm
        idx = jnp.arange(E)

        def svc(i):
            ki = jax.random.fold_in(key, i)
            if NS is not None:
                return jax.random.randint(ki, (), 0, NS)
            return jax.random.exponential(ki)

        td = jax.vmap(lambda i: jax.random.exponential(
            jax.random.fold_in(key, i + ne)))(idx)
        return think0, jax.vmap(svc)(idx), td

    out = jax.vmap(lane)(jnp.asarray(think_ms), jnp.asarray(seeds),
                         jnp.asarray(nea))
    return [np.asarray(x) for x in out]


def _lanes(replay, H):
    """8 lanes: every chain length (exponential mode) or the 2-stage chain
    (replay mode, whose lanes share one stage count), padding lanes (zero
    budget), a single-slot lane and short budgets."""
    chains = [CHAINS[1]] * 8 if replay else [CHAINS[i % 4] for i in range(8)]
    jobs = [ref_dag.DagJob("c", tuple(ref_dag.Stage(n, 40.0 + 10 * k)
                                      for k, n in enumerate(c)))
            for c in chains]
    budget = max(ref_dag.padded_event_budget(j, min_jobs=4, warmup_jobs=2)
                 for j in jobs)
    K = ref_shapes.bucket_stages(max(len(c) for c in chains))
    nt = np.zeros((8, K), np.int32)
    ta = np.zeros((8, K), np.float32)
    for b, j in enumerate(jobs):
        nt[b, :len(j.stages)] = [s.n_tasks for s in j.stages]
        ta[b, :len(j.stages)] = [s.t_avg * (1 + 0.1 * b) for s in j.stages]
    lanes = dict(
        n_tasks=nt, t_avg=ta,
        n_stages=np.array([len(c) for c in chains], np.int32),
        slots_cap=np.array([1, 3, 5, 2, 8, 4, 6, 8], np.int32),
        n_events_active=np.array([budget, budget, 0, budget // 2, budget,
                                  budget // 4, 1, budget], np.int32),
        think_ms=np.full(8, 600.0, np.float32),
        seed=(1000 * np.arange(8)).astype(np.int32))
    samples = ref_dag.dag_replayer_lists(jobs[0], cap=97, seed=5) \
        if replay else None
    return lanes, samples, dict(h_users=H, max_slots=8, n_events=budget,
                                warmup_jobs=2)


@pytest.mark.parametrize("replay", [False, True])
def test_dag_streams_match_reference(replay):
    lanes, samples, st = _lanes(replay, 4)
    NS = None if samples is None else samples.shape[1]
    want = _ref_tables(lanes["think_ms"], lanes["seed"],
                       lanes["n_events_active"], H=4, E=st["n_events"],
                       NS=NS)
    launches = dag_ops.dag_streams.launches
    got = [x.numpy() for x in dag_ops.dag_streams(
        torch.tensor(lanes["think_ms"]), torch.tensor(lanes["seed"]),
        torch.tensor(lanes["n_events_active"]), h_users=4,
        n_events=st["n_events"], n_samples=NS)]
    assert dag_ops.dag_streams.launches == launches     # plain, on the CPU
    for w, g in zip(want, got):
        assert w.shape == g.shape and w.dtype == g.dtype
    if replay:                  # the service draw is a randint: exact
        assert np.array_equal(want[1], got[1])
        assert 0 <= got[1].min() and got[1].max() < NS
    # unit draws within one ulp; the initial think clocks, a unit draw
    # times think_ms, within two
    for w, g, tol in zip(want, got, (2, 1, 1)):
        if w.dtype == np.float32:
            assert _ulps(w, g).max() <= tol


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("H", [1, 3])
def test_plain_loop_bit_exact_vs_reference_on_its_tables(replay, H):
    lanes, samples, st = _lanes(replay, H)
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    want_m, want_c = ref_dag._dag_sim_batch_jit(
        jl["n_tasks"], jl["t_avg"], jl["think_ms"], jl["slots_cap"],
        jl["seed"], jl["n_events_active"], jl["n_stages"],
        None if samples is None else jnp.asarray(samples),
        has_samples=samples is not None, **st)
    NS = None if samples is None else samples.shape[1]
    tables = [torch.tensor(x) for x in _ref_tables(
        lanes["think_ms"], lanes["seed"], lanes["n_events_active"], H=H,
        E=st["n_events"], NS=NS)]
    if replay:
        tables[1] = tables[1].to(torch.int32)
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    launches = dag_ops.dag_event.launches
    s, c = dag_ops.dag_event(
        t["n_tasks"], t["t_avg"], t["n_stages"], t["slots_cap"],
        t["n_events_active"], t["think_ms"], *tables,
        None if samples is None else torch.tensor(samples),
        max_slots=st["max_slots"], warmup_jobs=st["warmup_jobs"])
    assert dag_ops.dag_event.launches == launches
    mean = s / torch.clamp(c, min=1.0)
    assert np.array_equal(np.asarray(want_c), c.numpy())
    assert np.array_equal(np.asarray(want_m), mean.numpy())
    assert c[2] == 0                                  # a padding lane
    assert bool((c[[0, 1, 4, 7]] > 0).all())          # full budgets finish


@pytest.mark.parametrize("replay", [False, True])
def test_sim_batch_equals_dag_streams_then_dag_event_on_the_cpu(replay):
    """The combined path (``sim_batch``, on the card one C entry point for
    both kernels) on CPU tensors: the same bits as ``dag_streams`` then
    ``dag_event`` called in turn, with ``depth`` given or read from the
    lanes, and no launch counted."""
    lanes, samples, st = _lanes(replay, 3)
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    seeds = t["seed"].to(torch.int64)
    smp = None if samples is None else torch.tensor(samples)
    before = (dag_ops.dag_streams.launches, dag_ops.dag_event.launches)
    tables = dag_ops.dag_streams(
        t["think_ms"], seeds, t["n_events_active"], h_users=3,
        n_events=st["n_events"],
        n_samples=None if samples is None else samples.shape[1])
    s, c = dag_ops.dag_event(
        t["n_tasks"], t["t_avg"], t["n_stages"], t["slots_cap"],
        t["n_events_active"], t["think_ms"], *tables, smp,
        max_slots=st["max_slots"], warmup_jobs=st["warmup_jobs"])
    for depth in (None, int(lanes["n_stages"].max())):
        mean, cnt = dag_ops.sim_batch(
            t["n_tasks"], t["t_avg"], t["n_stages"], t["think_ms"],
            t["slots_cap"], seeds, t["n_events_active"], smp, h_users=3,
            max_slots=st["max_slots"], n_events=st["n_events"],
            warmup_jobs=st["warmup_jobs"], depth=depth)
        assert torch.equal(cnt, c)
        assert torch.equal(mean, s / torch.clamp(c, min=1.0))
    assert (dag_ops.dag_streams.launches,
            dag_ops.dag_event.launches) == before
    assert bool((c[[0, 1, 4, 7]] > 0).all())


@pytest.mark.parametrize("replay,extra_rows", [(False, 0), (True, 0),
                                               (True, 2)])
def test_lanes_deeper_than_their_stage_arrays_match_reference(replay,
                                                              extra_rows):
    """Lanes of 40 and 5 stages over stage arrays of K = 2 to 4 stages,
    deeper than the arrays (the first also deeper than
    ``dag_event_fast``'s queue key holds, 31; the second finishes jobs):
    the reference's ``_dag_sim`` clips their stage index to their
    own count and each gather clamps it to its array's rows (the stage
    arrays' K, the replay lists' rows, here also more rows than K), for a
    finite answer; the plain loop on its tables equals it bit for bit, and
    ``route`` sends such a batch to the general route (which gathers as
    the reference does) from the depth read on the host."""
    lanes, samples, st = _lanes(replay, 3)
    if extra_rows:
        samples = np.concatenate([samples, samples[:extra_rows] * 1.5])
    lanes["n_stages"] = lanes["n_stages"].copy()
    lanes["n_stages"][[0, 3]] = (40, 5)
    lanes["n_events_active"] = lanes["n_events_active"].copy()
    lanes["n_events_active"][3] = st["n_events"]
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    want_m, want_c = ref_dag._dag_sim_batch_jit(
        jl["n_tasks"], jl["t_avg"], jl["think_ms"], jl["slots_cap"],
        jl["seed"], jl["n_events_active"], jl["n_stages"],
        None if samples is None else jnp.asarray(samples),
        has_samples=samples is not None, **st)
    NS = None if samples is None else samples.shape[1]
    tables = [torch.tensor(x) for x in _ref_tables(
        lanes["think_ms"], lanes["seed"], lanes["n_events_active"], H=3,
        E=st["n_events"], NS=NS)]
    if replay:
        tables[1] = tables[1].to(torch.int32)
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    s, c = dag_ops.dag_event(
        t["n_tasks"], t["t_avg"], t["n_stages"], t["slots_cap"],
        t["n_events_active"], t["think_ms"], *tables,
        None if samples is None else torch.tensor(samples),
        max_slots=st["max_slots"], warmup_jobs=st["warmup_jobs"], depth=40)
    mean = s / torch.clamp(c, min=1.0)
    assert bool(torch.isfinite(s).all()) and bool(torch.isfinite(c).all())
    assert c[3] > 0
    assert np.array_equal(np.asarray(want_c), c.numpy())
    assert np.array_equal(np.asarray(want_m), mean.numpy())
    K, E = lanes["n_tasks"].shape[1], st["n_events"]
    assert dag_ops.route(3, st["max_slots"], K, E) == "dag_event_fast"
    assert dag_ops.route(3, st["max_slots"], K, E,
                         depth=int(lanes["n_stages"].max())) == \
        "dag_event_general"


# --------------------------------------------------------------- end to end

def _both(fn_ref, fn_port):
    """Run both packages' calls; returns the results and the counter
    deltas of each (sim_stats and padding_stats)."""
    r0 = ref_qn.sim_stats(), ref_qn.padding_stats()
    want = fn_ref()
    r1 = ref_qn.sim_stats(), ref_qn.padding_stats()
    p0 = qn_sim.sim_stats(), qn_sim.padding_stats()
    got = fn_port()
    p1 = qn_sim.sim_stats(), qn_sim.padding_stats()
    delta = lambda a, b: [{k: b[i][k] - a[i][k] for k in b[i]}
                          for i in range(2)]
    return want, got, delta(r0, r1), delta(p0, p1)


CASES = {  # jobs, slots, replay
    "job2-frontier": ([JOB2] * 5, [2, 3, 5, 7, 10], False),
    "mixed-chains": ([JOB3, JOB2, JOB3], [6, 10, 16], False),
    "job2-replay": ([JOB2, JOB2, JOB2], [4, 8, 3], True),
}


@pytest.mark.parametrize("case", CASES)
def test_response_time_batch_and_scalar_match_reference(case):
    jobs, slots, replay = CASES[case]
    smp = ref_dag.dag_replayer_lists(JOB2, seed=3) if replay else None
    kw = dict(think_ms=8000.0, h_users=3, seed=7, samples=smp, **FAST)
    want, got, d_ref, d_port = _both(
        lambda: ref_dag.response_time_batch(jobs, slots=np.array(slots),
                                            **kw),
        lambda: dag.response_time_batch([_port(j) for j in jobs],
                                        slots=np.array(slots),
                                        device="cpu", **kw))
    assert d_port == d_ref and d_port[0]["dispatches"] == 1
    if replay:
        assert np.array_equal(want, got)
    else:
        assert np.allclose(got, want, rtol=1e-3, atol=0)
    # scalar equals batched inside the port, bit for bit; R dispatches each
    s0 = qn_sim.sim_stats()["dispatches"]
    scalar = np.array([dag.dag_response_time(_port(j), slots=s,
                                             device="cpu", **kw)
                       for j, s in zip(jobs, slots)])
    assert qn_sim.sim_stats()["dispatches"] - s0 == \
        len(jobs) * FAST["replications"]
    assert np.array_equal(scalar, got)
    assert np.isfinite(got).all()


def test_scalar_matches_reference_in_replay_and_exponential_mode():
    smp = ref_dag.dag_replayer_lists(JOB3, seed=55)
    kw = dict(think_ms=8000.0, h_users=2, seed=3, **{**FAST,
                                                     "replications": 1})
    for samples in (smp, None):
        want, got, d_ref, d_port = _both(
            lambda: ref_dag.dag_response_time(JOB3, slots=24,
                                              samples=samples, **kw),
            lambda: dag.dag_response_time(_port(JOB3), slots=24,
                                          samples=samples, device="cpu",
                                          **kw))
        assert d_port == d_ref
        assert got == want if samples is not None \
            else got == pytest.approx(want, rel=1e-3)


def test_short_replay_lists_clamp_their_row_as_the_reference():
    """Replay lists with fewer rows than the chain has stages: the
    reference's gather clamps the stage to the last row, and so do the
    port's batch and scalar paths (and its kernel, ``test_torch_cuda``)."""
    smp = ref_dag.dag_replayer_lists(JOB3, seed=21)[:2]
    kw = dict(think_ms=8000.0, h_users=3, seed=11, samples=smp, **FAST)
    slots = [5, 12]
    want, got, d_ref, d_port = _both(
        lambda: ref_dag.response_time_batch([JOB3] * 2, slots=slots, **kw),
        lambda: dag.response_time_batch([_port(JOB3)] * 2, slots=slots,
                                        device="cpu", **kw))
    assert d_port == d_ref and np.array_equal(want, got)
    scalar = [dag.dag_response_time(_port(JOB3), slots=s, device="cpu", **kw)
              for s in slots]
    assert np.array_equal(scalar, got) and np.isfinite(got).all()


def test_replay_batches_must_share_a_stage_count():
    smp = ref_dag.dag_replayer_lists(JOB2)
    with pytest.raises(ValueError, match="stage count"):
        dag.response_time_batch([_port(JOB2), _port(JOB3)], 1000.0, [4, 4],
                                2, samples=smp, device="cpu")
    out = dag.response_time_batch([], 1000.0, [], 2, device="cpu", defer=True)
    assert out.resolve().shape == (0,)


def test_budgets_buckets_and_analytic_tier_match_reference():
    for job in (JOB3, JOB2):
        for mj, wj in ((8, 3), (40, 8), (16, 4)):
            assert dag.padded_event_budget(_port(job), min_jobs=mj,
                                           warmup_jobs=wj) == \
                ref_dag.padded_event_budget(job, min_jobs=mj, warmup_jobs=wj)
            assert dag.dag_events_needed(_port(job), mj, wj) == \
                ref_dag.dag_events_needed(job, mj, wj)
            assert evaluators.workload_event_budget(
                _port(job), min_jobs=mj, warmup_jobs=wj) == \
                ref_ev.workload_event_budget(job, min_jobs=mj,
                                             warmup_jobs=wj)
        assert dag.dag_demand(_port(job)) == ref_dag.dag_demand(job)
        assert dag.dag_response_analytic(_port(job), 32, 8000.0, 4) == \
            ref_dag.dag_response_analytic(job, 32, 8000.0, 4)
        assert np.array_equal(dag.dag_replayer_lists(_port(job), seed=9),
                              ref_dag.dag_replayer_lists(job, seed=9))
    prof = JobProfile(n_map=8, n_reduce=2, m_avg=40.0, m_max=90.0,
                      r_avg=60.0, r_max=99.0)
    assert evaluators.workload_event_budget(
        prof, min_jobs=8, warmup_jobs=3) == ref_ev.workload_event_budget(
            prof, min_jobs=8, warmup_jobs=3)
    assert [shapes.bucket_stages(n) for n in range(1, 50)] == \
        [ref_shapes.bucket_stages(n) for n in range(1, 50)]


@pytest.mark.parametrize("job,kw", [
    (JOB3, dict(slots=24, h_users=2, think_ms=8000, max_jobs=30,
                warmup_jobs=4, seed=7)),
    (JOB2, dict(slots=3, h_users=5, think_ms=2000.0, seed=1))])
def test_simulate_dag_cluster_equals_reference(job, kw):
    assert dag.simulate_dag_cluster(_port(job), **kw) == \
        ref_dag.simulate_dag_cluster(job, **kw)


# ----------------------------------------------------------- the planner

def _mixed_problem():
    """A MapReduce class and a 3-stage chain in one problem, two VM types
    (``examples/spark_dag_plan.py`` at a CPU's size)."""
    small = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   containers_per_core=2)
    big = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    bi = JobProfile(n_map=16, n_reduce=4, m_avg=4000, m_max=9000,
                    r_avg=2000, r_max=4500)
    chain = ref_dag.DagJob("etl", stages=(
        ref_dag.Stage(12, 900, 2200), ref_dag.Stage(6, 700, 1700),
        ref_dag.Stage(2, 1500, 3200)))
    return Problem(classes=[
        ApplicationClass(name="bi", h_users=3, think_ms=10_000,
                         deadline_ms=30_000, eta=0.3,
                         profiles={"m4.xlarge": bi,
                                   "c20.node": bi.scaled(1.35)}),
        ApplicationClass(name="etl", h_users=2, think_ms=9_000,
                         deadline_ms=9_000, eta=0.3,
                         profiles={"m4.xlarge": chain,
                                   "c20.node": chain.scaled(1.35)}),
    ], vm_types=[small, big])


PLAN_KW = dict(min_jobs=4, replications=1)
GAITS = [("run", True), ("run_fast", True), ("run", False)]


@pytest.mark.parametrize("mode,batched", GAITS,
                         ids=[f"{m}-{'batched' if b else 'pointwise'}"
                              for m, b in GAITS])
def test_mixed_problem_decisions_match_reference(mode, batched):
    prob = _mixed_problem()
    ref = getattr(RefD(prob, batched=batched, **PLAN_KW), mode)()
    pprob = interop.problem_from_reference(prob.to_json())
    port = getattr(DSpace4Cloud(pprob, batched=batched, device="cpu",
                                **PLAN_KW), mode)()
    assert port.solutions.keys() == ref.solutions.keys()
    for name, want in ref.solutions.items():
        got = port.solutions[name]
        for k in ("vm_type", "nu", "reserved", "spot", "cost_per_h",
                  "feasible"):
            assert getattr(got, k) == getattr(want, k), (name, k)
        assert got.predicted_ms == pytest.approx(want.predicted_ms, rel=1e-3)
    assert port.qn_dispatches == ref.qn_dispatches > 0
    assert port.evals == ref.evals
