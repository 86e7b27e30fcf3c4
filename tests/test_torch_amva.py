"""The port's ``amva`` fixed point and exact MVA against the reference's
Pallas kernels (interpret mode on the CPU) and their jnp oracles, bit for
bit, and the analytic tier (``repro_torch.core.mva``) against
``repro.core.mva``.

Inputs come from a numpy seed (and, for the 512-lane case, from the
reference test's own generator, which includes the lane that is still
1.95e-4 from its fixed point after 40 rounds: the port must give the same
40-round value, not a converged one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mva as ref_mva
from repro.core.problem import JobProfile as RefJobProfile
from repro.kernels.amva import kernel as ref_amva_kernel
from repro.kernels.amva import ops as ref_amva_ops
from repro_torch.core import mva
from repro_torch.core.problem import JobProfile
from repro_torch.kernels.amva import ops as amva_ops
from repro_torch.kernels.amva import ref as amva_ref


def _batch(n, seed=0):
    g = np.random.default_rng(seed + n)
    a = (np.abs(g.normal(size=n)) * 1e4).astype(np.float32)
    b = (np.abs(g.normal(size=n)) * 1e3).astype(np.float32)
    z = np.full(n, 1e4, np.float32)
    h = np.round(np.abs(g.normal(size=n)) * 10 + 1).astype(np.float32)
    return a, b, z, h


def _port(args):
    return amva_ops.ps_fixed_point(*(torch.tensor(x) for x in args))


# N values below, on and across the reference's (8, 128) tile edges
@pytest.mark.parametrize("n", [1, 7, 97, 128, 129, 1000, 1024, 1025])
def test_ps_fixed_point_bit_exact_vs_pallas(n):
    args = _batch(n)
    want = np.asarray(ref_amva_ops.ps_fixed_point(*map(jnp.asarray, args)))
    assert np.array_equal(want, _port(args).numpy())


def test_512_lane_case_of_the_failing_reference_test():
    key = jax.random.key(0)
    n = 512
    a = jnp.abs(jax.random.normal(jax.random.fold_in(key, n), (n,))) * 1e4
    b = jnp.abs(jax.random.normal(jax.random.fold_in(key, n + 1), (n,))) * 1e3
    z = jnp.full((n,), 1e4)
    h = jnp.round(jnp.abs(jax.random.normal(
        jax.random.fold_in(key, n + 2), (n,))) * 10 + 1)
    args = tuple(np.asarray(x, np.float32) for x in (a, b, z, h))
    want = np.asarray(ref_amva_ops.ps_fixed_point(*map(jnp.asarray, args)))
    got = _port(args).numpy()
    assert np.array_equal(want, got)
    # the same lane stays unconverged at 40 rounds, as in the reference
    t80 = amva_ref.ps_fixed_point(*(torch.tensor(x) for x in args),
                                  iters=80).numpy()
    rel = np.abs(t80 - got) / np.abs(t80)
    assert rel.max() > 1e-4


def test_ps_response_batch_matches_reference_oracle():
    args = _batch(300, seed=5)
    want = np.asarray(ref_mva.ps_response_batch(*map(jnp.asarray, args)))
    got = mva.ps_response_batch(*(torch.tensor(x) for x in args))
    assert np.array_equal(want, got.numpy())


def test_wrapper_counts_only_kernel_launches():
    before = amva_ops.ps_fixed_point.launches
    _port(_batch(9))
    assert amva_ops.ps_fixed_point.launches == before   # CPU: plain version


def test_wrapper_rejects_bad_inputs():
    x = torch.ones(4)
    with pytest.raises(ValueError):
        amva_ops.ps_fixed_point(x, x, x, torch.ones(5))
    with pytest.raises(ValueError):
        amva_ops.ps_fixed_point(x.double(), x, x, x)
    with pytest.raises(ValueError):
        amva_ops.ps_fixed_point(x[None], x[None], x[None], x[None])


def _mva_batch(n):
    g = np.random.default_rng(100 + n)
    d = (np.abs(g.normal(size=n)) * 10 + 1).astype(np.float32)
    return d, np.full(n, 1e4, np.float32)


# the reference's grid (tests/test_kernels.py::test_mva_kernel_vs_ref)
@pytest.mark.parametrize("n", [5, 300, 1024])
@pytest.mark.parametrize("h_users", [1, 4, 25])
def test_mva_response_bit_exact_vs_pallas_and_oracle(n, h_users):
    d, z = _mva_batch(n)
    want = np.asarray(ref_amva_kernel.mva_fwd(jnp.asarray(d), jnp.asarray(z),
                                              h_users=h_users))
    oracle = np.asarray(ref_mva.mva_response_batch(jnp.asarray(d),
                                                   jnp.asarray(z), h_users))
    assert np.array_equal(want, oracle)
    td, tz = torch.tensor(d), torch.tensor(z)
    before = amva_ops.mva_response.launches
    for got in (amva_ref.mva_response(td, tz, h_users),
                amva_ops.mva_response(td, tz, h_users),
                mva.mva_response_batch(td, tz, h_users)):
        assert got.dtype == torch.float32
        assert np.array_equal(want, got.numpy())
    assert amva_ops.mva_response.launches == before     # CPU: plain version


def test_mva_response_with_no_users_returns_demand():
    """H = 0: the reference's kernel keeps its initial carry (q, r) =
    (0, d); its ``lax.scan`` oracle has no such case."""
    d, z = _mva_batch(300)
    want = np.asarray(ref_amva_kernel.mva_fwd(jnp.asarray(d), jnp.asarray(z),
                                              h_users=0))
    assert np.array_equal(want, d)
    assert np.array_equal(amva_ops.mva_response(
        torch.tensor(d), torch.tensor(z), 0).numpy(), d)


def test_mva_response_matches_the_scalar_recursion():
    """The float32 batch against the float64 scalar ``mva_response`` of
    both packages, on the degenerate single-station case."""
    got = amva_ops.mva_response(torch.tensor([1001.0]),
                                torch.tensor([10_000.0]), 5)
    exact = ref_mva.mva_response(1001.0, 10_000.0, 5)
    assert exact == mva.mva_response(1001.0, 10_000.0, 5)
    assert float(got[0]) == pytest.approx(exact, rel=1e-6)


def test_mva_wrapper_rejects_bad_inputs():
    x = torch.ones(4)
    with pytest.raises(ValueError):
        amva_ops.mva_response(x, torch.ones(5), 3)
    with pytest.raises(ValueError):
        amva_ops.mva_response(x.double(), x.double(), 3)
    for h in (-1, 2.5, True):
        with pytest.raises(ValueError):
            amva_ops.mva_response(x, x, h)


def _profiles(k):
    g = np.random.default_rng(k)
    for _ in range(k):
        nm, nr = int(g.integers(1, 600)), int(g.integers(0, 80))
        m, r = float(g.uniform(500, 9000)), float(g.uniform(300, 5000))
        yield (dict(n_map=nm, n_reduce=nr, m_avg=m, m_max=2.3 * m,
                    r_avg=r, r_max=2.1 * r, s1_max=float(g.uniform(0, 300))))


@pytest.mark.parametrize("k", [3, 8])
def test_scalar_analytic_tier_exact(k):
    for d in _profiles(k):
        p, rp = JobProfile(**d), RefJobProfile(**d)
        assert mva.aria_demand(p) == ref_mva.aria_demand(rp)
        for slots in (1, 7, 64, 433):
            for h, z in ((1, 0.0), (10, 10_000.0), (40, 3_000.0)):
                assert mva.job_response(p, slots, z, h) == \
                    ref_mva.job_response(rp, slots, z, h)
        assert mva.mva_response(d["m_avg"], 5_000.0, 12) == \
            ref_mva.mva_response(d["m_avg"], 5_000.0, 12)
        for deadline in (30_000.0, 200_000.0, 1e7):
            assert mva.min_slots_for_deadline(p, 10_000.0, 10, deadline) == \
                ref_mva.min_slots_for_deadline(rp, 10_000.0, 10, deadline)


# ------------------------------------------------- the frontier from scalars

def _frontier_cases():
    """(class, VM type) pairs of the reference: Q1-10u on its two VM types
    (m4.xlarge, 8 slots; CINECA, 20) and a 3-stage DAG class."""
    from repro.core import dag as ref_dag
    from repro.core import tpcds
    from repro.core.problem import ApplicationClass, VMType

    prob = tpcds.scenario_problem("Q1", 10, 160_000.0)[0]
    cls = prob.classes[0]
    job = ref_dag.DagJob("tez-3stage", (ref_dag.Stage(40, 1000.0, 2500.0),
                                        ref_dag.Stage(16, 800.0, 2000.0),
                                        ref_dag.Stage(4, 1500.0, 3000.0)))
    vm = VMType("m4.xlarge", cores=4, sigma=0.1, pi=0.2)
    dag_cls = ApplicationClass("spark", h_users=3, think_ms=9000.0,
                               deadline_ms=13_000.0, profiles={vm.name: job})
    return {f"Q1-10u {v.name}": (cls, v) for v in prob.vm_types} | {
        "dag m4.xlarge": (dag_cls, vm)}


@pytest.mark.parametrize("case", ["Q1-10u m4.xlarge", "Q1-10u CINECA",
                                  "dag m4.xlarge"])
def test_frontier_from_scalars_bit_exact_vs_reference_amva_frontier(case):
    """``ps_frontier``'s plain version, fed the frontier's scalars (the
    demand (a, b), the VM's slots, nu_lo, the class's think time and
    users), gives the reference's ``amva_frontier`` (its Pallas kernel in
    interpret mode) bit for bit over nu 1..8192: the float32 a_over_c,
    divided in float64 on the host, and T."""
    from repro.core import evaluators as ref_ev
    from repro.core.mva import workload_demand

    cls, vm = _frontier_cases()[case]
    lo, hi = 1, 8192
    a, b = workload_demand(cls.profile_for(vm))
    want_aoc = np.asarray(jnp.asarray(a / (np.arange(lo, hi + 1) * vm.slots),
                                      jnp.float32))
    got_aoc = amva_ref.frontier_a_over_c(a, vm.slots, lo, hi - lo + 1)
    assert np.array_equal(got_aoc.numpy(), want_aoc)
    want = ref_ev.amva_frontier(cls, vm, lo, hi)
    before = amva_ops.ps_frontier.launches
    got = amva_ops.ps_frontier(a, vm.slots, lo, hi - lo + 1, b, cls.think_ms,
                               float(cls.h_users), device="cpu")
    assert amva_ops.ps_frontier.launches == before      # plain, on the CPU
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_port_amva_frontier_equals_the_reference_on_a_window():
    """``evaluators.amva_frontier`` (one ``ps_frontier`` call) on the port's
    own copy of Q1-10u equals the reference's on a run_fast-sized window
    (97 points) of each VM type."""
    from repro.core import evaluators as ref_ev
    from repro.core import tpcds as ref_tpcds
    from repro_torch.core import evaluators, tpcds

    ref_prob = ref_tpcds.scenario_problem("Q1", 10, 160_000.0)[0]
    prob = tpcds.scenario_problem("Q1", 10, 160_000.0)[0]
    for v_ref, v in zip(ref_prob.vm_types, prob.vm_types):
        want = ref_ev.amva_frontier(ref_prob.classes[0], v_ref, 20, 116)
        got = evaluators.amva_frontier(prob.classes[0], v, 20, 116,
                                       device="cpu")
        assert np.array_equal(got, want), v.name
    assert evaluators.amva_frontier(prob.classes[0], prob.vm_types[0], 5, 4,
                                    device="cpu").shape == (0,)


def test_frontier_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="no amva kernel"):
        amva_ops.ps_frontier(1e6, 8, 1, 4, 10.0, 1e4, 10.0, device="meta")
    with pytest.raises(ValueError, match="n must be"):
        amva_ops.ps_frontier(1e6, 8, 1, -1, 10.0, 1e4, 10.0, device="cpu")
