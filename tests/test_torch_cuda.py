"""The port's CUDA kernels on the card, against their plain versions on
the same inputs.  Marked ``cuda``: on a host without a card every test
skips (the fixture decides, at run time).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import dag, qn_sim, shapes
from repro_torch.core.optimizer import DSpace4Cloud
from repro_torch.core.problem import (ApplicationClass, JobProfile, Problem,
                                      VMType)
from repro_torch.configs.registry import get_smoke_config
from repro_torch.distributed.sharding import init_params, map_tree
from repro_torch.kernels import build
from repro_torch.kernels.amva import ops as amva_ops
from repro_torch.kernels.amva import ref as amva_ref
from repro_torch.kernels.dag_event import ops as dag_ops
from repro_torch.kernels.dag_event import ref as dag_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.qn_event import ops as qn_ops
from repro_torch.kernels.qn_event import ref as qn_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import api
from repro_torch.serve import step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda", 0)


# S = 64 takes the main path's kernel; S = 8192 slots take qn_event_wide
# (its groups of slots in opt-in shared memory)
@pytest.mark.parametrize("replay,S", [(False, 64), (True, 64), (True, 8192)])
def test_qn_event_kernel_bit_identical_to_plain(dev, replay, S):
    _check_qn_mix(dev, replay, S, general=False)


# the kernel for any H and slot count, asked for where the main path's
# kernel would run: the same bits
@pytest.mark.parametrize("replay", [False, True])
def test_qn_event_general_kernel_bit_identical_at_small_lanes(dev, replay):
    _check_qn_mix(dev, replay, 64, general=True)


def _check_qn_mix(dev, replay, S, general):
    g = np.random.default_rng(1)
    E, H = 1024, 6
    caps = [1, 3, S, 17, 1, 40, 8, S]
    nea = [E, E, E, E // 3, 0, 7, E, E]
    B = len(caps)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    lanes = (i32([8, 8, 40, 12, 1, 30, 5, 64]), i32([2, 1, 8, 3, 1, 0, 4, 2]),
             i32(caps), i32(nea), f32(g.uniform(50, 90, B)),
             f32(g.uniform(20, 60, B)), f32(g.uniform(500, 3000, B)))
    seeds = torch.arange(B, device=dev) * 1000
    smp = (f32(g.uniform(30, 90, 100)), f32(g.uniform(20, 50, 33))) \
        if replay else (None, None)
    tables = qn_ops.event_streams(lanes[6], seeds, lanes[3], h_users=H,
                                  n_events=E, m_samples=smp[0],
                                  r_samples=smp[1])
    kw = dict(max_slots=S, warmup_jobs=2, replay=replay)
    before = qn_ops.qn_event.launches, dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*lanes, *tables, general=general, **kw)
    assert qn_ops.qn_event.launches == before[0] + 1
    # the library reports the kernel it ran: the fast one up to 512 slots,
    # the wide one past them
    took = "qn_event_general" if general else \
        "qn_event_fast" if S <= 512 else "qn_event_wide"
    _assert_took(before[1], took)
    ps, pc = qn_ref.qn_event(*lanes, *tables, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    assert kc[4] == 0 and kc.sum() > 0


def _assert_took(before, took):
    """One qn_event launch since ``before`` (a copy of the routes' counts),
    on the route ``took``."""
    assert {k: n - before[k] for k, n in qn_ops.qn_event.routes.items()} \
        == {k: int(k == took) for k in qn_ops.ROUTES}


def _cuda_f32_i32(dev):
    return (lambda x: torch.tensor(x, dtype=torch.float32, device=dev),
            lambda x: torch.tensor(x, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("B", [1, 32])
def test_event_streams_kernel_bit_identical_to_plain(dev, replay, B):
    """The draw-table kernel against the plain version: every table equal
    bit for bit, with per-lane budgets including 0, negative seeds, and
    sample lists whose lengths are not powers of two."""
    f32, i32 = _cuda_f32_i32(dev)
    g = np.random.default_rng(5 + B)
    E, H = 3000, 7
    nea = g.integers(0, 2 * E, B)
    nea[0] = 0
    seeds = torch.tensor(g.integers(-2 ** 31, 2 ** 31, B), dtype=torch.int64,
                         device=dev)
    tm = f32(g.uniform(100, 5000, B))
    smp = (f32(g.uniform(30, 90, 37)), f32(g.uniform(20, 50, 11))) \
        if replay else (None, None)
    kw = dict(h_users=H, n_events=E, m_samples=smp[0], r_samples=smp[1])
    before = qn_ops.event_streams.launches
    got = qn_ops.event_streams(tm, seeds, i32(nea), **kw)
    assert qn_ops.event_streams.launches == before + 1
    want = qn_ref.event_streams(tm, seeds, i32(nea), **kw)
    torch.cuda.synchronize()
    assert [tuple(x.shape) for x in got] == [(B, H)] + [(B, E)] * 3
    for a, b in zip(got, want):
        assert a.device == dev and torch.equal(a, b)


def _qn_lanes(dev, g, caps, E, think):
    f32, i32 = _cuda_f32_i32(dev)
    B = len(caps)
    return (i32(g.integers(1, 30, B)), i32(g.integers(1, 5, B)), i32(caps),
            i32([E] * B), f32(g.uniform(50, 90, B)), f32(g.uniform(20, 60, B)),
            f32(g.uniform(*think, B)))


# more than 2048 users (or 16384 slots) take the kernel for any H and slot
# count; H = 2049 needs more than 48 KB of shared memory a lane, H = 12000
# more than the card's 227 KB (its state then lives in a global scratch
# slice); at most 32 users past 512 slots take qn_event_wide, up to its
# 16384, 33 to 2048 users qn_event_many, and the general kernel asked for
# gives the same bits.  Long thinks let jobs finish within the budget
QN_ANY_CASES = [(2049, 64, "qn_event_general"),
                (2049, 8192, "qn_event_general"),
                (40, 600, "qn_event_many"),
                (12000, 64, "qn_event_general"),
                (20, 8192, "qn_event_wide"), (10, 600, "qn_event_wide"),
                (32, 16384, "qn_event_wide")]


@pytest.mark.parametrize("H,S,took", QN_ANY_CASES)
def test_qn_event_kernel_any_users_and_slots(dev, H, S, took):
    g = np.random.default_rng(H + S)
    f32, _ = _cuda_f32_i32(dev)
    E = 2048
    lanes = _qn_lanes(dev, g, [S, 1, 17], E, (1e5, 2e5))
    seeds = torch.tensor([3, 1003, 2003], dtype=torch.int64, device=dev)
    smp = (f32(g.uniform(30, 90, 37)), f32(g.uniform(20, 50, 11)))
    tables = qn_ops.event_streams(lanes[6], seeds, lanes[3], h_users=H,
                                  n_events=E, m_samples=smp[0],
                                  r_samples=smp[1])
    kw = dict(max_slots=S, warmup_jobs=2, replay=True)
    scratch = build.library().qn_event_scratch_bytes(H, S, E)
    assert (scratch > 0) == (H == 12000)
    before = dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*lanes, *tables, **kw)
    _assert_took(before, took)
    ps, pc = qn_ref.qn_event(*lanes, *tables, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    assert bool((kc > 0).all())
    if took in ("qn_event_wide", "qn_event_many"):
        gs, gc = qn_ops.qn_event(*lanes, *tables, general=True, **kw)
        assert torch.equal(gs, ps) and torch.equal(gc, pc)


# a replay list of one repeated value: every task lasts the same, so slot
# ends tie and the lower index must win, as in the plain version and in
# qn_event_general asked for; caps of 1 and of max_slots (past 512 users on
# a budget of 4096 events: every user's think ends within the first ms, so
# 2048 users spend 2048 events on them before the first task ends)
@pytest.mark.parametrize("H,S,took", [(5, 40, "qn_event_fast"),
                                      (32, 512, "qn_event_fast"),
                                      (40, 600, "qn_event_many"),
                                      (20, 8192, "qn_event_wide"),
                                      (32, 600, "qn_event_wide"),
                                      (64, 64, "qn_event_many"),
                                      (600, 384, "qn_event_many"),
                                      (2048, 384, "qn_event_many")])
def test_qn_event_kernel_exact_ties(dev, H, S, took):
    g = np.random.default_rng(7 + S)
    f32, _ = _cuda_f32_i32(dev)
    E = 2048 if H <= 512 else 4096
    lanes = _qn_lanes(dev, g, [1, S, 17, S - 3], E, (0.0, 1.0))
    seeds = torch.arange(4, device=dev) * 1000
    smp = (f32([40.0]), f32([40.0]))
    tables = qn_ops.event_streams(lanes[6], seeds, lanes[3], h_users=H,
                                  n_events=E, m_samples=smp[0],
                                  r_samples=smp[1])
    kw = dict(max_slots=S, warmup_jobs=2, replay=True)
    before = dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*lanes, *tables, **kw)
    _assert_took(before, took)
    ps, pc = qn_ref.qn_event(*lanes, *tables, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    assert bool((kc > 0).all())
    gs, gc = qn_ops.qn_event(*lanes, *tables, general=True, **kw)
    assert torch.equal(gs, ps) and torch.equal(gc, pc)


# the routes' edges: (H, S, general) -> the kernel the library reports;
# each equal to the plain version bit for bit (past 512 users on a budget
# of 4096 events, so that the single-slot lane's queue of every user's
# tasks drains far enough to finish jobs)
QN_ROUTE_EDGES = [((32, 512, False), "qn_event_fast"),
                  ((32, 513, False), "qn_event_wide"),
                  ((32, 16384, False), "qn_event_wide"),
                  ((32, 16385, False), "qn_event_general"),
                  ((33, 600, False), "qn_event_many"),
                  ((33, 512, False), "qn_event_many"),
                  ((64, 513, False), "qn_event_many"),
                  ((33, 16384, False), "qn_event_many"),
                  ((33, 16385, False), "qn_event_general"),
                  ((512, 64, False), "qn_event_many"),
                  ((513, 64, False), "qn_event_many"),
                  ((2048, 64, False), "qn_event_many"),
                  ((2049, 64, False), "qn_event_general"),
                  ((64, 64, True), "qn_event_general"),
                  ((20, 8192, True), "qn_event_general")]


@pytest.mark.parametrize("shape,took", QN_ROUTE_EDGES)
def test_qn_event_route_edges(dev, shape, took):
    H, S, general = shape
    g = np.random.default_rng(H + S)
    f32, _ = _cuda_f32_i32(dev)
    E = 1024 if H <= 512 else 4096
    lanes = _qn_lanes(dev, g, [S, 1, S - 1], E, (300.0, 900.0))
    seeds = torch.tensor([5, 1005, 2005], dtype=torch.int64, device=dev)
    smp = (f32(g.uniform(30, 90, 37)), f32(g.uniform(20, 50, 11)))
    tables = qn_ops.event_streams(lanes[6], seeds, lanes[3], h_users=H,
                                  n_events=E, m_samples=smp[0],
                                  r_samples=smp[1])
    kw = dict(max_slots=S, warmup_jobs=2, replay=True)
    before = dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*lanes, *tables, general=general, **kw)
    _assert_took(before, took)
    ps, pc = qn_ref.qn_event(*lanes, *tables, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    assert bool((kc > 0).all())


# qn_event_wide on cost_deadline's kind of lane: 20 users and caps from 1
# to 16384 (maps of 500 back the queue up past the small caps; on the large
# ones the busy slots span several threads' blocks), in both modes (replay
# with few distinct samples, so that slot ends tie); the general kernel
# asked for gives the same bits
@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("S", [600, 8192, 16384])
def test_qn_event_wide_kernel_bit_identical_to_plain(dev, replay, S):
    g = np.random.default_rng(S + replay)
    f32, i32 = _cuda_f32_i32(dev)
    E, H = 4096, 20
    caps = [1, 17, 600, S, S // 2, 40]
    B = len(caps)
    lanes = (i32([500, 500, 64, 64, 64, 8]), i32([1, 1, 8, 1, 16, 2]),
             i32(caps), i32([E, E, E, E, E, E // 3]),
             f32(g.uniform(20, 60, B)), f32(g.uniform(10, 30, B)),
             f32(g.uniform(100, 1000, B)))
    seeds = torch.arange(B, device=dev) * 1000 + 1
    smp = (f32(g.integers(1, 4, 29) * 20.0), f32(g.integers(1, 3, 7) * 10.0)) \
        if replay else (None, None)
    tables = qn_ops.event_streams(lanes[6], seeds, lanes[3], h_users=H,
                                  n_events=E, m_samples=smp[0],
                                  r_samples=smp[1])
    kw = dict(max_slots=S, warmup_jobs=1, replay=replay)
    before = dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*lanes, *tables, **kw)
    _assert_took(before, "qn_event_wide")
    gs, gc = qn_ops.qn_event(*lanes, *tables, general=True, **kw)
    ps, pc = qn_ref.qn_event(*lanes, *tables, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    assert torch.equal(gs, ps) and torch.equal(gc, pc)
    assert bool((kc > 0).all())


# qn_event_many at the capacity planner's widths and past them: 33 to 2048
# users, slots in a flat block (64, 384), in groups (5000: cost_deadline's
# cut Q1 probe) and at the route's limit (16384); maps of 8 and 30 on long
# thinks (jobs finish: one user at a time), of 2 and 1 on short thinks
# (every user busy at once, the busy slots spread over many threads'
# blocks); in replay mode few distinct samples, so that ends tie.  Bit for
# bit against the plain version and qn_event_general asked for
@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("S", [64, 384, 5000, 16384])
@pytest.mark.parametrize("H", [33, 64, 256, 2048])
def test_qn_event_many_kernel_bit_identical_to_plain(dev, H, S, replay):
    g = np.random.default_rng(H + S + replay)
    f32, i32 = _cuda_f32_i32(dev)
    E = 1024
    caps = [S, 17, S, max(1, S // 3)]
    B = len(caps)
    lanes = (i32([8, 30, 2, 1]), i32([2, 5, 3, 1]), i32(caps),
             i32([E, E, E, E - 100]), f32(g.uniform(50, 90, B)),
             f32(g.uniform(20, 60, B)), f32([1e5, 1e5, 5.0, 50.0]))
    seeds = torch.arange(B, device=dev) * 1000 + 7
    smp = (f32(g.integers(1, 4, 29) * 20.0), f32(g.integers(1, 3, 7) * 10.0)) \
        if replay else (None, None)
    tables = qn_ops.event_streams(lanes[6], seeds, lanes[3], h_users=H,
                                  n_events=E, m_samples=smp[0],
                                  r_samples=smp[1])
    kw = dict(max_slots=S, warmup_jobs=2, replay=replay)
    before = dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*lanes, *tables, **kw)
    _assert_took(before, "qn_event_many")
    gs, gc = qn_ops.qn_event(*lanes, *tables, general=True, **kw)
    ps, pc = qn_ref.qn_event(*lanes, *tables, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    assert torch.equal(gs, ps) and torch.equal(gc, pc)
    assert bool((kc[:2] > 0).all())


# qn_event_many's queue keys hold 20 bits of arrival rank: a batch of 2**20
# events or more takes qn_event_general (the tables' width decides, not
# the lanes' budgets, kept short here for the plain run)
@pytest.mark.parametrize("E,took", [((1 << 20) - 1, "qn_event_many"),
                                    (1 << 20, "qn_event_general")])
def test_qn_event_many_event_limit(dev, E, took):
    g = np.random.default_rng(E)
    f32, i32 = _cuda_f32_i32(dev)
    lanes = _qn_lanes(dev, g, [64, 5], E, (300.0, 900.0))
    lanes = (*lanes[:3], i32([600, 300]), *lanes[4:])
    seeds = torch.tensor([11, 1011], dtype=torch.int64, device=dev)
    tables = qn_ops.event_streams(lanes[6], seeds, lanes[3], h_users=64,
                                  n_events=E)
    kw = dict(max_slots=64, warmup_jobs=1, replay=False)
    before = dict(qn_ops.qn_event.routes)
    ks, kc = qn_ops.qn_event(*lanes, *tables, **kw)
    _assert_took(before, took)
    ps, pc = qn_ref.qn_event(*lanes, *tables, **kw)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)


def _dag_lanes(dev, g, chains, caps, nea, think):
    """Lanes of the DAG event loop: chains of task counts padded to the
    stage bucket, each lane's caps, budgets and think times."""
    f32, i32 = _cuda_f32_i32(dev)
    B, K = len(chains), shapes.bucket_stages(max(map(len, chains)))
    nt = np.zeros((B, K), np.int32)
    ta = np.zeros((B, K), np.float32)
    for b, c in enumerate(chains):
        nt[b, :len(c)] = c
        ta[b, :len(c)] = g.uniform(20, 90, len(c))
    return (i32(nt), f32(ta), i32([len(c) for c in chains]), i32(caps),
            i32(nea), f32(g.uniform(*think, B)))


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("B", [1, 16])
def test_dag_streams_kernel_bit_identical_to_plain(dev, replay, B):
    """The DAG's draw-table kernel against the plain version: every table
    equal bit for bit, with per-lane budgets including 0, negative seeds
    and a sample count that is not a power of two."""
    f32, i32 = _cuda_f32_i32(dev)
    g = np.random.default_rng(9 + B)
    E, H = 3000, 5
    nea = g.integers(0, 2 * E, B)
    nea[0] = 0
    seeds = torch.tensor(g.integers(-2 ** 31, 2 ** 31, B), dtype=torch.int64,
                         device=dev)
    tm = f32(g.uniform(100, 5000, B))
    kw = dict(h_users=H, n_events=E, n_samples=97 if replay else None)
    before = dag_ops.dag_streams.launches
    got = dag_ops.dag_streams(tm, seeds, i32(nea), **kw)
    assert dag_ops.dag_streams.launches == before + 1
    want = dag_ref.dag_streams(tm, seeds, i32(nea), **kw)
    torch.cuda.synchronize()
    assert got[1].dtype == (torch.int32 if replay else torch.float32)
    for a, b in zip(got, want):
        assert a.device == dev and torch.equal(a, b)


# chains of 1..4 stages in one batch (padded to the stage bucket), a
# padding lane (zero budget), a single-slot lane, a short budget; H = 1, 3
# and 32 at S = 64 and 512 (dag_event_fast's route, and the general one
# asked for), H = 40 (more than one user a thread); S = 8192 slots (opt-in
# shared memory) and H = 12000 (a global scratch slice)
DAG_CARD_CASES = [(1, 64), (3, 64), (32, 512), (40, 600), (3, 8192),
                  (12000, 64)]


def _dag_routes(dev, lanes, tables, smp, H, S, **kw):
    """Both routes where the batch fits the fast one (the general one asked
    for), else the general route alone, each launch counted on the route
    ``ops.route`` names: ``[(route, resp_sum, resp_cnt)]``."""
    K, E = lanes[0].shape[1], tables[1].shape[1]
    out = []
    for general in (False, True):
        took = dag_ops.route(H, S, K, E, general)
        if out and took == out[0][0]:
            break
        before = dict(dag_ops.dag_event.routes)
        s, c = dag_ops.dag_event(*lanes, *tables, smp, max_slots=S,
                                 general=general, **kw)
        after = dag_ops.dag_event.routes
        assert {r: after[r] - before[r] for r in after} == \
            {r: int(r == took) for r in after}
        out.append((took, s, c))
    return out


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("H,S", DAG_CARD_CASES)
def test_dag_event_kernel_bit_identical_to_plain(dev, replay, H, S):
    f32, _ = _cuda_f32_i32(dev)
    g = np.random.default_rng(H + S + replay)
    E = 2048
    chains = [(6, 3)] * 6 if replay else \
        [(6,), (8, 4), (10, 4, 2), (6, 5, 3, 2), (5, 5), (7,)]
    lanes = _dag_lanes(dev, g, chains, [S, 1, 17, S, 3, 40],
                       [E, E, E, 0, E // 3, E], (1e3, 4e3) if H < 100
                       else (5e4, 1e5))
    seeds = torch.arange(6, device=dev) * 1000 + 3
    smp = f32(g.lognormal(np.log(60.0), 0.4, (2, 97))) if replay else None
    tables = dag_ops.dag_streams(lanes[5], seeds, lanes[4], h_users=H,
                                 n_events=E,
                                 n_samples=97 if replay else None)
    scratch = build.library().dag_event_scratch_bytes(H, S)
    assert (scratch > 0) == (H == 12000)
    kw = dict(warmup_jobs=2)
    before = dag_ops.dag_event.launches
    got = _dag_routes(dev, lanes, tables, smp, H, S, **kw)
    assert [r for r, _, _ in got] == (
        ["dag_event_fast", "dag_event_general"] if H <= 32 and S <= 512
        else ["dag_event_general"])
    assert dag_ops.dag_event.launches == before + len(got)
    ps, pc = dag_ref.dag_event(*lanes, *tables, smp, max_slots=S, **kw)
    for took, ks, kc in got:
        assert torch.equal(ks, ps) and torch.equal(kc, pc), took
    assert pc[3] == 0 and bool((pc[[0, 1, 2, 5]] > 0).all())


@pytest.mark.parametrize("H,S", [(3, 6), (32, 64), (32, 512)])
def test_dag_event_routes_break_exact_ties_as_the_plain_version(dev, H, S):
    """Tie-heavy lanes: every sample one repeated value and every think
    clock a whole second, so that arrivals and completions tie and the
    queue key's rank and user fields decide; both routes equal the plain
    version bit for bit."""
    f32, _ = _cuda_f32_i32(dev)
    g = np.random.default_rng(H + S)
    E = 2048
    lanes = _dag_lanes(dev, g, [(6, 3, 2), (4, 4, 4), (9, 1, 5), (2, 8, 3)],
                       [S, 1, 5, S // 2], [E, E, E // 2, E], (1e3, 3e3))
    smp = f32(np.full((3, 7), 40.0, np.float32))
    think0, st, td = dag_ops.dag_streams(
        lanes[5], torch.arange(4, device=dev) + 5, lanes[4], h_users=H,
        n_events=E, n_samples=7)
    tables = (torch.round(think0 / 1e3) * 1e3, st, td)
    kw = dict(warmup_jobs=2)
    got = _dag_routes(dev, lanes, tables, smp, H, S, **kw)
    ps, pc = dag_ref.dag_event(*lanes, *tables, smp, max_slots=S, **kw)
    assert len(got) == 2
    for took, ks, kc in got:
        assert torch.equal(ks, ps) and torch.equal(kc, pc), took
    assert bool((pc > 0).all())


def test_dag_event_fast_route_at_its_limits(dev):
    """dag_event_fast at its limits: 31 stages (K = 31, chains of 1 to 31
    stages) and E = 2**22 - 1 table columns, both routes bit-identical to
    the plain version over a 4096-event budget; then one lane run through
    all 2**22 - 1 events (some 2**21 distinct clocks: its arrival ranks
    fill the top bits of their field) on both routes, equal to each other;
    and the C launcher refuses a fast launch one past each limit."""
    f32, i32 = _cuda_f32_i32(dev)
    g = np.random.default_rng(5)
    K, E, H, S = 31, (1 << 22) - 1, 32, 512
    chains = [tuple(g.integers(1, 3, n)) for n in (31, 1, 17, 30)]
    nt = np.zeros((4, K), np.int32)
    ta = np.zeros((4, K), np.float32)
    for b, c in enumerate(chains):
        nt[b, :len(c)] = c
        ta[b, :len(c)] = g.uniform(20, 90, len(c))
    lanes = (i32(nt), f32(ta), i32([len(c) for c in chains]),
             i32([S, 7, 64, 1]), i32([4096] * 4), f32([500.0] * 4))
    seeds = torch.arange(4, device=dev) + 11
    tables = dag_ops.dag_streams(lanes[5], seeds, lanes[4], h_users=H,
                                 n_events=E)
    kw = dict(warmup_jobs=2)
    got = _dag_routes(dev, lanes, tables, None, H, S, **kw)
    assert [r for r, _, _ in got] == ["dag_event_fast", "dag_event_general"]
    ps, pc = dag_ref.dag_event(*lanes, *tables, None, max_slots=S, **kw)
    for took, ks, kc in got:
        assert torch.equal(ks, ps) and torch.equal(kc, pc), took
    assert bool((pc > 0).all())
    # one lane through every event: the two routes agree
    one = tuple(x[:1] for x in lanes[:4]) + (i32([E]), lanes[5][:1])
    t1 = tuple(x[:1] for x in tables)
    (_, fs, fc), (_, gs, gc) = _dag_routes(dev, one, t1, None, H, S, **kw)
    assert torch.equal(fs, gs) and torch.equal(fc, gc) and fc[0] > 1000
    # the launcher refuses a fast launch past any limit
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for h, s_, k, e in ((33, S, K, 64), (H, S + 1, K, 64), (H, S, K + 1, 64),
                        (H, S, K, 1 << 22)):
        assert dag_ops.route(h, s_, k, e) == "dag_event_general"
        rc = lib.dag_event_launch(*([None] * 13), 1, k, h, s_, e, 0, 0, 0,
                                  0, 1, stream)
        assert rc != 0, (h, s_, k, e)


def test_dag_event_kernel_clamps_short_sample_lists(dev):
    """Replay lists with fewer rows than the lanes' stages: the kernel reads
    the last row for a deeper stage, as the plain version and the
    reference's gather do."""
    f32, _ = _cuda_f32_i32(dev)
    g = np.random.default_rng(31)
    E = 2048
    lanes = _dag_lanes(dev, g, [(6, 3, 2)] * 4, [64, 1, 17, 5],
                       [E, E, E // 3, E], (1e3, 4e3))
    smp = f32(g.lognormal(np.log(60.0), 0.4, (1, 97)))
    tables = dag_ops.dag_streams(lanes[5], torch.arange(4, device=dev) + 7,
                                 lanes[4], h_users=3, n_events=E,
                                 n_samples=97)
    kw = dict(warmup_jobs=2)
    got = _dag_routes(dev, lanes, tables, smp, 3, 64, **kw)
    ps, pc = dag_ref.dag_event(*lanes, *tables, smp, max_slots=64, **kw)
    assert len(got) == 2
    for took, ks, kc in got:
        assert torch.equal(ks, ps) and torch.equal(kc, pc), took
    assert bool((pc > 0).all())


@pytest.mark.parametrize("replay", [False, True])
def test_dag_scalar_equals_batched_and_the_cpu_on_the_card(dev, replay):
    """``dag_response_time`` (one launch of each kernel a replication) and
    ``response_time_batch`` (one of each) on the card: scalar equals
    batched, and both equal the CPU's plain path bit for bit in replay
    mode, within a relative 1e-3 otherwise."""
    job = dag.DagJob("d", (dag.Stage(8, 900.0), dag.Stage(4, 500.0),
                           dag.Stage(2, 1200.0)))
    smp = dag.dag_replayer_lists(job, seed=3) if replay else None
    kw = dict(think_ms=6000.0, h_users=3, min_jobs=6, warmup_jobs=3,
              seed=5, replications=2, samples=smp)
    slots = [2, 5, 9]
    before = dag_ops.dag_event.launches, dag_ops.dag_streams.launches
    scalar = [dag.dag_response_time(job, slots=s, device=dev, **kw)
              for s in slots]
    batched = dag.response_time_batch([job] * 3, slots=slots, device=dev,
                                      **kw)
    assert (dag_ops.dag_event.launches - before[0],
            dag_ops.dag_streams.launches - before[1]) == (7, 7)
    assert np.array_equal(np.asarray(scalar), batched)
    cpu = dag.response_time_batch([job] * 3, slots=slots, device="cpu", **kw)
    if replay:
        assert np.array_equal(batched, cpu)
    else:
        assert np.allclose(batched, cpu, rtol=1e-3, atol=0)


@pytest.mark.parametrize("n", [1, 97, 128, 4097])
def test_amva_kernel_bit_identical_to_plain(dev, n):
    g = np.random.default_rng(n)
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (
        np.abs(g.normal(size=n)) * 1e4, np.abs(g.normal(size=n)) * 1e3,
        np.full(n, 1e4), np.round(np.abs(g.normal(size=n)) * 10 + 1))]
    assert torch.equal(amva_ops.ps_fixed_point(*args),
                       amva_ref.ps_fixed_point(*args))


# the reference's grid (tests/test_kernels.py), larger sizes and H = 200;
# H = 0 returns the demand
@pytest.mark.parametrize("n", [1, 5, 300, 1024, 4097])
@pytest.mark.parametrize("h_users", [0, 1, 4, 25, 200])
def test_mva_kernel_bit_identical_to_plain(dev, n, h_users):
    g = np.random.default_rng(n + h_users)
    d = torch.tensor(np.abs(g.normal(size=n)) * 10 + 1, dtype=torch.float32,
                     device=dev)
    z = torch.full((n,), 1e4, dtype=torch.float32, device=dev)
    before = amva_ops.mva_response.launches
    out = amva_ops.mva_response(d, z, h_users)
    assert amva_ops.mva_response.launches == before + 1
    assert torch.equal(out, amva_ref.mva_response(d, z, h_users))
    if h_users == 0:
        assert torch.equal(out, d)


# (B, E, H, n_samples in replay mode): E ragged against the 4-event runs
# and B*E + B*H odd; one event; H = 2049 users; more lanes than a block's
# tile of runs holds; one sample
DAG_STREAMS_EDGES = [(3, 4097, 5, 97), (1, 1, 1, 1), (2, 3, 2049, 5),
                     (300, 2, 1, 3), (16, 8192, 3, 1)]


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("B,E,H,NS", DAG_STREAMS_EDGES)
def test_dag_streams_kernel_edge_shapes(dev, replay, B, E, H, NS):
    """The draw-table kernel at its edges, torch.equal to the plain
    version: ragged runs, budgets of 0, H = 2049, a tile of many lanes,
    replay lists of one sample, and seeds outside int32 (taken modulo
    2**32; the plain version gets the same words as int32 seeds).  The
    three tables are views of one allocation."""
    f32, i32 = _cuda_f32_i32(dev)
    g = np.random.default_rng(B + E + H)
    nea = g.integers(0, 2 * E + 1, B)
    nea[0] = 0
    seeds = g.integers(-2 ** 40, 2 ** 40, B)
    seeds[-1] = 2 ** 33 + 7
    words = (seeds % 2 ** 32 + 2 ** 31) % 2 ** 32 - 2 ** 31   # as int32
    tm = f32(g.uniform(100, 5000, B))
    kw = dict(h_users=H, n_events=E, n_samples=NS if replay else None)
    before = dag_ops.dag_streams.launches
    got = dag_ops.dag_streams(tm, torch.tensor(seeds, device=dev), i32(nea),
                              **kw)
    assert dag_ops.dag_streams.launches == before + 1
    want = dag_ref.dag_streams(tm, torch.tensor(words, device=dev), i32(nea),
                               **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ptr = got[1].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == ptr for x in got)


def _deep_lanes(dev, g, n_stages):
    """Four 4-stage lanes over K = 4 stage arrays, their n_stages set to
    ``n_stages`` (past 4, deeper than the arrays: each gather clamps the
    stage index to its array's rows)."""
    lanes = _dag_lanes(dev, g, [(6, 3, 2, 2)] * 4, [64, 7, 17, 3],
                       [2048, 2048, 2048, 1000], (1e3, 4e3))
    _, i32 = _cuda_f32_i32(dev)
    return lanes[:2] + (i32(n_stages),) + lanes[3:]


@pytest.mark.parametrize("replay", [False, True])
def test_sim_batch_one_entry_equals_the_two_wrappers(dev, replay):
    """``sim_batch`` on the card (one C entry point for the tables and the
    event loop, one stream, one allocation) gives the bits of
    ``dag_streams`` then ``dag_event`` and of the plain versions, and
    counts one launch of each kernel on the route ``route`` names."""
    f32, _ = _cuda_f32_i32(dev)
    g = np.random.default_rng(41 + replay)
    lanes = _deep_lanes(dev, g, [3, 3, 2, 1])
    seeds = torch.arange(4, device=dev, dtype=torch.int64) * 77 - 100
    smp = f32(g.lognormal(np.log(60.0), 0.4, (3, 97))) if replay else None
    kw = dict(h_users=3, max_slots=64, n_events=2048, warmup_jobs=2)
    n_ev, tm = lanes[4], lanes[5]
    before = (dag_ops.dag_streams.launches, dag_ops.dag_event.launches,
              dict(dag_ops.dag_event.routes))
    mean, cnt = dag_ops.sim_batch(lanes[0], lanes[1], lanes[2], tm,
                                  lanes[3], seeds, n_ev, smp, depth=3, **kw)
    assert (dag_ops.dag_streams.launches - before[0],
            dag_ops.dag_event.launches - before[1]) == (1, 1)
    assert dag_ops.dag_event.routes["dag_event_fast"] == \
        before[2]["dag_event_fast"] + 1
    ns = None if smp is None else 97
    tables = dag_ops.dag_streams(tm, seeds, n_ev, h_users=3, n_events=2048,
                                 n_samples=ns)
    s, c = dag_ops.dag_event(*lanes, *tables, smp, max_slots=64,
                             warmup_jobs=2)
    ps, pc = dag_ref.dag_event(*lanes, *dag_ref.dag_streams(
        tm, seeds, n_ev, h_users=3, n_events=2048, n_samples=ns), smp,
        max_slots=64, warmup_jobs=2)
    assert torch.equal(cnt, c) and torch.equal(c, pc)
    assert torch.equal(mean, s / torch.clamp(c, min=1.0))
    assert torch.equal(s, ps) and bool((pc > 0).all())


@pytest.mark.parametrize("replay", [False, True])
def test_dag_lane_deeper_than_the_fast_route_gives_the_plain_bits(dev,
                                                                  replay):
    """A lane of n_stages 40 and one of 5 over K = 4 stage arrays (replay
    lists of 6 rows: a deep stage's row passes the arrays' width): the
    route is the general one, whether the depth comes from the host or is
    read from the lanes, and dag_event and sim_batch give the plain
    version's finite result; the combined C entry point refuses the fast
    route for such a batch."""
    f32, _ = _cuda_f32_i32(dev)
    g = np.random.default_rng(43 + replay)
    lanes = _deep_lanes(dev, g, [40, 4, 5, 2])
    seeds = torch.arange(4, device=dev, dtype=torch.int64) + 5
    smp = f32(g.lognormal(np.log(60.0), 0.4, (6, 97))) if replay else None
    ns = None if smp is None else 97
    tables = dag_ops.dag_streams(lanes[5], seeds, lanes[4], h_users=3,
                                 n_events=2048, n_samples=ns)
    ps, pc = dag_ref.dag_event(*lanes, *tables, smp, max_slots=64,
                               warmup_jobs=2)
    assert bool(torch.isfinite(ps).all()) and bool((pc[1:] > 0).all())
    assert dag_ops.route(3, 64, 4, 2048, depth=5) == "dag_event_general"
    for depth in (40, None):
        before = dict(dag_ops.dag_event.routes)
        s, c = dag_ops.dag_event(*lanes, *tables, smp, max_slots=64,
                                 warmup_jobs=2, depth=depth)
        assert dag_ops.dag_event.routes["dag_event_general"] == \
            before["dag_event_general"] + 1
        assert torch.equal(s, ps) and torch.equal(c, pc)
        mean, cnt = dag_ops.sim_batch(
            lanes[0], lanes[1], lanes[2], lanes[5], lanes[3], seeds,
            lanes[4], smp, h_users=3, max_slots=64, n_events=2048,
            warmup_jobs=2, depth=depth)
        assert torch.equal(cnt, pc)
        assert torch.equal(mean, ps / torch.clamp(pc, min=1.0))
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for depth in (5, 40):
        rc = lib.dag_sim_launch(*([None] * 11), 4, 4, 3, 64, 2048, 0, 0, 2,
                                0, 1, depth, stream)
        assert rc != 0


@pytest.mark.parametrize("n,slots", [(1, 8), (97, 8), (97, 20), (8192, 20)])
def test_amva_frontier_entry_equals_ps_fixed_point(dev, n, slots):
    """The frontier entry (the scalars by value, a_over_c divided in
    float64 on the card) against ``ps_fixed_point`` on tensors built on
    the host as ``amva_frontier`` built them before, and against the
    plain version: bit for bit."""
    a, b, think, h = 5488087.17967804, 38792.787047447186, 10000.0, 10.0
    nus = np.arange(20, 20 + n)
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (
        a / (nus * slots), np.full(n, b), np.full(n, think), np.full(n, h))]
    before = amva_ops.ps_frontier.launches
    got = amva_ops.ps_frontier(a, slots, 20, n, b, think, h, device=dev)
    assert amva_ops.ps_frontier.launches == before + 1
    assert torch.equal(got, amva_ops.ps_fixed_point(*args))
    assert torch.equal(got.cpu(), amva_ref.ps_frontier(a, slots, 20, n, b,
                                                       think, h))


def test_amva_division_without_its_range_check_keeps_ieee_bits(dev):
    """One round at a = 1, b = 0 returns max(1, h / (1 + z)): the round's
    quotient itself, over 2**22 random pairs across the fast path's range
    (random mantissas, divisors 1 + z from about 2^-20 to 2^58, dividends
    up to 2^40 times larger, some past 2^60) and outside it
    (denormals, zero, huge, infinite and NaN operands, which take the
    rounds again with __fdiv_rn): the kernel equals the plain version on
    the CPU bit for bit, NaN where it gives NaN."""
    g = np.random.default_rng(17)
    n = 1 << 22
    y = np.ldexp(g.uniform(1, 2, n), g.integers(-20, 58, n)) \
        .astype(np.float32)
    x = (y * np.ldexp(g.uniform(1, 2, n), g.integers(0, 40, n))
         ).astype(np.float32)
    z = (y.astype(np.float64) - 1.0).astype(np.float32)
    odd = g.choice(n, 4096, replace=False)
    x[odd[:1024]] = np.float32(1e-40)
    z[odd[1024:2048]] = np.float32(3e38)
    x[odd[2048:3072]] = g.choice(np.array([0.0, np.inf, np.nan, 3e38],
                                          np.float32), 1024)
    x[odd[3072:]] = np.float32(1e-39) * g.uniform(1, 2, 1024) \
        .astype(np.float32)
    cpu = [torch.tensor(v) for v in (np.ones(n, np.float32),
                                     np.zeros(n, np.float32), z, x)]
    exact = dict(rtol=0, atol=0, equal_nan=True)
    got = amva_ops.ps_fixed_point(*(v.to(dev) for v in cpu), iters=1)
    want = amva_ref.ps_fixed_point(*cpu, iters=1)
    torch.testing.assert_close(got.cpu(), want, **exact)
    assert int(want.isnan().sum()) > 0 and int((want > 1).sum()) > n // 2
    full = amva_ops.ps_fixed_point(*(v.to(dev) for v in cpu))
    torch.testing.assert_close(full.cpu(), amva_ref.ps_fixed_point(*cpu),
                               **exact)


def test_launch_floor_kernel_launches(dev):
    lib = build.library()
    assert build.launch(dev, lib.launch_floor_launch) == 0
    torch.cuda.synchronize()


def _two_class_problem():
    """Two classes (so the point-wise walk runs them in two threads) on
    two VM types, task counts small enough for the plain versions."""
    vms = [VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                  containers_per_core=2),
           VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90,
                  speed=1.35)]
    profs = [JobProfile(n_map=8, n_reduce=2, m_avg=3000, m_max=7000,
                        r_avg=1500, r_max=3500),
             JobProfile(n_map=12, n_reduce=3, m_avg=9000, m_max=14000,
                        r_avg=6000, r_max=9000)]
    return Problem(classes=[ApplicationClass(
        name=f"c{i}", h_users=4 + 4 * i, think_ms=2_000 + 3_000 * i,
        deadline_ms=20_000 + 10_000 * i, eta=0.3,
        profiles={"m4.xlarge": p, "c20.node": p.scaled(1.35)})
        for i, p in enumerate(profs)], vm_types=vms)


def _two_class_samples(prob):
    g = np.random.default_rng(3)
    return {(c.name, vm.name): (
        g.lognormal(8.0, 0.4, 128).astype(np.float32),
        g.lognormal(7.3, 0.4, 64).astype(np.float32))
        for c in prob.classes for vm in prob.vm_types}


def _pointwise_card_and_cpu(prob, samples):
    """The point-wise walk with its two classes in two worker threads, on
    the card and on the CPU; every probe's replication is one
    ``qn_event`` launch on the card, none lost to the threads."""
    before = qn_ops.qn_event.launches
    card = DSpace4Cloud(prob, samples=samples, batched=False,
                        min_jobs=6).run(parallel=True)
    assert qn_ops.qn_event.launches - before == card.qn_dispatches > 0
    cpu = DSpace4Cloud(prob, samples=samples, batched=False, min_jobs=6,
                       device="cpu").run(parallel=True)
    for name, sol in cpu.solutions.items():
        got = card.solutions[name]
        assert (got.vm_type, got.nu, got.reserved, got.spot) == \
            (sol.vm_type, sol.nu, sol.reserved, sol.spot)
    assert card.qn_dispatches == cpu.qn_dispatches
    return card, cpu


def test_pointwise_plan_on_the_card_matches_the_cpu(dev):
    """Exponential mode: the card's decisions are the CPU's, and its
    response times agree within the relative 1e-3 that the exponential
    draws' last-ulp differences leave (``test_torch_slice.py``)."""
    card, cpu = _pointwise_card_and_cpu(_two_class_problem(), None)
    for name, sol in cpu.solutions.items():
        assert card.solutions[name].predicted_ms == \
            pytest.approx(sol.predicted_ms, rel=1e-3)


def test_pointwise_replay_plan_on_the_card_equals_the_cpu(dev):
    """Replay mode draws no logarithm: the card's response times are the
    CPU's bit for bit."""
    prob = _two_class_problem()
    card, cpu = _pointwise_card_and_cpu(prob, _two_class_samples(prob))
    for name, sol in cpu.solutions.items():
        assert card.solutions[name].predicted_ms == sol.predicted_ms


@pytest.mark.parametrize("replay", [False, True])
def test_scalar_probe_equals_its_batched_lane_on_the_card(dev, replay):
    """A scalar probe (one single-lane launch per replication) equals the
    same candidate's lane of one batched launch exactly, on the card."""
    g = np.random.default_rng(4)
    ms, rs = (g.lognormal(np.log(700), 0.5, 96).astype(np.float32),
              g.lognormal(np.log(250), 0.5, 40).astype(np.float32)) \
        if replay else (None, None)
    kw = dict(n_map=6, n_reduce=2, m_avg=1200.0, r_avg=500.0,
              think_ms=9000.0, h_users=3, min_jobs=4, warmup_jobs=4,
              seed=11, replications=2, m_samples=ms, r_samples=rs,
              device=dev)
    slots = [2, 3, 5]
    before = qn_ops.qn_event.launches
    scalar = [qn_sim.response_time(slots=s, **kw) for s in slots]
    assert qn_ops.qn_event.launches - before == 2 * len(slots)
    batched = qn_sim.response_time_batch(slots=np.asarray(slots), **kw)
    assert np.array_equal(np.asarray(scalar), batched)


def test_planner_on_the_card_matches_the_plain_path(dev):
    prof = JobProfile(n_map=8, n_reduce=2, m_avg=3000, m_max=7000,
                      r_avg=1500, r_max=3500)
    vms = [VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                  containers_per_core=2),
           VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90,
                  speed=1.35)]
    prob = Problem(classes=[ApplicationClass(
        name="c", h_users=8, think_ms=2_000, deadline_ms=9_000,
        profiles={"m4.xlarge": prof, "c20.node": prof.scaled(1.35)})],
        vm_types=vms)
    g = np.random.default_rng(2)
    samples = {("c", vm.name): (g.lognormal(8.0, 0.4, 128).astype(np.float32),
                                g.lognormal(7.3, 0.4, 64).astype(np.float32))
               for vm in vms}
    card = DSpace4Cloud(prob, samples=samples, min_jobs=6).run_fast()
    cpu = DSpace4Cloud(prob, samples=samples, min_jobs=6,
                       device="cpu").run_fast()
    for name, sol in cpu.solutions.items():
        got = card.solutions[name]
        assert (got.vm_type, got.nu, got.reserved, got.spot) == \
            (sol.vm_type, sol.nu, sol.reserved, sol.spot)
    assert card.qn_dispatches == cpu.qn_dispatches


# B, S, H, KV, Dh, causal, window: every head dim of the repo's configs
# (16 ... 192) and the largest the kernel takes, ragged S, GQA, windows
FA_CARD_CASES = [
    (2, 128, 4, 2, 16, True, 0), (1, 77, 4, 4, 32, True, 0),
    (2, 200, 8, 2, 64, True, 0), (1, 300, 4, 4, 80, True, 64),
    (1, 129, 6, 3, 96, False, 0), (1, 64, 2, 1, 112, True, 0),
    (1, 257, 4, 2, 128, True, 100), (1, 95, 2, 2, 192, False, 17),
    (1, 100, 2, 1, 256, True, 0), (3, 1, 4, 2, 64, True, 0),
    (2, 256, 32, 32, 112, True, 0),     # zamba2-7b's shared attention
]


@pytest.mark.parametrize("case", FA_CARD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, case, dtype):
    B, S, H, KV, Dh, causal, window = case
    g = torch.Generator(device=dev).manual_seed(S * H + Dh)
    q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=dev
                           ).to(dtype) for n in (H, KV, KV))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    want = fa_ref.flash_attention(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2   # the reference's
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


# bfloat16 edge cases of the wgmma kernel (B, S, H, KV, Dh, causal,
# window): head dims 8 ... 256 (TMA zero-fills the columns past Dh), S
# around the 64-row warpgroup and 128-row block edges and a ragged 777,
# GQA groups 1, 4 and 8, windows 0, 1, 64 and 1024
FA_EDGE_CASES = [
    (2, 200, 4, 4, 8, True, 0), (2, 200, 8, 2, 16, True, 0),
    (2, 300, 4, 1, 80, True, 64), (2, 256, 8, 8, 112, False, 0),
    (1, 300, 8, 2, 128, True, 1), (1, 300, 8, 1, 256, True, 0),
    (3, 1, 4, 1, 64, True, 0), (2, 63, 8, 1, 64, True, 0),
    (2, 65, 4, 4, 64, False, 0), (1, 127, 4, 1, 128, True, 64),
    (1, 129, 8, 2, 64, True, 0), (2, 777, 8, 2, 64, True, 0),
    (1, 2048, 8, 2, 128, True, 1024), (1, 777, 8, 1, 112, False, 1024),
    (1, 65, 8, 8, 256, False, 1),
]


@pytest.mark.parametrize("case", FA_EDGE_CASES)
def test_flash_attention_wgmma_kernel_edge_shapes(dev, case):
    B, S, H, KV, Dh, causal, window = case
    g = torch.Generator(device=dev).manual_seed(S * H + Dh + window)
    q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=dev
                           ).to(torch.bfloat16) for n in (H, KV, KV))
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    want = fa_ref.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _fused_qkv(dev, B, S, H, KV, Dh):
    """q, k and v as views into one fused projection (no copies)."""
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((B, S, H + 2 * KV, Dh), generator=g, device=dev,
                      dtype=torch.bfloat16)
    return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]


def _heads_first(dev, B, S, H, KV, Dh):
    """(B, n, S, Dh) tensors seen as (B, S, n, Dh): the head stride
    exceeds the position stride."""
    g = torch.Generator(device=dev).manual_seed(1)
    return tuple(torch.randn((B, n, S, Dh), generator=g, device=dev,
                             dtype=torch.bfloat16).transpose(1, 2)
                 for n in (H, KV, KV))


def test_flash_attention_kernel_reads_strided_inputs(dev):
    """q, k and v as views into one fused projection (no copies)."""
    q, k, v = _fused_qkv(dev, 2, 150, 8, 2, 64)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    want = fa_ref.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("make,shape", [
    (_fused_qkv, (1, 300, 32, 32, 112)), (_heads_first, (2, 150, 8, 2, 64)),
    (_heads_first, (1, 129, 4, 1, 256))])
def test_flash_attention_kernel_reads_non_contiguous_heads(dev, make, shape):
    q, k, v = make(dev, *shape)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, window=64)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    want = fa_ref.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=64)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_kernel_raises_on_bad_input(dev):
    q = torch.zeros((1, 8, 4, 12), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q, q)


def _misaligned(dev):
    """A view one element (2 bytes) past an aligned base."""
    buf = torch.zeros(8 * 2 * 64 + 8, device=dev, dtype=torch.bfloat16)
    return buf[1:1 + 8 * 2 * 64].view(1, 8, 2, 64)


def _odd_head_stride(dev):
    """Heads 68 elements (136 bytes) apart: not a multiple of 16 bytes."""
    return torch.zeros((1, 8, 2, 68), device=dev,
                       dtype=torch.bfloat16)[..., :64]


@pytest.mark.parametrize("make,match", [(_misaligned, "16-byte-aligned"),
                                        (_odd_head_stride, "multiples of 16")])
def test_flash_attention_kernel_raises_where_tma_cannot_read(dev, make,
                                                             match):
    q = make(dev)
    before = fa_ops.flash_attention.launches
    with pytest.raises(ValueError, match=match):
        fa_ops.flash_attention(q, q, q)
    assert fa_ops.flash_attention.launches == before


# float32 edge cases of the wgmma route (fa_fwd_split, then
# fa_fwd_parts_kernel; B, S, H, KV, Dh, causal, window): head dims 8 ...
# 128 (DP 64 and 128; 72 pads to 128), S around the 64-row warpgroup,
# the 128-row block and the 64- and 32-key tiles, ragged 777; GQA groups
# 1, 4 and 8; windows 1, 64 and 1024; non-causal
FA_F32_EDGE_CASES = [
    (3, 1, 4, 1, 64, True, 0), (2, 63, 8, 1, 64, True, 0),
    (2, 65, 4, 4, 64, False, 0), (1, 127, 4, 1, 128, True, 64),
    (1, 129, 8, 2, 64, True, 0), (2, 777, 8, 2, 64, True, 0),
    (2, 200, 4, 4, 8, True, 0), (2, 200, 8, 2, 16, True, 0),
    (2, 300, 4, 1, 72, True, 64), (1, 300, 8, 2, 128, True, 1),
    (1, 2048, 8, 2, 128, True, 1024), (1, 777, 8, 1, 112, False, 1024),
    (2, 256, 32, 8, 64, True, 0),       # granite-3-2b's heads
]


@pytest.mark.parametrize("case", FA_F32_EDGE_CASES)
def test_flash_attention_float32_wgmma_route_edge_shapes(dev, case):
    """The float32 wgmma route against the plain version within the
    reference's 2e-5, lse within 2e-5 too; one launch of the split and of
    fa_fwd_parts_kernel, none of fa_f32_kernel; a second call the same
    bits."""
    B, S, H, KV, Dh, causal, window = case
    g = torch.Generator(device=dev).manual_seed(S * H + Dh + window)
    q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=dev)
               for n in (H, KV, KV))
    assert fa_ops.fwd_route(q) == "wgmma"
    routes = dict(fa_ops.flash_attention.routes)
    split = fa_ops.fa_fwd_split.launches
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    assert fa_ops.fa_fwd_split.launches == split + 1
    assert {r: n - routes[r] for r, n in fa_ops.flash_attention.routes.items()
            } == {"fa_wgmma_kernel": 0, "fa_fwd_parts_kernel": 1,
                  "fa_f32_kernel": 0}
    want, want_lse = fa_ref.flash_attention_fwd(q, k, v, causal=causal,
                                                window=window)
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    again, lse2 = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window)
    assert torch.equal(again, out) and torch.equal(lse2, lse)


def _f32_views(dev, layout, B, S, H, KV, Dh):
    """float32 q, k, v as views no TMA map could take: slices of one
    fused projection, (B, n, S, Dh) tensors seen as (B, S, n, Dh), a q
    whose base is 4 bytes off 16, or heads 66 elements (264 bytes)
    apart."""
    g = torch.Generator(device=dev).manual_seed(2)
    if layout == "fused":
        qkv = torch.randn((B, S, H + 2 * KV, Dh), generator=g, device=dev)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    if layout == "heads_first":
        return tuple(torch.randn((B, n, S, Dh), generator=g, device=dev
                                 ).transpose(1, 2) for n in (H, KV, KV))
    if layout == "odd_base":
        buf = torch.randn(B * S * H * Dh + 1, generator=g, device=dev)
        k, v = (torch.randn((B, S, KV, Dh), generator=g, device=dev)
                for _ in range(2))
        return buf[1:].view(B, S, H, Dh), k, v
    return tuple(torch.randn((B, S, n, Dh + 2), generator=g, device=dev
                             )[..., :Dh] for n in (H, KV, KV))


@pytest.mark.parametrize("layout,shape", [
    ("fused", (1, 300, 32, 8, 64)), ("heads_first", (2, 150, 8, 2, 64)),
    ("heads_first", (1, 129, 4, 1, 128)), ("odd_base", (2, 100, 4, 2, 64)),
    ("odd_head_stride", (2, 100, 4, 2, 64))])
def test_flash_attention_float32_route_reads_any_strides(dev, layout, shape):
    """float32 views TMA could not read go through the split, which reads
    the strides: the parts equal the plain split of the same values bit
    for bit, and both routes agree with plain."""
    q, k, v = _f32_views(dev, layout, *shape)
    parts = fa_ops.fa_fwd_split(q, k, v)
    for got, x in zip(parts, (q, k, v)):
        assert torch.equal(got, fa_ref.split_parts(x.contiguous()))
    want = fa_ref.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=64)
    for entry in (fa_ops.flash_attention, fa_ops.flash_attention_simt):
        out = entry(q, k, v, window=64)
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


def test_flash_attention_float32_routes_by_head_dim(dev):
    """Past head dim 128 float32 takes fa_f32_kernel; at 128 the wgmma
    route; flash_attention_simt runs fa_f32_kernel at any float32 head
    dim; neither bfloat16 nor a head dim past 128 has the other route."""
    g = torch.Generator(device=dev).manual_seed(5)
    for Dh, kernel in ((136, "fa_f32_kernel"), (128, "fa_fwd_parts_kernel")):
        q = torch.randn((1, 70, 4, Dh), generator=g, device=dev)
        before = dict(fa_ops.flash_attention.routes)
        fa_ops.flash_attention(q, q, q)
        assert fa_ops.flash_attention.routes[kernel] == before[kernel] + 1
    q = torch.randn((1, 70, 4, 64), generator=g, device=dev)
    before = fa_ops.flash_attention.routes["fa_f32_kernel"]
    fa_ops.flash_attention_simt(q, q, q)
    assert fa_ops.flash_attention.routes["fa_f32_kernel"] == before + 1
    with pytest.raises(ValueError, match="no simt forward"):
        fa_ops.flash_attention_simt(q.bfloat16(), q.bfloat16(), q.bfloat16())
    wide = torch.randn((1, 70, 4, 192), generator=g, device=dev)
    with pytest.raises(ValueError, match="at most 128"):
        fa_ops.fa_fwd_parts(wide, wide, fa_ops.fa_fwd_split(q, q, q), True,
                            0, False)


def test_float32_wgmma_launchers_refuse_what_they_cannot_run(dev):
    """The C launchers of the float32 wgmma route refuse a head dim past
    128 (and one not a multiple of 8) with cudaErrorInvalidValue, without
    a launch."""
    lib = build.library()
    p = torch.zeros(1 << 16, device=dev).data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    for Dh in (136, 12):
        shape = (1, 64, 2, 2, Dh)
        strides = (64 * 2 * Dh, 2 * Dh, Dh) * 3
        assert lib.fa_fwd_split_launch(*[p] * 6, *shape, *strides,
                                       stream) == 1
        assert lib.fa_fwd_parts_launch(*[p] * 5, *shape, *strides[:3], 1, 0,
                                       stream) == 1


# B, S, H, P, N, chunk: the reference's SSD_CASES (tests/test_kernels.py),
# the smoke configs' shape, zamba2's (N=64) and mamba2's (N=128) at full
# width, the largest the kernel takes, and S < chunk (the clamp)
SSD_CARD_CASES = [
    (2, 64, 3, 16, 16, 16), (1, 128, 4, 32, 64, 32),
    (1, 96, 2, 64, 128, 32), (2, 64, 5, 16, 32, 64),
    (2, 48, 8, 16, 16, 16), (2, 256, 112, 64, 64, 128),
    (1, 384, 48, 64, 128, 128), (1, 256, 3, 128, 128, 128),
    (3, 40, 4, 64, 128, 128),
]
SSD_DTYPES = {  # x, dt, B/C: all f32, all bf16, and the serving path's mix
    "float32": (torch.float32,) * 3, "bfloat16": (torch.bfloat16,) * 3,
    "serving": (torch.bfloat16, torch.float32, torch.bfloat16)}


def _ssd_inputs(dev, B, S, H, P, N, types, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    tx, tdt, tbc = types
    return (rnd(B, S, H, P).to(tx),
            torch.nn.functional.softplus(rnd(B, S, H)).to(tdt),
            -torch.exp(rnd(H) * 0.3), rnd(B, S, N).to(tbc),
            rnd(B, S, N).to(tbc))


def _ssd_check(args, chunk, route):
    """One launch, on ``route``, against the plain version at the
    reference's tolerance (1e-4 when x is float32, else 5e-2)."""
    before = ssd_ops.ssd.launches, dict(ssd_ops.ssd.routes)
    y, state = ssd_ops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before[0] + 1
    assert {r: n - before[1][r] for r, n in ssd_ops.ssd.routes.items()} == \
        {r: int(r == route) for r in ssd_ops.ssd.routes}
    want_y, want_state = ssd_ref.ssd(*args, chunk=chunk)
    tol = 1e-4 if args[0].dtype == torch.float32 else 5e-2
    assert y.dtype == args[0].dtype and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SSD_CARD_CASES)
@pytest.mark.parametrize("types", list(SSD_DTYPES))
def test_ssd_kernel_matches_plain(dev, case, types):
    """x, B and C in bfloat16 take the wgmma route, float32 the parts
    route."""
    B, S, H, P, N, chunk = case
    args = _ssd_inputs(dev, B, S, H, P, N, SSD_DTYPES[types], S + H + P)
    _ssd_check(args, chunk, "parts" if types == "float32" else "wgmma")


# the wgmma route's edges (B, S, H, P, N, chunk, dtypes): chunks under
# wgmma's 64 rows (the smoke configs' 16; S = 40 clamping the chunk of
# 128), P = 128 with N = 128 and 64, N = 16 and 64, 64 chunks (the state's
# rounded copies feed every one), dt in bfloat16
SSD_EDGE_CASES = [
    (2, 64, 4, 64, 128, 16, "serving"), (3, 40, 4, 64, 128, 128, "serving"),
    (2, 256, 4, 128, 128, 128, "serving"),
    (1, 256, 3, 128, 64, 128, "serving"), (2, 256, 4, 64, 16, 128, "serving"),
    (2, 256, 8, 64, 64, 128, "serving"),
    (1, 8192, 4, 64, 128, 128, "serving"),
    (2, 256, 4, 64, 128, 128, "bfloat16"),
]


@pytest.mark.parametrize("case", SSD_EDGE_CASES)
def test_ssd_wgmma_kernel_edge_shapes(dev, case):
    B, S, H, P, N, chunk, types = case
    args = _ssd_inputs(dev, B, S, H, P, N, SSD_DTYPES[types], S + N + P)
    _ssd_check(args, chunk, "wgmma")


def test_ssd_kernel_takes_the_float32_route_where_tma_cannot_read(dev):
    """x one element past an aligned base: the parts route (its split
    reads any layout), held to the plain version at bfloat16's
    tolerance."""
    x, dt, A, Bm, Cm = _ssd_inputs(dev, 2, 256, 4, 64, 128,
                                   SSD_DTYPES["serving"], 5)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xu = buf[1:].view(x.shape).copy_(x)
    _ssd_check((xu, dt, A, Bm, Cm), 128, "parts")


# the parts route's edges (B, S, H, P, N, chunk, dtypes of x, dt, B/C):
# P and N off the multiples of 64 (and of 8), chunks under 16 and 64, the
# longest sequence, mixed dtypes, dt in bfloat16
SSD_PARTS_CASES = [
    (2, 48, 3, 12, 5, 16, (torch.float32,) * 3),
    (3, 40, 4, 64, 128, 128, (torch.float32,) * 3),
    (2, 256, 4, 128, 64, 128, (torch.float32,) * 3),
    (1, 256, 3, 100, 72, 128, (torch.float32,) * 3),
    (2, 96, 4, 64, 128, 24, (torch.float32,) * 3),
    (1, 8192, 4, 64, 128, 128, (torch.float32,) * 3),
    (2, 256, 4, 64, 128, 128, (torch.float32, torch.float32,
                               torch.bfloat16)),
    (2, 256, 4, 64, 128, 128, (torch.bfloat16, torch.float32,
                               torch.float32)),
    (2, 256, 4, 64, 128, 128, (torch.float32, torch.bfloat16,
                               torch.float32)),
    (2, 256, 4, 12, 128, 128, (torch.bfloat16,) * 3),
]


@pytest.mark.parametrize("case", SSD_PARTS_CASES)
def test_ssd_parts_route_edge_shapes(dev, case):
    """Held to the plain version at the tolerance of x's dtype, and a
    second call bit-identical."""
    B, S, H, P, N, chunk, types = case
    args = _ssd_inputs(dev, B, S, H, P, N, types, S + N + P)
    _ssd_check(args, chunk, "parts")
    first = ssd_ops.ssd(*args, chunk=chunk)
    for a, b in zip(first, ssd_ops.ssd(*args, chunk=chunk)):
        assert torch.equal(a, b)


def test_ssd_parts_route_reads_strided_float32_inputs(dev):
    """x as a head-strided view and B/C as views into one projection, in
    float32: the split reads them through their strides."""
    B, S, H, P, N = 2, 256, 6, 64, 128
    x, dt, A, _, _ = _ssd_inputs(dev, B, S, 2 * H, P, N,
                                 SSD_DTYPES["float32"], 3)
    bc = torch.randn((B, S, 2 * N), device=dev)
    args = (x[:, :, ::2], dt[:, :, :H], A[:H], bc[..., :N], bc[..., N:])
    _ssd_check(args, 128, "parts")


def test_ssd_split_matches_plain_bit_for_bit(dev):
    """The split kernel's parts are ref.split's, through strided views and
    in both dtypes."""
    for types in (SSD_DTYPES["float32"], SSD_DTYPES["bfloat16"]):
        x, _, _, Bm, Cm = _ssd_inputs(dev, 2, 64, 6, 80, 40, types, 9)
        bc = torch.cat([Bm, Cm], dim=-1)        # B and C of one projection
        before = ssd_ops.ssd_split.launches
        for args in ((x, Bm, Cm), (x[:, :, ::2], bc[..., :40], bc[..., 40:])):
            got = ssd_ops.ssd_split(*args)
            want = ssd_ref.split(*(a.contiguous() for a in args))
            for name, g, w in zip(("xp", "bcp"), got, want):
                bad = (g.float() != w.float()).nonzero()
                assert g.shape == w.shape and len(bad) == 0, (
                    name, types[0], args[0].stride(), len(bad),
                    bad[:4].tolist(), g.float()[tuple(bad[:4].T)].tolist(),
                    w.float()[tuple(bad[:4].T)].tolist())
        assert ssd_ops.ssd_split.launches == before + 2


def test_ssd_parts_launchers_refuse_what_they_cannot_run(dev):
    """P, N or the chunk past 128, S not a multiple of the chunk: refused
    (cudaErrorInvalidValue) before a launch."""
    lib = build.library()
    p = torch.zeros(1 << 16, device=dev).data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    for P, N in ((130, 16), (16, 130)):
        assert lib.ssd_parts_split_launch(*[p] * 5, 1, 32, 2, P, N,
                                          *[1] * 7, 0, 0, stream) == 1
    for P, N, S, chunk in ((130, 16, 32, 16), (16, 130, 32, 16),
                           (16, 16, 256, 256), (16, 16, 48, 32)):
        assert lib.ssd_parts_launch(*[p] * 9, 1, S, 2, P, N, chunk,
                                    *[1] * 4, 0, 0, 0, stream) == 1


def test_ssd_f32_kernel_still_matches_plain(dev):
    """ssd_f32_kernel, behind ops.launch only: held to the plain version on
    float32 inputs at mamba2's state, beside the parts route."""
    args = _ssd_inputs(dev, 1, 256, 4, 64, 128, SSD_DTYPES["float32"], 4)
    before = dict(ssd_ops.ssd.routes)
    y, state = ssd_ops.launch(*args, 128, "f32")
    torch.cuda.synchronize()
    assert ssd_ops.ssd.routes == before
    want_y, want_state = ssd_ref.ssd(*args, chunk=128)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)


def test_ssd_kernel_reads_strided_inputs(dev):
    """x as a head-strided view and B/C as views into one projection."""
    B, S, H, P, N = 2, 256, 6, 64, 128
    x, dt, A, _, _ = _ssd_inputs(dev, B, S, 2 * H, P, N,
                                 SSD_DTYPES["serving"], 3)
    bc = torch.randn((B, S, 2 * N), device=dev).to(torch.bfloat16)
    args = (x[:, :, ::2], dt[:, :, :H], A[:H], bc[..., :N], bc[..., N:])
    assert ssd_ops.route(args[0], args[3], args[4]) == "wgmma"
    before = ssd_ops.ssd.routes["wgmma"]
    y, state = ssd_ops.ssd(*args, chunk=128)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.routes["wgmma"] == before + 1
    want_y, want_state = ssd_ref.ssd(*(a.contiguous() for a in args),
                                     chunk=128)
    torch.testing.assert_close(y.float(), want_y.float(), atol=5e-2,
                               rtol=5e-2)
    torch.testing.assert_close(state, want_state, atol=5e-2, rtol=5e-2)


def test_ssd_kernel_raises_on_bad_input(dev):
    x, dt, A, Bm, Cm = _ssd_inputs(dev, 1, 48, 2, 16, 16,
                                   SSD_DTYPES["float32"], 0)
    with pytest.raises(ValueError, match="multiple"):
        ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="device"):
        ssd_ops.ssd(x, dt.cpu(), A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="head dim"):
        ssd_ops.ssd(torch.zeros((1, 16, 2, 130), device=dev),
                    dt[:, :16], A, Bm[:, :16], Cm[:, :16], chunk=16)


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-27b",
                                  "mamba2-780m", "zamba2-7b",
                                  "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                                  "whisper-tiny", "phi-3-vision-4.2b"])
def test_serving_steps_on_the_card_match_the_cpu(dev, arch):
    cfg = get_smoke_config(arch)
    params = init_params(api.param_specs(cfg), torch.Generator().manual_seed(1))
    S = 48 if cfg.ssm else 37       # Mamba2: a multiple of the SSD chunk
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, S)))
    token = torch.tensor([[5], [9]])
    n_ssd = cfg.all_layer_kinds().count("mamba")
    out = {}
    for d in ("cpu", dev):
        p = _to(step.working_params(cfg, params), d)
        before = (fa_ops.flash_attention.launches, ssd_ops.ssd.launches)
        logits, caches = step.make_prefill_step(cfg, cache_len=S + 8)(
            p, step.model_inputs(cfg, toks.to(d)))
        launched = (fa_ops.flash_attention.launches - before[0],
                    ssd_ops.ssd.launches - before[1])
        n_attn = cfg.n_layers + cfg.n_enc_layers - n_ssd
        want = (n_attn, n_ssd) if d == dev else (0, 0)
        assert launched == want
        dec, _ = step.make_decode_step(cfg)(p, token.to(d), caches, S)
        out[str(d)] = (logits.float().cpu(), dec.float().cpu())
    for a, b in zip(out["cpu"], out[str(dev)]):
        # bfloat16 activations; cuBLAS and the CPU sum in other orders
        torch.testing.assert_close(b, a, atol=0.08, rtol=0)


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    return tree.to(d)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-27b", "zamba2-7b",
                                  "whisper-tiny"])
def test_two_buffer_decode_on_the_card_matches_the_cpu(dev, arch):
    """The prefill's caches copied into an ``init_caches(recent_len=4)``
    layout, three decode steps on each device: the card's logits within
    the serving steps' 0.08 of the CPU's, within the reference's 5e-2 of
    the card's own single ring, and the main buffers unchanged."""
    cfg = get_smoke_config(arch)
    params = init_params(api.param_specs(cfg), torch.Generator().manual_seed(1))
    S, B = 32 if cfg.ssm else 19, 2
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (B, S)))
    out = {}
    for d in ("cpu", dev):
        p = _to(step.working_params(cfg, params), d)
        _, one = step.make_prefill_step(cfg, cache_len=S + 8)(
            p, step.model_inputs(cfg, toks.to(d)))
        with torch.device(d):
            two = api.init_caches(cfg, B, S + 8, recent_len=4)
        src = dict(_paths(one))
        for path, leaf in _paths(two):
            if path in src and src[path].shape == leaf.shape:
                leaf.copy_(src[path])
        paths = dict(_paths(two))
        main = {path: t.clone() for path, t in paths.items()
                if path.endswith(("/k", "/v", "/pos"))
                and path.rsplit("/", 1)[0] + "/rk" in paths}
        assert main
        rows = []
        for i, tok in enumerate(([[5], [9]], [[3], [1]], [[7], [7]])):
            tok = torch.tensor(tok, device=d)
            l_two, two = step.make_decode_step(cfg)(p, tok, two, S + i)
            l_one, one = step.make_decode_step(cfg)(p, tok, one, S + i)
            rows.append((l_two.float().cpu(), l_one.float().cpu()))
        for path, t in _paths(two):
            if path in main:
                assert torch.equal(t, main[path]), path
        out[str(d)] = rows
    for (card, card_one), (cpu, _) in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(card, cpu, atol=0.08, rtol=0)
        assert float((card - card_one).abs().max()) < 5e-2
        assert torch.equal(card.argmax(-1), card_one.argmax(-1))


def test_pipeline_through_flash_on_the_card_matches_the_cpu(dev):
    """granite-3-2b's smoke config at 4 layers in 2 stages of 2 groups, 4
    microbatches of 1 x 64 tokens (bf16): on the card every stage call
    runs the flash kernel (5 ticks x 2 stages x 2 layers = 20 launches),
    the output equals the card's stages applied one after another bit for
    bit, and the logits from it (final norm and unembedding) are the
    CPU's within the serving steps' 0.08, the quantity that bound holds
    there (on the hidden states themselves 5 of 16384 elements differed
    by up to 0.105, the largest at a value of 0.62)."""
    from repro_torch.distributed.pipeline import (PipelineConfig,
                                                  pipeline_forward,
                                                  split_microbatches)
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("granite-3-2b").replace(n_layers=4)
    params = step.working_params(cfg, init_params(
        api.param_specs(cfg), torch.Generator().manual_seed(3)))
    n_st, M, S = 2, 4, 64
    per = cfg.n_groups // n_st
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (M, S)))
    pcfg = PipelineConfig(n_stages=n_st, n_microbatches=M)
    out = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        positions = torch.arange(S, device=d).expand(1, S)

        def stage(sp, h):
            for gp in T.unbind(sp, per):
                h = T.apply_block_full(cfg, "global", gp["l0"], None, h,
                                       positions)[0]
            return h

        stacked = map_tree(lambda v: v.reshape((n_st, per) + v.shape[1:]),
                           p["groups"])
        mbs = split_microbatches(T._embed(cfg, p["embed"], toks.to(d)), M)
        before = fa_ops.flash_attention.launches
        got = pipeline_forward(stage, stacked, mbs, pcfg)
        assert fa_ops.flash_attention.launches - before == (
            20 if d == dev else 0)
        if d == dev:
            seq = []
            for m in range(M):
                h = mbs[m]
                for sp in T.unbind(stacked, n_st):
                    h = stage(sp, h)
                seq.append(h)
            assert torch.equal(got, torch.stack(seq))
        h = L.rms_norm(got[:, 0], p["final_ln"], cfg.norm_eps)
        out[str(d)] = T._logits_from_hidden(cfg, h, p["embed"]).float().cpu()
    torch.testing.assert_close(out[str(dev)], out["cpu"], atol=0.08, rtol=0)



def _service_mixed_problem():
    from repro_torch.core.workload import DagJob, Stage
    small = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   containers_per_core=2)
    big = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    bi = JobProfile(n_map=16, n_reduce=4, m_avg=4000, m_max=9000,
                    r_avg=2000, r_max=4500)
    chain = DagJob("etl", stages=(Stage(12, 900, 2200), Stage(6, 700, 1700),
                                  Stage(2, 1500, 3200)))
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


def test_service_on_the_card_equals_the_service_on_the_cpu(dev):
    """The mixed MapReduce + DAG problem submitted twice to a service on
    the card and to one on the CPU (plain versions): the same decisions,
    rounds, dispatches, points and cache stats, response times within a
    relative 1e-3 (exponential draws: the card's and the CPU's libm may
    differ by an ulp); on the card one event-loop launch a fused
    dispatch, qn_event and dag_event both, and each job's decisions equal
    to the card's solo run's."""
    from benchmarks import torch_scenarios as scen
    kw = dict(min_jobs=4, replications=1)
    cpu = scen.spark_dag_service("cpu", problem=_service_mixed_problem(),
                                 **kw)
    counts = lambda: {"qn_event": qn_ops.qn_event.launches,
                      "dag_event": dag_ops.dag_event.launches}
    card = scen.spark_dag_service(dev, problem=_service_mixed_problem(),
                                  counts=counts, **kw)
    assert [m for m in scen.mismatches(cpu, card, rel=1e-3)
            if not m.startswith("timing")] == []
    assert card["solo_equal"] == [True, True]
    service = card["launches"]["service"]
    assert service["qn_event"] > 0 and service["dag_event"] > 0
    assert service["qn_event"] + service["dag_event"] == \
        card["scheduler"]["fused_dispatches"]


# ----------------------------------------------------------- private cloud

def _packings(seed, b, v, h, *, non_integer):
    g = np.random.default_rng(seed)
    asg = g.integers(-1, h + 1, size=(b, v))        # h: past the catalog
    vc = g.choice([0.0, 1.0, 2.0, 4.0, 20.0], size=(b, v)).astype(np.float32)
    vmem = (g.choice([0.1, 0.3, 1.7, 2.35, 3.9], size=(b, v)) if non_integer
            else vc * 4.0).astype(np.float32)
    hc = g.choice([4.0, 8.0, 20.0, 64.0], size=h).astype(np.float32)
    hm = (hc * 4.0 if not non_integer else
          g.uniform(2.0, 40.0, size=h)).astype(np.float32)
    return asg, vc, vmem, hc, hm


@pytest.mark.parametrize("b,v,h", [(1, 1, 1), (5, 12, 6), (24, 90, 9),
                                   (512, 300, 40)])
@pytest.mark.parametrize("non_integer", [False, True])
def test_feasibility_batch_on_the_card_equals_its_cpu_version(
        dev, b, v, h, non_integer):
    """The card's mask equals the CPU's on packings with pad slots,
    unplaced VMs and host indices past the catalog; with non-integer
    memory each host is also set to its float64 load, where the order of
    a float32 sum could decide."""
    from repro_torch.cloud import placement
    args = _packings(b * v + h, b, v, h, non_integer=non_integer)
    want = placement.feasibility_batch(*args, device="cpu")
    got = placement.feasibility_batch(*args, device=dev)
    assert got.dtype == np.bool_ and got.tolist() == want.tolist()
    if non_integer:
        asg, vc, vmem, hc, _ = args
        load = np.zeros(h)
        for i in range(b):
            on = (asg[i] >= 0) & (asg[i] < h)
            row = np.zeros(h)
            np.add.at(row, asg[i][on], vmem[i][on].astype(np.float64))
            load = np.maximum(load, row)
        hm = load.astype(np.float32)
        assert placement.feasibility_batch(asg, vc, vmem, hc, hm,
                                           device=dev).tolist() == \
            placement.feasibility_batch(asg, vc, vmem, hc, hm,
                                        device="cpu").tolist()


def test_private_plan_on_the_card_equals_the_cpu(dev):
    """benchmarks/private_cloud.py's over-committed cluster, cut to
    ``min_jobs=4``, 1 replication: the card's plan (kernels, packings
    checked on the card) against the CPU's, decisions and deployment
    summary exact, response times within a relative 1e-3."""
    from benchmarks import torch_scenarios as scen
    from repro_torch.cloud import PrivateCloud, homogeneous_hosts
    prob = scen.private_cloud_problem(3)
    cloud = PrivateCloud(hosts=homogeneous_hosts(6, 4,
                                                 energy_cost_per_h=0.3))
    kw = dict(min_jobs=4, replications=1, seed=3, window=8)
    cpu = DSpace4Cloud(prob, deployment=cloud, device="cpu", **kw).run()
    card = DSpace4Cloud(prob, deployment=cloud, device=dev, **kw).run()
    assert card.deployment == cpu.deployment
    assert card.deployment["coordinated"]
    want = {k: v.as_dict() for k, v in cpu.solutions.items()}
    got = {k: v.as_dict() for k, v in card.solutions.items()}
    assert scen.mismatches(want, got, rel=1e-3) == []


# ------------------------------------------------------- flash backward
# (B, S, H, KV, Dh, causal, window): granite's training shape, a window,
# llama4-scout's GQA group 5 at head dim 128, zamba2's head dim 112, the
# non-causal encoder shape, a ragged S, Dh 256, Dh 136 (TMA pads it to
# 192) and nemotron-4-340b's Dh 192 with its GQA group 12 (bfloat16: the
# parts kernels; float32 past 128: the simt kernels)
FA_BWD_CASES = [
    (8, 1024, 32, 8, 64, True, 0), (2, 777, 8, 2, 64, True, 128),
    (1, 512, 40, 8, 128, True, 0), (2, 384, 8, 8, 112, True, 0),
    (2, 1500, 6, 6, 64, False, 0), (1, 200, 8, 1, 256, True, 0),
    (1, 130, 4, 2, 16, False, 40), (2, 300, 8, 2, 136, True, 0),
    (1, 520, 24, 2, 192, True, 0),
]
# kernel against plain on identical inputs: f32 sums in other orders; in
# bf16 a p or ds on a rounding edge may round the other way, and the
# outputs round to bf16 (2**-8 relative)
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _fa_bwd_inputs(dev, case, dtype):
    B, S, H, KV, Dh, causal, window = case
    g = torch.Generator(device=dev).manual_seed(S + H + Dh)
    q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=dev
                           ).to(dtype) for n in (H, KV, KV))
    dout = torch.randn((B, S, H, Dh), generator=g, device=dev).to(dtype)
    out, lse = fa_ref.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    return q, k, v, out, lse, dout


# ragged shapes on both routes: S = 77, 257 and 1000 (no multiple of a
# tile), head dims 16, 80, 112, 136 and 184 (TMA's zero fill up to 64, 128
# or 192), a window whose edge crosses the 64- and 128-row tiles, GQA
# groups 1, 4, 5, 6
FA_BWD_RAGGED = [
    (1, 77, 4, 4, 16, True, 0), (2, 257, 8, 2, 80, False, 0),
    (1, 1000, 5, 1, 112, True, 300), (2, 257, 20, 4, 64, True, 100),
    (1, 1000, 16, 4, 80, False, 77), (1, 257, 12, 2, 136, True, 100),
    (2, 77, 6, 6, 184, False, 0),
]


# every wrapper of the backward, and those each route launches (the
# wgmma route's pair or its parts kernels, by ``wgmma_kernels``)
BWD_WRAPPERS = (fa_ops.fa_bwd_dq_wgmma, fa_ops.fa_bwd_dkdv_wgmma,
                fa_ops.fa_bwd_delta, fa_ops.fa_bwd_dkdv, fa_ops.fa_bwd_dq,
                fa_ops.fa_bwd_prep, fa_ops.fa_bwd_dq_parts,
                fa_ops.fa_bwd_dkdv_parts)
BWD_ROUTE_WRAPPERS = {"pair": BWD_WRAPPERS[:2], "simt": BWD_WRAPPERS[2:5],
                      "parts": BWD_WRAPPERS[5:]}


def _bwd_launches():
    return [w.launches for w in BWD_WRAPPERS]


def _simt_bwd(q, k, v, out, lse, dout, causal, window):
    """(dq, dk, dv) from the simt route's three wrappers, whatever the
    dtype."""
    delta = fa_ops.fa_bwd_delta(out, dout)
    dk, dv = fa_ops.fa_bwd_dkdv(q, k, v, dout, lse, delta, causal, window)
    dq = fa_ops.fa_bwd_dq(q, k, v, dout, lse, delta, causal, window)
    return dq, dk, dv


def _check_bwd(dev, case, dtype, route=None):
    """One backward of ``case`` against the plain version, asserting the
    route's launches: ``flash_attention_bwd`` on ``bwd_route``'s kernels
    (on wgmma the pair, dq, which writes delta, then dkdv, or the three
    parts kernels; three on simt), which must be ``route`` where one is
    named, or with ``route="simt"`` the simt wrappers called directly."""
    *_, causal, window = case
    args = _fa_bwd_inputs(dev, case, dtype)
    before = _bwd_launches()
    if route == "simt":
        took, got = "simt", _simt_bwd(*args, causal, window)
    else:
        took = fa_ops.bwd_route(*args[:3])
        assert route in (None, took)
        got = fa_ops.flash_attention_bwd(*args, causal=causal, window=window)
        if took == "wgmma":
            took = fa_ops.wgmma_kernels(args[0])
    torch.cuda.synchronize()
    assert _bwd_launches() == [n + (w in BWD_ROUTE_WRAPPERS[took])
                               for n, w in zip(before, BWD_WRAPPERS)]
    want = fa_ref.flash_attention_bwd(*args, causal=causal, window=window)
    tol = FA_BWD_TOL[dtype]
    for g_, w_, x in zip(got, want, args[:3]):
        assert g_.shape == x.shape and g_.dtype == x.dtype
        torch.testing.assert_close(g_.float(), w_.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("case", FA_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_match_plain(dev, case, dtype):
    """Each case on its route (wgmma: bfloat16 up to head dim 256, float32
    up to 128; simt: float32 past 128)."""
    _check_bwd(dev, case, dtype)


@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_flash_backward_simt_route_on_bfloat16(dev, case):
    """The simt kernels, called directly, on the bfloat16 cases: the route
    of float32 at head dims past 128 holds on bfloat16 inputs too."""
    _check_bwd(dev, case, torch.bfloat16, route="simt")


@pytest.mark.parametrize("case", FA_BWD_RAGGED)
@pytest.mark.parametrize("route", ["wgmma", "simt"])
def test_flash_backward_ragged_shapes_match_plain(dev, case, route):
    _check_bwd(dev, case, torch.bfloat16, route=route)


@pytest.mark.parametrize("case", FA_BWD_RAGGED)
def test_flash_backward_ragged_shapes_float32(dev, case):
    """float32 at the ragged shapes on its route (up to head dim 128 the
    parts kernels, three bf16 parts an operand; past it simt), held to
    the plain version's float32 tolerance."""
    _check_bwd(dev, case, torch.float32)


@pytest.mark.parametrize("case", [FA_BWD_CASES[0], FA_BWD_RAGGED[0],
                                  FA_BWD_RAGGED[3]])
def test_wgmma_dq_pass_writes_the_rows_buffer(dev, case):
    """The wgmma dq pass's rows buffer: each q row's (lse * log2(e), delta)
    with delta against the einsum, and zeros past S up to the 64-row
    padding that the dkdv kernel's bulk copies read."""
    *_, causal, window = case
    q, k, v, out, lse, dout = _fa_bwd_inputs(dev, case, torch.bfloat16)
    S = q.shape[1]
    _, rows = fa_ops.fa_bwd_dq_wgmma(q, k, v, out, dout, lse, causal, window)
    torch.cuda.synchronize()
    assert tuple(rows.shape) == fa_ops.rows_shape(q)
    torch.testing.assert_close(fa_ops.rows_delta(rows, S), torch.einsum(
        "bshd,bshd->bhs", dout.float(), out.float()), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(rows[:, :, :S, 0], lse * math.log2(math.e),
                               atol=1e-5, rtol=1e-6)
    assert not rows[:, :, S:].any()


@pytest.mark.parametrize("case,dtype", [
    (FA_BWD_CASES[0], torch.bfloat16), (FA_BWD_CASES[2], torch.bfloat16),
    (FA_BWD_RAGGED[4], torch.bfloat16), (FA_BWD_CASES[8], torch.bfloat16),
    (FA_BWD_CASES[0], torch.float32), (FA_BWD_RAGGED[2], torch.float32)])
def test_wgmma_backward_is_deterministic(dev, case, dtype):
    """Two backwards of the same inputs on the wgmma route (the pair or
    the parts kernels) give the same bits: the GQA group's sum stays
    inside a dkdv block, with no atomics."""
    *_, causal, window = case
    args = _fa_bwd_inputs(dev, case, dtype)
    assert fa_ops.bwd_route(*args[:3]) == "wgmma"
    a = fa_ops.flash_attention_bwd(*args, causal=causal, window=window)
    b = fa_ops.flash_attention_bwd(*args, causal=causal, window=window)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype,Dh", [(0, 64), (1, 136), (1, 256)])
def test_wgmma_backward_launchers_refuse_what_they_cannot_run(dev, dtype,
                                                             Dh):
    """The C launchers return cudaErrorInvalidValue (1) without a launch
    for float32 (dtype 0) or a head dim past 128."""
    lib = build.library()
    buf = torch.zeros(1024, device=dev)
    p, stream = buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream
    shape = (1, 64, 2, 2, Dh)
    strides = (64 * 2 * Dh, 2 * Dh, Dh) * 6
    assert lib.fa_bwd_dq_wgmma_launch(*[p] * 8, *shape, *strides, 1, 0,
                                      dtype, stream) == 1
    assert lib.fa_bwd_dkdv_wgmma_launch(*[p] * 7, *shape, *strides, 1, 0,
                                        dtype, stream) == 1


@pytest.mark.parametrize("case,dtype", [
    (FA_BWD_RAGGED[5], torch.bfloat16), (FA_BWD_CASES[8], torch.bfloat16),
    (FA_BWD_RAGGED[0], torch.float32), (FA_BWD_RAGGED[2], torch.float32)])
def test_parts_prep_writes_rows_and_parts(dev, case, dtype):
    """fa_bwd_prep's rows buffer (each q row's (lse * log2(e), delta),
    zeros past S) and, for float32, each operand's three bf16 parts: hi
    the value rounded to bf16, hi + mid + lo the value exactly, zeros past
    Dh."""
    *_, causal, window = case
    q, k, v, out, lse, dout = _fa_bwd_inputs(dev, case, dtype)
    S, Dh = q.shape[1], q.shape[3]
    rows, operands = fa_ops.fa_bwd_prep(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    torch.testing.assert_close(fa_ops.rows_delta(rows, S), torch.einsum(
        "bshd,bshd->bhs", dout.float(), out.float()), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(rows[:, :, :S, 0], lse * math.log2(math.e),
                               atol=1e-5, rtol=1e-6)
    assert not rows[:, :, S:].any()
    if dtype == torch.bfloat16:
        assert all(a is b for a, b in zip(operands, (q, k, v, dout)))
        return
    for x, p in zip((q, k, v, dout), operands):
        assert tuple(p.shape) == fa_ops.parts_shape(x)
        DP = p.shape[-1] // 3
        hi, mid, lo = (p[..., i * DP:i * DP + Dh].float() for i in range(3))
        assert torch.equal(hi, x.to(torch.bfloat16).float())
        assert torch.equal(hi + mid + lo, x)
        assert all(not p[..., i * DP + Dh:(i + 1) * DP].any()
                   for i in range(3))


@pytest.mark.parametrize("dtype,Dh", [(1, 128), (1, 264), (0, 136),
                                      (0, 256)])
def test_parts_launchers_refuse_what_they_cannot_run(dev, dtype, Dh):
    """The parts kernels' C launchers return cudaErrorInvalidValue (1)
    without a launch off their limits: bfloat16 (dtype 1) only past head
    dim 128 (the pair's) up to 256, float32 (dtype 0) up to 128."""
    lib = build.library()
    buf = torch.zeros(1024, device=dev)
    p, stream = buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream
    shape = (1, 64, 2, 2, Dh)
    strides = (64 * 2 * Dh, 2 * Dh, Dh) * 6
    assert lib.fa_bwd_prep_launch(*[p] * 11, *shape, *strides[:15], dtype,
                                  stream) == 1
    assert lib.fa_bwd_dq_parts_launch(*[p] * 6, *shape, *strides[:15], 1, 0,
                                      dtype, stream) == 1
    assert lib.fa_bwd_dkdv_parts_launch(*[p] * 7, *shape, *strides, 1, 0,
                                        dtype, stream) == 1


@pytest.mark.parametrize("case", [(2, 300, 8, 2, 64, True, 0),
                                  (1, 257, 4, 4, 128, True, 64),
                                  (2, 130, 8, 1, 256, False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_from_both_routes(dev, case, dtype):
    B, S, H, KV, Dh, causal, window = case
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=dev
                           ).to(dtype) for n in (H, KV, KV))
    out, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    want_out, want_lse = fa_ref.flash_attention_fwd(q, k, v, causal=causal,
                                                    window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol,
                               rtol=tol)


def test_flash_autograd_on_the_card_matches_the_cpu(dev):
    g = np.random.default_rng(3)
    arrs = [torch.from_numpy(g.standard_normal((2, 96, n, 32)).astype(
        np.float32)) for n in (8, 2, 2)]
    grads = {}
    for d in ("cpu", dev):
        q, k, v = (a.to(d).detach().requires_grad_() for a in arrs)
        out = fa_ops.flash_attention(q, k, v, causal=True, window=40)
        assert out.grad_fn is not None
        (out * out).sum().backward()
        grads[str(d)] = [x.grad.cpu() for x in (q, k, v)]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_ssd_backward_on_the_card_raises(dev, monkeypatch):
    """The backward on the card launches its kernels (one count a call) or
    raises: a launch the library refuses raises, and nothing falls back to
    the plain version."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 32, 2, 16), generator=g, device=dev,
                    requires_grad=True)
    dt = torch.rand((1, 32, 2), generator=g, device=dev) + 0.1
    A = -torch.rand((2,), generator=g, device=dev)
    Bm, Cm = (torch.randn((1, 32, 16), generator=g, device=dev)
              for _ in range(2))
    y, state = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=16)
    assert y.grad_fn is not None and state.grad_fn is not None
    before = ssd_ops.ssd_bwd.launches
    (y.float() ** 2).sum().backward(retain_graph=True)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_bwd.launches == before + 1
    want = ssd_ref.ssd_bwd(x.detach(), dt, A, Bm, Cm, 2 * y.detach(),
                           torch.zeros_like(state), 16)[0]
    torch.testing.assert_close(x.grad, want, atol=1e-4 * float(
        want.abs().max()), rtol=0)
    monkeypatch.setattr(build, "library",
                        lambda real=build.library: _refusing(real))
    with pytest.raises(RuntimeError, match="ssd_bwd kernel launch failed"):
        y.sum().backward()
    assert ssd_ops.ssd_bwd.launches == before + 1


def _refusing(real):
    """The kernel library with its SSD backward entry point refusing every
    launch."""
    lib = real()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def ssd_bwd_launch(*args):
            return 1                         # cudaErrorInvalidValue
    return Refusing()


# the SSD backward's cases (B, S, H, P, N, chunk, dtypes, nonzero dstate):
# the reference's SSD cases, the training shapes cut in batch (mamba2's
# N = 128, zamba2's 112 heads at N = 64), a sequence under the chunk, P = N
# = 128 (the scan kernels' largest tiles), N != P, H = 1, a chunk of 16 and
# of 48 (a stripe of rows cut short), dt in bfloat16
SSD_BWD_CASES = [
    (2, 64, 3, 16, 16, 16, "float32", True),
    (1, 128, 4, 32, 64, 32, "float32", True),
    (1, 96, 2, 64, 128, 32, "serving", True),
    (2, 1024, 48, 64, 128, 128, "serving", False),
    (1, 1024, 112, 64, 64, 128, "serving", False),
    (2, 96, 8, 64, 128, 128, "serving", True),
    (1, 256, 4, 128, 128, 128, "float32", True),
    (2, 384, 1, 64, 16, 128, "float32", True),
    (2, 64, 4, 64, 128, 16, "serving", True),
    (2, 192, 3, 32, 24, 48, "float32", True),
    (2, 256, 4, 64, 128, 128, "bfloat16", True),
]


def _ssd_bwd_check(args, chunk, simt=False):
    """One call on the card, again bit for bit, against ref.ssd_bwd: each
    output within 1e-4 of its largest magnitude (float32 sums in other
    orders) and, in bfloat16, one rounding step (up to 2^-7) of itself
    besides.  ssd_bwd takes the route bwd_route names; ``simt`` runs the
    SIMT route's kernels on the same inputs instead (ops.bwd_launch, no
    count)."""
    before = ssd_ops.ssd_bwd.launches, dict(ssd_ops.ssd_bwd.routes)
    route = "simt" if simt else ssd_ops.bwd_route(args[0], args[3],
                                                  args[4], args[5])
    if simt:
        call = lambda: ssd_ops.bwd_launch(*args, min(chunk, args[0].shape[1]),
                                          "simt")
    else:
        call = lambda: ssd_ops.ssd_bwd(*args, chunk=chunk)
    got = call()
    again = call()
    torch.cuda.synchronize()
    n = 0 if simt else 2
    assert ssd_ops.ssd_bwd.launches == before[0] + n
    assert {r: c - before[1][r] for r, c in ssd_ops.ssd_bwd.routes.items()} \
        == {r: n * (r == route) for r in ssd_ops.ssd_bwd.routes}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ssd_ref.ssd_bwd(*args, chunk=chunk)
    for name, g_, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g_.dtype == w.dtype and g_.shape == w.shape, name
        w32 = w.float()
        tol = 1e-4 * float(w32.abs().max()) + (
            2.0 ** -7 * w32.abs() if w.dtype == torch.bfloat16 else 0.0)
        assert bool(((g_.float() - w32).abs() <= tol).all()), name


def _ssd_bwd_case(dev, case):
    B, S, H, P, N, chunk, types, nonzero = case
    x, dt, A, Bm, Cm = _ssd_inputs(dev, B, S, H, P, N, SSD_DTYPES[types],
                                   S + H + N)
    g = torch.Generator(device=dev).manual_seed(S + P)
    dy = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    ds = torch.randn((B, H, P, N), generator=g, device=dev) if nonzero \
        else torch.zeros((B, H, P, N), device=dev)
    return (x, dt, A, Bm, Cm, dy, ds), chunk


@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain(dev, case):
    """bf16 x, B, C and dy take the wgmma route, float32 the SIMT one."""
    args, chunk = _ssd_bwd_case(dev, case)
    assert ssd_ops.bwd_route(*args[:1], *args[3:6]) == (
        "simt" if case[6] == "float32" else "wgmma")
    _ssd_bwd_check(args, chunk)


@pytest.mark.parametrize("case", [c for c in SSD_BWD_CASES
                                  if c[6] != "float32"])
def test_ssd_backward_simt_kernels_on_bf16_inputs_match_plain(dev, case):
    """The SIMT route's kernels on the inputs the wgmma route takes."""
    _ssd_bwd_check(*_ssd_bwd_case(dev, case), simt=True)


def test_ssd_backward_copies_a_dy_tma_cannot_read(dev):
    """dy with rows of odd stride and one element past an aligned base:
    the wgmma route on a contiguous copy, the same bits as on dy
    contiguous."""
    args, chunk = _ssd_bwd_case(dev, (2, 256, 4, 64, 128, 128, "serving",
                                      True))
    dy = args[5]
    pad = torch.zeros(dy.shape[:-1] + (dy.shape[-1] + 1,), dtype=dy.dtype,
                      device=dev)[..., :-1].copy_(dy)
    buf = torch.empty(dy.numel() + 8, dtype=dy.dtype, device=dev)
    off = buf[1:1 + dy.numel()].view(dy.shape).copy_(dy)
    want = ssd_ops.ssd_bwd(*args, chunk=chunk)
    for odd in (pad, off):
        ins = (*args[:5], odd, args[6])
        assert ssd_ops.bwd_route(*ins[:1], *ins[3:6]) == "wgmma"
        got = ssd_ops.ssd_bwd(*ins, chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssd_backward_wgmma_launcher_refuses_what_it_cannot_run(dev):
    """ssd_bwd_wgmma_launch refuses (cudaErrorInvalidValue) P not a
    multiple of 8, a chunk past 128, x not 16-byte aligned and head groups
    that leave a group empty, before any launch."""
    args, chunk = _ssd_bwd_case(dev, (1, 256, 4, 64, 128, 128, "serving",
                                      True))
    x, dt, A, Bm, Cm, dy, ds = args
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    outs = [torch.empty_like(t) for t in (x, dt, A, Bm, Cm)]
    G2, G3 = ssd_ops.bwd_groups(Bb, S // chunk, H, 132)
    scratch = [torch.empty(shape, dtype=d, device=dev) for shape, d in
               ssd_ops.bwd_scratch_shapes(Bb, S, H, P, N, chunk, G2,
                                          G3).values()]
    lib = build.library()

    def launch(xp=x.data_ptr(), P_=P, chunk_=chunk, G2_=G2, G3_=G3):
        strides = [*ssd_ops._strides(x, 3), *dt.stride(), A.stride(0),
                   *ssd_ops._strides(Bm, 2), *ssd_ops._strides(Cm, 2),
                   *ssd_ops._strides(dy, 3)]
        ptrs = [xp] + [t.data_ptr() for t in (dt, A, Bm, Cm, dy, ds, *outs,
                                              *scratch)]
        return build.launch(dev, lib.ssd_bwd_wgmma_launch, *ptrs, Bb, S, H,
                            P_, N, chunk_, G2_, G3_, *strides, 0, 0)
    invalid = 1                                  # cudaErrorInvalidValue
    assert launch(P_=60) == invalid
    assert launch(chunk_=256) == invalid
    assert launch(xp=x.data_ptr() + 2) == invalid
    assert launch(G2_=3) == invalid              # ceil(4 / 3) = 2: 2, 2, 0
    assert launch(G3_=0) == invalid
    assert launch() == 0
    torch.cuda.synchronize()


def test_ssd_backward_reads_strided_inputs(dev):
    """x, dt and A as head-strided views, B and C as views into one
    projection, dy a head-strided view."""
    B, S, H, P, N = 2, 256, 6, 64, 128
    x, dt, A, _, _ = _ssd_inputs(dev, B, S, 2 * H, P, N,
                                 SSD_DTYPES["serving"], 3)
    bc = torch.randn((B, S, 2 * N), device=dev).to(torch.bfloat16)
    dy = torch.randn((B, S, 2 * H, P), device=dev).to(torch.bfloat16)
    ds = torch.randn((B, H, P, N), device=dev)
    _ssd_bwd_check((x[:, :, ::2], dt[:, :, ::2], A[::2], bc[..., :N],
                    bc[..., N:], dy[:, :, 1::2], ds), 128)


def test_ssd_autograd_on_the_card_matches_the_cpu_in_bf16(dev):
    """bf16 x, B and C (the wgmma route's backward on the card) against
    the CPU's plain backward through autograd, dt and A float32: each
    gradient within 1e-4 of its largest magnitude and one bf16 step."""
    g = np.random.default_rng(6)
    arrs = [g.standard_normal((2, 256, 4, 32)), np.log1p(np.exp(
        g.standard_normal((2, 256, 4)))), -np.exp(0.3 * g.standard_normal(
            4)), g.standard_normal((2, 256, 48)), g.standard_normal(
        (2, 256, 48))]
    kinds = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
             torch.bfloat16)
    arrs = [torch.from_numpy(a.astype(np.float32)).to(k)
            for a, k in zip(arrs, kinds)]
    # cotangents that do not depend on y: the card's forward rounds y
    # to bf16 at other places than the CPU's
    wy = torch.from_numpy(g.standard_normal((2, 256, 4, 32)).astype(
        np.float32))
    ws = torch.from_numpy(g.standard_normal((2, 4, 32, 48)).astype(
        np.float32))
    grads = {}
    for d in ("cpu", dev):
        ins = [a.to(d, copy=True).requires_grad_() for a in arrs]
        before = dict(ssd_ops.ssd_bwd.routes)
        y, state = ssd_ops.ssd(*ins, chunk=64)
        ((y.float() * wy.to(d)).sum() + (state * ws.to(d)).sum()).backward()
        assert ssd_ops.ssd_bwd.routes["wgmma"] - before["wgmma"] == (
            0 if d == "cpu" else 1)
        grads[str(d)] = [t.grad.cpu() for t in ins]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        assert a.dtype == b.dtype
        w = a.float()
        tol = 1e-4 * float(w.abs().max()) + (
            2.0 ** -7 * w.abs() if a.dtype == torch.bfloat16 else 0.0)
        assert bool(((b.float() - w).abs() <= tol).all())


def test_ssd_autograd_on_the_card_matches_the_cpu(dev):
    g = np.random.default_rng(5)
    arrs = [g.standard_normal((2, 256, 4, 32)), g.uniform(0.05, 1.0,
                                                          (2, 256, 4)),
            -g.uniform(0.5, 2.0, (4,)), g.standard_normal((2, 256, 48)),
            g.standard_normal((2, 256, 48))]
    arrs = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    grads = {}
    for d in ("cpu", dev):
        ins = [a.to(d, copy=True).requires_grad_() for a in arrs]
        y, state = ssd_ops.ssd(*ins, chunk=64)
        ((y * y).sum() + state.sum()).backward()
        grads[str(d)] = [t.grad.cpu() for t in ins]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4 * float(a.abs().max()),
                                   rtol=0)


# a train step's gradients on the card against the CPU's (plain versions),
# relative to each leaf's largest magnitude: float32 sums in other orders
# (cuBLAS, the backward kernels); bfloat16 rounds at other places
MODEL_GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.06}


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-27b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_backward_on_the_card_matches_the_cpu(dev, arch, dtype):
    from repro_torch.train import step as tstep
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    params = init_params(api.param_specs(cfg), torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 65)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for d in ("cpu", dev):
        before = _bwd_launches()
        (loss, _), grads = tstep.value_and_grad(
            cfg, _to(params, d), {k: v.to(d) for k, v in batch.items()})
        # both dtypes take the wgmma route at the smoke head dim 16:
        # bfloat16 its pair (no delta kernel), float32 its parts kernels
        route = BWD_ROUTE_WRAPPERS["pair" if dtype == "bfloat16" else
                                   "parts"]
        n = cfg.n_layers if d == dev else 0
        assert _bwd_launches() == [b + n * (w in route) for w, b in
                                   zip(BWD_WRAPPERS, before)]
        out[str(d)] = (float(loss), _leaves(grads))
    assert abs(out[str(dev)][0] - out["cpu"][0]) < 1e-2
    for path, want in out["cpu"][1].items():
        got = out[str(dev)][1][path].cpu().float()
        assert float(got.abs().max()) > 0, path       # every leaf gets one
        scale = float(want.float().abs().max())
        assert float((got - want.float()).abs().max()) <= \
            MODEL_GRAD_TOL[dtype] * scale, path


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_model_backward_on_the_card_matches_the_cpu(dev, arch, dtype):
    """A Mamba2 or hybrid smoke model's gradients on the card (the SSD
    backward kernels, once a Mamba2 layer) against the CPU's."""
    from repro_torch.train import step as tstep
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    n_ssd = cfg.all_layer_kinds().count("mamba")
    params = init_params(api.param_specs(cfg), torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 65)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for d in ("cpu", dev):
        before = ssd_ops.ssd_bwd.launches
        (loss, _), grads = tstep.value_and_grad(
            cfg, _to(params, d), {k: v.to(d) for k, v in batch.items()})
        assert ssd_ops.ssd_bwd.launches - before == (n_ssd if d == dev
                                                     else 0)
        out[str(d)] = (float(loss), _leaves(grads))
    assert abs(out[str(dev)][0] - out["cpu"][0]) < 1e-2
    for path, want in out["cpu"][1].items():
        got = out[str(dev)][1][path].cpu().float()
        assert float(got.abs().max()) > 0, path
        scale = float(want.float().abs().max())
        assert float((got - want.float()).abs().max()) <= \
            MODEL_GRAD_TOL[dtype] * scale, path


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}
