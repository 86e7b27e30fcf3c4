"""The port's ``qn_event`` event loop and its draw tables against the
reference (JAX on the CPU).

1. Kernel parity: the reference's own draw tables
   (``repro.kernels.qn_event.kernel.event_streams``) go through the port's
   plain event loop and through the reference's Pallas kernel
   (``qn_event_fwd``, interpret mode): outputs must be bit-identical, in
   exponential and replay mode, with padding lanes (zero budget),
   single-slot lanes, budgets below the scan length and a lane without
   reduce tasks.
   The same at 2049 users, where the card's kernel keeps its per-user
   state in more than 48 KB of shared memory, and at the lanes the card's
   ``qn_event_wide`` takes (20 users, 8192 slots, caps from 1 to 8192).
2. Tables: the port's ``event_streams`` equals the reference's bit for bit
   in everything drawn by ``randint``, and within one ulp in everything
   drawn by ``exponential`` (torch's ``log1p`` is not XLA's); at 2049
   users the initial think clocks, a unit draw times think_ms, within two.
   On CPU tensors it takes the plain version and launches no kernel.
3. End to end: ``qn_sim.response_time_batch`` of both packages on their own
   draws.  Measured on these cases (torch 2.13 CPU, JAX 0.9.0): five of
   the six are bit-identical, the sixth (seed 7, 3 replications) differs
   by a relative 5.6e-8, from think draws one ulp apart.  The stated
   tolerance is a relative 1e-3, room for such a difference to shift one
   job's events.  The dispatch accounting must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qn_sim as ref_qn_sim
from repro.kernels.qn_event import kernel as ref_kernel
from repro_torch.core import qn_sim
from repro_torch.kernels.qn_event import ops as qn_ops

torch.set_num_threads(1)    # the plain loop is many tiny ops

BASE = dict(n_map=8, n_reduce=2, m_avg=40.0, r_avg=60.0, think_ms=1000.0)
FAST = dict(min_jobs=8, warmup_jobs=2, replications=2, seed=0)
MS = np.array([30.0, 45.0, 55.0, 38.0, 61.0], np.float32)
RS = np.array([80.0, 95.0, 70.0], np.float32)


def _lanes(H, replay, n_reduce=2):
    budget = ref_qn_sim.padded_event_budget(8, n_reduce, min_jobs=8,
                                            warmup_jobs=2)
    nea = np.array([0, budget, budget // 2, budget, 0, budget // 4, 1,
                    budget], np.int32)
    B = len(nea)
    lanes = dict(
        n_map=np.full(B, 8, np.int32), n_reduce=np.full(B, n_reduce, np.int32),
        m_avg=np.linspace(30, 50, B).astype(np.float32),
        r_avg=np.linspace(50, 70, B).astype(np.float32),
        think_ms=np.full(B, 1000.0, np.float32),
        slots_cap=np.array([1, 3, 5, 2, 4, 1, 6, 8], np.int32),
        seed=(1000 * np.arange(B)).astype(np.int32), n_events_active=nea)
    smp = (MS, RS) if replay else (None, None)
    return lanes, smp, dict(h_users=H, max_slots=8, n_events=budget,
                            warmup_jobs=2)


def _ref_tables(lanes, smp, st):
    ms, rs = (None, None) if smp[0] is None else map(jnp.asarray, smp)
    fn = lambda tm, sd, ne: ref_kernel.event_streams(
        None, None, tm, sd, ne, h_users=st["h_users"],
        n_events=st["n_events"], m_samples=ms, r_samples=rs)
    return jax.vmap(fn)(jnp.asarray(lanes["think_ms"]),
                        jnp.asarray(lanes["seed"]),
                        jnp.asarray(lanes["n_events_active"]))


@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("H,n_reduce", [(1, 2), (3, 2), (5, 0)])
def test_plain_loop_bit_exact_vs_pallas_on_reference_tables(replay, H,
                                                            n_reduce):
    lanes, smp, st = _lanes(H, replay, n_reduce)
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    ms, rs = (None, None) if smp[0] is None else map(jnp.asarray, smp)
    want_m, want_c = ref_kernel.qn_event_fwd(
        jl["n_map"], jl["n_reduce"], jl["m_avg"], jl["r_avg"],
        jl["think_ms"], jl["slots_cap"], jl["seed"],
        jl["n_events_active"], ms, rs, **st)
    tables = [torch.tensor(np.asarray(x)) for x in
              _ref_tables(lanes, smp, st)]
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    s, c = qn_ops.qn_event(
        t["n_map"], t["n_reduce"], t["slots_cap"], t["n_events_active"],
        t["m_avg"], t["r_avg"], t["think_ms"], *tables,
        max_slots=st["max_slots"], warmup_jobs=st["warmup_jobs"],
        replay=replay)
    mean = s / torch.clamp(c, min=1.0)
    assert np.array_equal(np.asarray(want_c), c.numpy())
    assert np.array_equal(np.asarray(want_m), mean.numpy())
    assert c[0] == 0 and c[4] == 0                  # padding lanes
    # without reduce tasks a job never finishes, in both packages
    assert bool((c[[1, 3, 7]] > 0).all()) == (n_reduce > 0)


@pytest.mark.parametrize("replay", [False, True])
def test_event_streams_match_reference(replay):
    lanes, smp, st = _lanes(4, replay)
    want = [np.asarray(x) for x in _ref_tables(lanes, smp, st)]
    ms, rs = (None, None) if smp[0] is None else map(torch.tensor, smp)
    got = qn_ops.event_streams(
        torch.tensor(lanes["think_ms"]), torch.tensor(lanes["seed"]),
        torch.tensor(lanes["n_events_active"]), h_users=st["h_users"],
        n_events=st["n_events"], m_samples=ms, r_samples=rs)
    for w, g in zip(want, got):
        g = g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype
        ulps = np.abs(w.view(np.int32).astype(np.int64)
                      - g.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1
    if replay:                   # service draws are randint gathers: exact
        assert np.array_equal(want[1], got[1].numpy())
        assert np.array_equal(want[2], got[2].numpy())


@pytest.mark.parametrize("replay", [False, True])
def test_event_streams_match_reference_at_2049_users(replay):
    """As above at 2049 users.  The unit draws agree within one ulp and
    the randint gathers exactly; the initial think clocks are a unit draw
    times think_ms, rounded once, so a draw one ulp off can land two ulps
    off after the product: measured here (torch 2.13 CPU, JAX 0.9.0), 1190
    of the 16392 think clocks differ, 35 of them by two ulps."""
    lanes, smp, st = _lanes(2049, replay)
    want = [np.asarray(x) for x in _ref_tables(lanes, smp, st)]
    ms, rs = (None, None) if smp[0] is None else map(torch.tensor, smp)
    got = qn_ops.event_streams(
        torch.tensor(lanes["think_ms"]), torch.tensor(lanes["seed"]),
        torch.tensor(lanes["n_events_active"]), h_users=st["h_users"],
        n_events=st["n_events"], m_samples=ms, r_samples=rs)
    for k, (w, g) in enumerate(zip(want, got)):
        g = g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype
        ulps = np.abs(w.view(np.int32).astype(np.int64)
                      - g.view(np.int32).astype(np.int64))
        assert ulps.max() <= (2 if k == 0 else 1)
    if replay:
        assert np.array_equal(want[1], got[1].numpy())
        assert np.array_equal(want[2], got[2].numpy())


@pytest.mark.parametrize("replay", [False, True])
def test_plain_loop_bit_exact_vs_pallas_at_2049_users(replay):
    """More than 2048 users (the size at which the card's kernel once
    raised): the plain loop on the reference's tables against the Pallas
    kernel (interpret mode), bit for bit.  Thinks of 100 s against
    services of ~50 ms let jobs finish within the small budget."""
    H, E = 2049, 256
    lanes, smp, st = _lanes(H, replay)
    lanes["think_ms"] = np.full(len(lanes["think_ms"]), 1e5, np.float32)
    lanes["n_events_active"] = np.minimum(lanes["n_events_active"], E)
    st = {**st, "n_events": E}
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    ms, rs = (None, None) if smp[0] is None else map(jnp.asarray, smp)
    want_m, want_c = ref_kernel.qn_event_fwd(
        jl["n_map"], jl["n_reduce"], jl["m_avg"], jl["r_avg"],
        jl["think_ms"], jl["slots_cap"], jl["seed"],
        jl["n_events_active"], ms, rs, **st)
    tables = [torch.tensor(np.asarray(x)) for x in
              _ref_tables(lanes, smp, st)]
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    s, c = qn_ops.qn_event(
        t["n_map"], t["n_reduce"], t["slots_cap"], t["n_events_active"],
        t["m_avg"], t["r_avg"], t["think_ms"], *tables,
        max_slots=st["max_slots"], warmup_jobs=st["warmup_jobs"],
        replay=replay)
    mean = s / torch.clamp(c, min=1.0)
    assert np.array_equal(np.asarray(want_c), c.numpy())
    assert np.array_equal(np.asarray(want_m), mean.numpy())
    assert bool((c[[1, 3, 7]] > 0).all()) and c[0] == 0 and c[4] == 0


@pytest.mark.parametrize("replay", [False, True])
def test_plain_loop_bit_exact_vs_pallas_at_wide_lanes(replay):
    """The lanes the card's ``qn_event_wide`` takes (at most 32 users past
    512 slots, here cost_deadline's 20 users in a batch of 8192 slots): the
    plain loop on the reference's tables against the Pallas kernel
    (interpret mode), bit for bit.  Caps from 1 to 8192; maps of 200 and
    500 with short thinks back the queue up on the small caps, long thinks
    let the large caps' jobs finish within the budget; the last lane
    pads."""
    E, H = 2048, 20
    caps = np.array([8000, 600, 1, 17, 8192, 2000, 300, 5000], np.int32)
    B = len(caps)
    g = np.random.default_rng(21)
    lanes = dict(
        n_map=np.array([500, 500, 500, 200, 64, 120, 500, 16], np.int32),
        n_reduce=np.array([1, 8, 1, 1, 16, 4, 2, 1], np.int32),
        m_avg=g.uniform(20, 60, B).astype(np.float32),
        r_avg=g.uniform(10, 30, B).astype(np.float32),
        think_ms=np.array([1e5, 1e5, 500, 500, 300, 1e4, 1e5, 200],
                          np.float32),
        slots_cap=caps, seed=(1000 * np.arange(B) + 1).astype(np.int32),
        n_events_active=np.array([E] * 5 + [E // 2, E, 0], np.int32))
    smp = ((20.0 * g.integers(1, 4, 29)).astype(np.float32),
           (10.0 * g.integers(1, 3, 7)).astype(np.float32)) if replay \
        else (None, None)
    st = dict(h_users=H, max_slots=8192, n_events=E, warmup_jobs=1)
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    ms, rs = (None, None) if smp[0] is None else map(jnp.asarray, smp)
    want_m, want_c = ref_kernel.qn_event_fwd(
        jl["n_map"], jl["n_reduce"], jl["m_avg"], jl["r_avg"],
        jl["think_ms"], jl["slots_cap"], jl["seed"],
        jl["n_events_active"], ms, rs, **st)
    tables = [torch.tensor(np.asarray(x)) for x in
              _ref_tables(lanes, smp, st)]
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    s, c = qn_ops.qn_event(
        t["n_map"], t["n_reduce"], t["slots_cap"], t["n_events_active"],
        t["m_avg"], t["r_avg"], t["think_ms"], *tables,
        max_slots=st["max_slots"], warmup_jobs=st["warmup_jobs"],
        replay=replay)
    mean = s / torch.clamp(c, min=1.0)
    assert np.array_equal(np.asarray(want_c), c.numpy())
    assert np.array_equal(np.asarray(want_m), mean.numpy())
    assert bool((c[:7] > 0).all()) and c[7] == 0


@pytest.mark.parametrize("replay", [False, True])
def test_plain_lanes_do_not_depend_on_batch_slots_or_padding(replay):
    """What chip_smoke.py's shared plain runs (``plain_in_one_run``) rely
    on: a lane's result is the same bits alone, beside another check's
    lanes, in a batch of more slots than its cap, and with its draw tables
    padded past its own event budget."""
    def check(caps, nea, seed0):
        B = len(caps)
        g = np.random.default_rng(seed0)
        t = dict(
            n_map=torch.full((B,), 8, dtype=torch.int32),
            n_reduce=torch.full((B,), 2, dtype=torch.int32),
            slots_cap=torch.tensor(caps, dtype=torch.int32),
            n_events_active=torch.tensor(nea, dtype=torch.int32),
            m_avg=torch.tensor(g.uniform(30, 50, B), dtype=torch.float32),
            r_avg=torch.tensor(g.uniform(50, 70, B), dtype=torch.float32),
            think_ms=torch.tensor(g.uniform(200, 900, B),
                                  dtype=torch.float32))
        smp = (torch.tensor(MS), torch.tensor(RS)) if replay else (None,
                                                                    None)
        tables = qn_ops.event_streams(
            t["think_ms"], torch.arange(B) * 1000 + seed0,
            t["n_events_active"], h_users=3, n_events=max(nea),
            m_samples=smp[0], r_samples=smp[1])
        return (t["n_map"], t["n_reduce"], t["slots_cap"],
                t["n_events_active"], t["m_avg"], t["r_avg"],
                t["think_ms"], *tables)

    kw = dict(warmup_jobs=2, replay=replay)
    a = check([1, 3, 8, 5], [600, 600, 300, 600], 1)
    b = check([20, 7, 32], [1200, 900, 1200], 2)
    want_a = qn_ops.qn_event(*a, max_slots=8, **kw)
    want_b = qn_ops.qn_event(*b, max_slots=32, **kw)
    pad = 1200 - a[8].shape[1]
    both = [torch.cat([torch.nn.functional.pad(x, (0, pad)) if j > 7 else x,
                       y]) for j, (x, y) in enumerate(zip(a, b))]
    got_s, got_c = qn_ops.qn_event(*both, max_slots=32, **kw)
    for got, want in ((got_s[:4], want_a[0]), (got_c[:4], want_a[1]),
                      (got_s[4:], want_b[0]), (got_c[4:], want_b[1])):
        assert torch.equal(got, want)
    assert bool((want_a[1] > 0).all()) and bool((want_b[1] > 0).all())


def test_event_streams_on_cpu_launches_no_kernel():
    lanes, smp, st = _lanes(3, True)
    before = qn_ops.event_streams.launches
    got = qn_ops.event_streams(
        torch.tensor(lanes["think_ms"]), torch.tensor(lanes["seed"]),
        torch.tensor(lanes["n_events_active"]), h_users=3,
        n_events=st["n_events"], m_samples=torch.tensor(MS),
        r_samples=torch.tensor(RS))
    assert qn_ops.event_streams.launches == before
    assert all(x.device.type == "cpu" for x in got)
    meta = torch.tensor(lanes["seed"]).to("meta")
    with pytest.raises(ValueError):
        qn_ops.event_streams(torch.tensor(lanes["think_ms"]), meta,
                             torch.tensor(lanes["n_events_active"]),
                             h_users=3, n_events=8)


def _accounting_delta(mod, fn):
    s0, p0 = mod.sim_stats(), mod.padding_stats()
    out = fn()
    s1, p1 = mod.sim_stats(), mod.padding_stats()
    return out, ({k: s1[k] - s0[k] for k in s1},
                 {k: p1[k] - p0[k] for k in p1})


CASES = [
    dict(slots=[1], h_users=1),
    dict(slots=[2, 3, 5], h_users=3),                       # 3 -> 3 lanes
    dict(slots=[1, 2, 3, 4, 6, 9, 17], h_users=4),          # 7 -> 8 lanes
    dict(slots=[3, 7], h_users=2, m_samples=MS, r_samples=RS),
    dict(slots=[2, 9], h_users=3, seed=7, replications=3),
    dict(slots=[4, 5, 11], h_users=2, n_map=[3, 16, 8],
         n_reduce=[1, 4, 2], min_jobs=6, warmup_jobs=1),    # mixed budgets
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_response_time_batch_end_to_end(case):
    kw = {**BASE, **FAST, **CASES[case]}
    want, ref_acc = _accounting_delta(
        ref_qn_sim, lambda: ref_qn_sim.response_time_batch(impl="jnp", **kw))
    got, acc = _accounting_delta(
        qn_sim, lambda: qn_sim.response_time_batch(device="cpu", **kw))
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)
    assert acc == ref_acc


def test_deferred_batches_resolve_in_one_read():
    kw = {**BASE, **FAST, "h_users": 2}
    a = qn_sim.response_time_batch(slots=[2, 3], device="cpu", defer=True,
                                   **kw)
    b = qn_sim.response_time_batch(slots=[4], device="cpu", defer=True, **kw)
    ra, rb = qn_sim.resolve_batches([a, b, qn_sim.PendingBatch.resolved(
        [1.0])])[:2]
    assert np.array_equal(ra, qn_sim.response_time_batch(
        slots=[2, 3], device="cpu", **kw))
    assert np.array_equal(rb, b.resolve())


def test_padded_event_budget_matches_reference():
    for nm, nr in ((1, 1), (8, 2), (500, 1), (400, 64)):
        for mj, wj in ((40, 8), (8, 2), (20, 8)):
            assert qn_sim.padded_event_budget(nm, nr, min_jobs=mj,
                                              warmup_jobs=wj) == \
                ref_qn_sim.padded_event_budget(nm, nr, min_jobs=mj,
                                               warmup_jobs=wj)


def test_wrapper_takes_the_plain_version_only_on_cpu():
    lanes, smp, st = _lanes(2, False)
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    tables = qn_ops.event_streams(t["think_ms"], t["seed"],
                                  t["n_events_active"], h_users=2,
                                  n_events=st["n_events"])
    args = (t["n_map"], t["n_reduce"], t["slots_cap"], t["n_events_active"],
            t["m_avg"], t["r_avg"], t["think_ms"], *tables)
    before = qn_ops.qn_event.launches
    qn_ops.qn_event(*args, max_slots=8, warmup_jobs=2, replay=False)
    assert qn_ops.qn_event.launches == before
    meta = tuple(x.to("meta") for x in args)
    with pytest.raises(ValueError):
        qn_ops.qn_event(*meta, max_slots=8, warmup_jobs=2, replay=False)
    with pytest.raises(ValueError):            # counts must be int32
        qn_ops.qn_event(t["n_map"].long(), *args[1:], max_slots=8,
                        warmup_jobs=2, replay=False)
