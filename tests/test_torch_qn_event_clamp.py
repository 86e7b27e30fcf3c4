"""The slot cut of ``core/qn_sim.py`` (``slots_in_use``): a lane's slots
cut to ``max(1, h_users * max(n_map, n_reduce))`` give the same bits.

A user has at most ``max(n_map, n_reduce)`` tasks in flight and a
dispatch takes the first free slot, so no slot at or past that many
users' tasks is ever used.  Held here on the CPU:

1. The plain event loop (``kernels/qn_event/ref.py``) on lanes cut to
   their slots in use against the same lanes uncut (caps up to 3x the
   cut, in a bucket of the uncut caps), bit for bit: 33 to 2048 users
   (the lanes the card's ``qn_event_many`` takes), maps and reduces 1/1,
   2/3 and 5/1, thinks that saturate the slots and thinks that leave them
   idle, both modes.
2. A lane of 64 users cut to 64 slots, on the reference's own draw
   tables, against the reference's Pallas kernel in interpret mode on the
   uncut lane (768 slots), bit for bit.
3. ``response_time_batch`` and the scalar ``simulate``: the cut changes
   no bit of the results (against a run with the cut replaced by the
   identity) and no count of ``sim_stats()`` / ``padding_stats()``, which
   equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qn_sim as ref_qn_sim
from repro.kernels.qn_event import kernel as ref_kernel
from repro_torch.core import qn_sim, shapes
from repro_torch.kernels.qn_event import ref as qn_ref

torch.set_num_threads(1)    # the plain loop is many tiny ops

MS = np.array([30.0, 45.0, 55.0, 38.0, 61.0], np.float32)
RS = np.array([80.0, 95.0, 70.0], np.float32)
# (n_map, n_reduce) of the three lanes of each case
TASKS = ((1, 1), (2, 3), (5, 1))
# think times [ms] against services of 30-95 ms: every user busy at once,
# or a few users at a time
THINKS = {"saturated": 1.0, "idle": 2e4}


def _uncut(H, replay, think, E=512):
    """Three lanes of H users, one per TASKS entry, with caps past their
    slots in use; their tables from the plain draw-table version."""
    B = len(TASKS)
    nm = np.array([m for m, _ in TASKS], np.int32)
    nr = np.array([r for _, r in TASKS], np.int32)
    use = H * np.maximum(nm, nr)
    caps = np.array([use[0] + 1, 2 * use[1] + 7, 3 * use[2]], np.int32)
    g = np.random.default_rng(H + 2 * replay)
    lanes = dict(
        n_map=torch.tensor(nm), n_reduce=torch.tensor(nr),
        slots_cap=torch.tensor(caps),
        n_events_active=torch.tensor(np.array([E, E, E - 5], np.int32)),
        m_avg=torch.tensor(g.uniform(30, 60, B).astype(np.float32)),
        r_avg=torch.tensor(g.uniform(40, 90, B).astype(np.float32)),
        think_ms=torch.tensor(np.full(B, THINKS[think], np.float32)))
    smp = (torch.tensor(MS), torch.tensor(RS)) if replay else (None, None)
    tables = qn_ref.event_streams(
        lanes["think_ms"], torch.tensor([1, 1001, 2001]),
        lanes["n_events_active"], h_users=H, n_events=E,
        m_samples=smp[0], r_samples=smp[1])
    return lanes, tables


def _run(lanes, tables, caps, replay):
    return qn_ref.qn_event(
        lanes["n_map"], lanes["n_reduce"], caps, lanes["n_events_active"],
        lanes["m_avg"], lanes["r_avg"], lanes["think_ms"], *tables,
        max_slots=shapes.bucket_slots(int(caps.max())), warmup_jobs=2,
        replay=replay)


@pytest.mark.parametrize("think", sorted(THINKS))
@pytest.mark.parametrize("replay", [False, True])
@pytest.mark.parametrize("H", [33, 64, 256, 2048])
def test_plain_loop_bit_identical_on_lanes_cut_to_their_slots_in_use(
        H, replay, think):
    lanes, tables = _uncut(H, replay, think)
    caps = lanes["slots_cap"]
    cut = torch.tensor(qn_sim.slots_in_use(
        caps.numpy(), H, lanes["n_map"].numpy(), lanes["n_reduce"].numpy()),
        dtype=torch.int32)
    assert torch.equal(cut, H * torch.maximum(lanes["n_map"],
                                              lanes["n_reduce"]))
    ks, kc = _run(lanes, tables, cut, replay)
    ps, pc = _run(lanes, tables, caps, replay)
    assert torch.equal(ks, ps) and torch.equal(kc, pc)
    if think == "saturated" and H <= 64:
        # the one-map lane's busy slots reach the cut (every user holds its
        # task) and its jobs finish past the warm-up
        assert kc[0] > 0


def test_slots_in_use_at_its_edges():
    assert qn_sim.slots_in_use(768, 64, 1, 1) == 64
    assert qn_sim.slots_in_use(336, 2048, 1, 1) == 336
    assert qn_sim.slots_in_use(5, 3, 0, 0) == 1           # no task: 1 slot
    assert qn_sim.slots_in_use(8000, 10, 500, 1) == 5000
    assert qn_sim.slots_in_use(0, 10, 500, 1) == 0
    got = qn_sim.slots_in_use(np.array([9, 40, 7]), 4, np.array([1, 5, 2]),
                              np.array([2, 1, 3]))
    assert got.tolist() == [8, 20, 7]


def _ref_tables(lanes, smp, st):
    ms, rs = (None, None) if smp[0] is None else map(jnp.asarray, smp)
    fn = lambda tm, sd, ne: ref_kernel.event_streams(
        None, None, tm, sd, ne, h_users=st["h_users"],
        n_events=st["n_events"], m_samples=ms, r_samples=rs)
    return jax.vmap(fn)(jnp.asarray(lanes["think_ms"]),
                        jnp.asarray(lanes["seed"]),
                        jnp.asarray(lanes["n_events_active"]))


@pytest.mark.parametrize("replay", [False, True])
def test_cut_lane_bit_exact_vs_pallas_on_the_uncut_lane(replay):
    """chat-granite's shape (64 users, one map and one reduce, 768 slots)
    cut to 64 slots in the port's plain loop, against the reference's
    Pallas kernel (interpret mode) on the uncut 768, on the reference's
    tables; short thinks keep every user's task in a slot."""
    H, E, S = 64, 256, 768
    B = 3
    lanes = dict(n_map=np.ones(B, np.int32), n_reduce=np.ones(B, np.int32),
                 m_avg=np.array([40.0, 55.0, 35.0], np.float32),
                 r_avg=np.array([60.0, 45.0, 70.0], np.float32),
                 think_ms=np.array([5.0, 50.0, 500.0], np.float32),
                 slots_cap=np.array([S, S, 70], np.int32),
                 seed=np.array([3, 1003, 2003], np.int32),
                 n_events_active=np.array([E, E, E - 9], np.int32))
    smp = (MS, RS) if replay else (None, None)
    st = dict(h_users=H, max_slots=S, n_events=E, warmup_jobs=2)
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    ms, rs = (None, None) if smp[0] is None else map(jnp.asarray, smp)
    want_m, want_c = ref_kernel.qn_event_fwd(
        jl["n_map"], jl["n_reduce"], jl["m_avg"], jl["r_avg"],
        jl["think_ms"], jl["slots_cap"], jl["seed"],
        jl["n_events_active"], ms, rs, **st)
    tables = [torch.tensor(np.asarray(x)) for x in
              _ref_tables(lanes, smp, st)]
    t = {k: torch.tensor(v) for k, v in lanes.items()}
    cut = torch.tensor(qn_sim.slots_in_use(lanes["slots_cap"], H, 1, 1),
                       dtype=torch.int32)
    assert cut.tolist() == [64, 64, 64]
    s, c = qn_ref.qn_event(
        t["n_map"], t["n_reduce"], cut, t["n_events_active"], t["m_avg"],
        t["r_avg"], t["think_ms"], *tables,
        max_slots=shapes.bucket_slots(64), warmup_jobs=2, replay=replay)
    mean = s / torch.clamp(c, min=1.0)
    assert np.array_equal(np.asarray(want_c), c.numpy())
    assert np.array_equal(np.asarray(want_m), mean.numpy())
    assert c.sum() > 0


def _accounting_delta(mod, fn):
    s0, p0 = mod.sim_stats(), mod.padding_stats()
    out = fn()
    s1, p1 = mod.sim_stats(), mod.padding_stats()
    return out, ({k: s1[k] - s0[k] for k in s1},
                 {k: p1[k] - p0[k] for k in p1})


BATCH = dict(n_map=[1, 2, 1], n_reduce=[1, 3, 1], m_avg=40.0, r_avg=60.0,
             think_ms=[20.0, 200.0, 5.0], slots=[768, 500, 40], h_users=40,
             min_jobs=6, warmup_jobs=1, replications=2, seed=0)


@pytest.mark.parametrize("replay", [False, True])
def test_response_time_batch_cut_keeps_bits_and_counts(replay, monkeypatch):
    kw = dict(BATCH, **({"m_samples": MS, "r_samples": RS} if replay
                        else {}))
    cut, acc = _accounting_delta(
        qn_sim, lambda: qn_sim.response_time_batch(device="cpu", **kw))
    _, ref_acc = _accounting_delta(
        ref_qn_sim, lambda: ref_qn_sim.response_time_batch(impl="jnp", **kw))
    monkeypatch.setattr(qn_sim, "slots_in_use", lambda slots, *a: slots)
    uncut, acc_uncut = _accounting_delta(
        qn_sim, lambda: qn_sim.response_time_batch(device="cpu", **kw))
    assert np.array_equal(cut, uncut) and np.isfinite(cut).any()
    assert acc == acc_uncut == ref_acc


def test_scalar_simulate_cut_keeps_bits(monkeypatch):
    p = qn_sim.QNParams(n_map=2, n_reduce=1, m_avg=40.0, r_avg=60.0,
                        think_ms=30.0, h_users=33, slots=1000, n_events=400,
                        warmup_jobs=2)
    cut, acc = _accounting_delta(
        qn_sim, lambda: qn_sim.simulate(p, replications=2, device="cpu"))
    monkeypatch.setattr(qn_sim, "slots_in_use", lambda slots, *a: slots)
    uncut, acc_uncut = _accounting_delta(
        qn_sim, lambda: qn_sim.simulate(p, replications=2, device="cpu"))
    assert cut == uncut and cut[1] > 0
    assert acc == acc_uncut
