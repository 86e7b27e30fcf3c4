"""Plain PyTorch versions of the ``qn_event`` kernel and of its draw
tables (``csrc/qn_streams.cu``).

``event_streams`` draws the tables with ``repro_torch.rng`` in eager torch
ops, on the device of its inputs.  ``qn_event`` runs the same event loop
as ``csrc/qn_event.cu`` (and the reference's ``_event_kernel``),
vectorized over lanes and written as one masked step per event: every
state array takes a single guarded scatter per step (branch-selected
index and value, unchanged when no branch fires).  Ties in every
selection go to the smaller index (``argmin``/``argmax`` and ``min(dim)``
return the first extremum).  The two multiply-adds that the reference's
XLA program contracts are single-rounding here too (``kernels.fma.fma32``).
One Python iteration per event: this is the CPU path of the tests and the
card's yardstick, not a fast path.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.kernels.fma import fma32

INF = 1e30


def event_streams(think_ms, seed, n_events_active, *, h_users: int,
                  n_events: int, m_samples=None, r_samples=None):
    """Per-lane tables: initial think clocks ``(B, H)`` and per-event
    service and think draws ``(B, E)``, on the device of ``seed``: the
    counterpart of the reference's ``kernels/qn_event/kernel.py:
    event_streams`` (and ``qn_sim._rng_tables``), with the same keys, fold
    offsets and draw order.

      * init:    ``k0, _ = split(key)``; ``exponential(k0, (H,)) * think_ms``;
      * event i: ``key_i = fold_in(key, i)`` gives one unit exponential
        (returned unscaled: the multiply by the mean stays in the kernel,
        next to the add it is fused with), or in replay mode two ``randint``
        draws from ``key_i`` into the shared sample lists;
      * think:   ``fold_in(key, i + n_events_active)``, one unit exponential
        (the logical budget is the fold offset).
    """
    key = rng.key(seed)                                       # (B, 2)
    k0 = rng.split(key)[:, 0]
    think0 = rng.exponential(k0, (h_users,)) * think_ms[:, None]
    idx = torch.arange(n_events, dtype=torch.int64, device=key.device)
    key_i = rng.fold_in(key[:, None, :], idx[None, :])        # (B, E, 2)
    if m_samples is not None:
        words = rng.randint_words(key_i)
        st_m = m_samples[rng.randint(key_i, (), 0, m_samples.shape[0],
                                     words=words)]
        st_r = r_samples[rng.randint(key_i, (), 0, r_samples.shape[0],
                                     words=words)]
    else:
        st_m = st_r = rng.exponential(key_i)
    del key_i
    kq = rng.fold_in(key[:, None, :],
                     idx[None, :] + n_events_active.to(torch.int64)[:, None])
    return think0, st_m, st_r, rng.exponential(kq)


def qn_event(n_map, n_reduce, slots_cap, n_events_active, m_avg, r_avg,
             think_ms, think0, st_m, st_r, td, *, max_slots: int,
             warmup_jobs: int, replay: bool):
    """Run every lane's event loop.  Per-lane parameters are ``(B,)``
    (int32 counts, float32 times), ``think0`` is ``(B, H)`` and the draw
    tables ``(B, E)``.  Returns ``(resp_sum, resp_cnt)``, float32 ``(B,)``."""
    B, H = think0.shape
    E = st_m.shape[1]
    dev = think0.device
    f32, i64 = torch.float32, torch.int64
    inf = torch.tensor(INF, dtype=f32, device=dev)
    rows = torch.arange(B, device=dev)
    nm, nr = n_map.to(i64), n_reduce.to(i64)
    nea = n_events_active.to(i64)
    slot_enabled = (torch.arange(max_slots, device=dev)[None, :]
                    < slots_cap.to(i64)[:, None])

    now = torch.zeros(B, dtype=f32, device=dev)
    slot_end = torch.full((B, max_slots), INF, dtype=f32, device=dev)
    slot_user = torch.full((B, max_slots), -1, dtype=i64, device=dev)
    think_end = think0.clone()
    phase = torch.zeros((B, H), dtype=i64, device=dev)
    pending = torch.zeros_like(phase)
    inflight = torch.zeros_like(phase)
    arrival = torch.full((B, H), INF, dtype=f32, device=dev)
    job_start = torch.zeros((B, H), dtype=f32, device=dev)
    resp_sum = torch.zeros(B, dtype=f32, device=dev)
    resp_cnt = torch.zeros(B, dtype=f32, device=dev)
    done_jobs = torch.zeros(B, dtype=i64, device=dev)

    def at(x, idx):
        return x[rows, idx]

    steps = min(E, int(nea.max())) if B else 0   # later steps are no-ops
    for i in range(steps):
        stm_i, str_i, td_i = st_m[:, i], st_r[:, i], td[:, i]
        # ---- choose the event
        free = (slot_user < 0) & slot_enabled
        slot = free.to(torch.uint8).argmax(1)
        queued = pending > 0
        b_dispatch = free.any(1) & queued.any(1)
        red_key = torch.where(queued & (phase == 2), arrival, inf)
        map_key = torch.where(queued & (phase == 1), arrival, inf)
        u = torch.where(red_key.min(1).values < inf, red_key.argmin(1),
                        map_key.argmin(1))
        is_map_u = at(phase, u) == 1
        if replay:
            se_new = now + torch.where(is_map_u, stm_i, str_i)
        else:
            se_new = fma32(stm_i, torch.where(is_map_u, m_avg, r_avg), now)
        t_slot, cslot = slot_end.min(1)
        t_think, tu = think_end.min(1)
        active = i < nea
        b_complete = ~b_dispatch & (t_slot <= t_think) & (t_slot < inf)
        b_think = ~b_dispatch & ~b_complete & (t_think < inf)
        b_dispatch = b_dispatch & active
        b_complete = b_complete & active
        b_think = b_think & active

        # ---- completion bookkeeping (used only where b_complete)
        cu = at(slot_user, cslot).clamp(min=0)
        infl_cu = at(inflight, cu) - 1
        pend_cu = at(pending, cu)
        phase_cu = at(phase, cu)
        stage_done = (pend_cu == 0) & (infl_cu == 0)
        was_map = phase_cu == 1
        fork = stage_done & was_map
        job_done = stage_done & ~was_map
        counted = b_complete & job_done & (done_jobs >= warmup_jobs)

        # ---- guarded scatters: slot arrays
        sidx = torch.where(b_dispatch, slot, cslot)
        do_slot = b_dispatch | b_complete
        slot_end[rows, sidx] = torch.where(
            do_slot, torch.where(b_dispatch, se_new, inf),
            at(slot_end, sidx))
        slot_user[rows, sidx] = torch.where(
            do_slot, torch.where(b_dispatch, u, -1), at(slot_user, sidx))

        # ---- user arrays: dispatch touches u, completion cu, think tu
        uidx = torch.where(b_dispatch, u, torch.where(b_complete, cu, tu))
        do_any = b_dispatch | b_complete | b_think
        do_ct = b_complete | b_think
        pending[rows, uidx] = torch.where(do_any, torch.where(
            b_dispatch, at(pending, u) - 1,
            torch.where(b_complete, torch.where(fork, nr, pend_cu), nm)),
            at(pending, uidx))
        inflight[rows, uidx] = torch.where(
            b_dispatch | b_complete,
            torch.where(b_dispatch, at(inflight, u) + 1, infl_cu),
            at(inflight, uidx))
        phase[rows, uidx] = torch.where(do_ct, torch.where(
            b_complete, torch.where(stage_done, torch.where(was_map, 2, 0),
                                    phase_cu), 1), at(phase, uidx))
        arrival[rows, uidx] = torch.where(do_ct, torch.where(
            b_complete, torch.where(job_done, inf, torch.where(
                fork, t_slot, at(arrival, cu))), t_think),
            at(arrival, uidx))
        think_end[rows, uidx] = torch.where(do_ct, torch.where(
            b_complete, torch.where(job_done, fma32(td_i, think_ms, t_slot),
                                    at(think_end, cu)), inf),
            at(think_end, uidx))
        resp = t_slot - at(job_start, cu)
        job_start[rows, tu] = torch.where(b_think, t_think,
                                          at(job_start, tu))

        now = torch.where(b_complete, t_slot, torch.where(b_think, t_think,
                                                          now))
        resp_sum = resp_sum + torch.where(counted, resp, 0.0)
        resp_cnt = resp_cnt + torch.where(counted, 1.0, 0.0)
        done_jobs = done_jobs + (b_complete & job_done).to(i64)
    return resp_sum, resp_cnt


def sim_batch(n_map, n_reduce, m_avg, r_avg, think_ms, slots_cap, seed,
              n_events_active, m_samples, r_samples, *, h_users: int,
              max_slots: int, n_events: int, warmup_jobs: int):
    """The plain version of ``ops.sim_batch``: the draw tables and the
    event loop above, on the device of the inputs.  Returns ``(mean_resp,
    resp_cnt)`` per lane."""
    think0, st_m, st_r, td = event_streams(
        think_ms, seed, n_events_active, h_users=h_users, n_events=n_events,
        m_samples=m_samples, r_samples=r_samples)
    resp_sum, resp_cnt = qn_event(
        n_map, n_reduce, slots_cap, n_events_active, m_avg, r_avg, think_ms,
        think0, st_m, st_r, td, max_slots=max_slots,
        warmup_jobs=warmup_jobs, replay=m_samples is not None)
    return resp_sum / torch.clamp(resp_cnt, min=1.0), resp_cnt
