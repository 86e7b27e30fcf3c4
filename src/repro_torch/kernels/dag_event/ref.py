"""Plain PyTorch versions of the ``dag_event`` kernel and of its draw
tables (``csrc/dag_streams.cu``).

``dag_streams`` draws the tables with ``repro_torch.rng`` in eager torch
ops, on the device of its inputs.  ``dag_event`` runs the same K-stage
event loop as ``csrc/dag_event.cu`` and the reference's ``_dag_sim``
(``src/repro/core/dag.py``, a ``lax.scan``), vectorized over lanes and
written as one masked step per event: every state array takes a single
guarded scatter per step (branch-selected index and value, unchanged when
no branch fires).  Ties in every selection go to the smaller index.  The
two multiply-adds that the reference's XLA program contracts are
single-rounding here too (``kernels.fma.fma32``).  One Python iteration
per event: this is the CPU path of the tests and the card's yardstick, not
a fast path.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.kernels.fma import fma32

INF = 1e30


def dag_streams(think_ms, seed, n_events_active, *, h_users: int,
                n_events: int, n_samples: int = None):
    """Per-lane tables on the device of ``seed``: the initial think clocks
    ``(B, H)``, the per-event service draw ``(B, E)`` and the per-event
    think draw ``(B, E)``, drawn as the reference's ``_dag_sim`` draws
    them (``src/repro/core/dag.py:91-131``):

      * ``k0, key = split(key(seed))``: the second half is the fold key
        (the MapReduce simulator discards it);
      * init:    ``exponential(k0, (H,)) * think_ms``;
      * event i: ``key_i = fold_in(key, i)`` gives, in replay mode
        (``n_samples`` given), one ``randint(key_i, (), 0, n_samples)``:
        an int32 sample index, gathered in the loop by the user's current
        stage; otherwise one unit exponential (float32), scaled by the
        stage mean in the loop;
      * think:   ``exponential(fold_in(key, i + n_events_active))``.
    """
    ks = rng.split(rng.key(seed))                             # (B, 2, 2)
    k0, kf = ks[:, 0], ks[:, 1]
    think0 = rng.exponential(k0, (h_users,)) * think_ms[:, None]
    idx = torch.arange(n_events, dtype=torch.int64, device=kf.device)
    key_i = rng.fold_in(kf[:, None, :], idx[None, :])         # (B, E, 2)
    if n_samples is not None:
        st = rng.randint(key_i, (), 0, n_samples).to(torch.int32)
    else:
        st = rng.exponential(key_i)
    del key_i
    kq = rng.fold_in(kf[:, None, :],
                     idx[None, :] + n_events_active.to(torch.int64)[:, None])
    return think0, st, rng.exponential(kq)


def dag_event(n_tasks, t_avg, n_stages, slots_cap, n_events_active,
              think_ms, think0, st, td, samples=None, *, max_slots: int,
              warmup_jobs: int):
    """Run every lane's K-stage event loop.  ``n_tasks``/``t_avg`` are the
    ``(B, K)`` stage arrays (int32, float32) padded past each lane's
    ``n_stages``; the other per-lane parameters are ``(B,)``; ``think0`` is
    ``(B, H)`` and the draw tables ``(B, E)``.  With ``samples`` (float32
    ``(K_s, NS)``, shared) the batch replays them and ``st`` holds int32
    sample indices; otherwise ``st`` holds unit exponentials.  Returns
    ``(resp_sum, resp_cnt)``, float32 ``(B,)``."""
    B, H = think0.shape
    E = st.shape[1]
    dev = think0.device
    f32, i64 = torch.float32, torch.int64
    inf = torch.tensor(INF, dtype=f32, device=dev)
    rows = torch.arange(B, device=dev)
    nt = n_tasks.to(i64)
    ns = n_stages.to(i64)
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

    # the reference's stage index clip(ph - 1, 0, n_stages - 1); each
    # gather clamps it to the rows its array has (the stage arrays' K, the
    # replay lists' K_s), as the reference's gathers clamp
    K = nt.shape[1]

    def stage_of(ph):
        return torch.minimum((ph - 1).clamp(min=0), ns - 1).clamp(min=0)

    steps = min(E, int(nea.max())) if B else 0   # later steps are no-ops
    for i in range(steps):
        st_i, td_i = st[:, i], td[:, i]
        # ---- choose the event: the first free slot; the deepest queued
        # stage, its earliest arrival, the first user
        free = (slot_user < 0) & slot_enabled
        slot = free.to(torch.uint8).argmax(1)
        queued = pending > 0
        b_dispatch = free.any(1) & queued.any(1)
        depth = torch.where(queued, phase, -1).max(1).values
        cand = queued & (phase == depth[:, None])
        u = torch.where(cand, arrival, inf).argmin(1)
        stage = stage_of(at(phase, u))
        if samples is not None:
            row = stage.clamp(max=samples.shape[0] - 1)
            se_new = now + samples[row, st_i.to(i64)]
        else:
            se_new = fma32(st_i, at(t_avg, stage.clamp(max=K - 1)), now)
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
        last_stage = phase_cu >= ns
        advance = stage_done & ~last_stage
        job_done = stage_done & last_stage
        nxt = phase_cu + 1
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
            torch.where(b_complete,
                        torch.where(advance,
                                    at(nt, stage_of(nxt).clamp(max=K - 1)),
                                    pend_cu),
                        nt[:, 0])),
            at(pending, uidx))
        inflight[rows, uidx] = torch.where(
            b_dispatch | b_complete,
            torch.where(b_dispatch, at(inflight, u) + 1, infl_cu),
            at(inflight, uidx))
        phase[rows, uidx] = torch.where(do_ct, torch.where(
            b_complete, torch.where(job_done, 0, torch.where(
                advance, nxt, phase_cu)), 1), at(phase, uidx))
        arrival[rows, uidx] = torch.where(do_ct, torch.where(
            b_complete, torch.where(advance, t_slot, torch.where(
                job_done, inf, at(arrival, cu))), t_think),
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
