"""Wrapper of the fused QN event loop, and its random draw tables.

``event_streams`` draws every lane's random tables with ``repro_torch.rng``
on the device of its inputs: the counterpart of the reference's
``kernels/qn_event/kernel.py:event_streams`` (and ``qn_sim._rng_tables``),
with the same keys, fold offsets and draw order.  ``qn_event`` runs the
event loop: a CUDA tensor launches ``csrc/qn_event.cu``, a CPU tensor
takes the plain version in ``ref.py``; ``qn_event.launches`` counts kernel
launches.  ``sim_batch`` composes the two into the reference's
``_sim_batch_jit`` contract.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.kernels import build
from repro_torch.kernels.qn_event import ref

SMEM_LIMIT = 48 * 1024      # static shared memory a block gets unasked


def event_streams(think_ms, seed, n_events_active, *, h_users: int,
                  n_events: int, m_samples=None, r_samples=None):
    """Per-lane tables: initial think clocks ``(B, H)`` and per-event
    service and think draws ``(B, E)``, on the device of ``seed``.

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


def _check(ints, floats, tables, B, H, E):
    dev = tables[0].device
    for x in ints + floats + tables:
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError("qn_event takes tensors on one device")
    for x in ints:
        if x.shape != (B,) or x.dtype != torch.int32:
            raise ValueError("lane counts must be int32 (B,)")
    for x in floats:
        if x.shape != (B,) or x.dtype != torch.float32:
            raise ValueError("lane parameters must be float32 (B,)")
    if tables[0].shape != (B, H) or tables[0].dtype != torch.float32:
        raise ValueError("think0 must be float32 (B, H)")
    for x in tables[1:]:
        if x.shape != (B, E) or x.dtype != torch.float32:
            raise ValueError("draw tables must be float32 (B, E)")


def qn_event(n_map, n_reduce, slots_cap, n_events_active, m_avg, r_avg,
             think_ms, think0, st_m, st_r, td, *, max_slots: int,
             warmup_jobs: int, replay: bool):
    """Every lane's event loop; returns ``(resp_sum, resp_cnt)``, float32
    ``(B,)``.  Counts are int32 ``(B,)``, times float32 ``(B,)``, ``think0``
    ``(B, H)`` and the draw tables ``(B, E)``, all on one device.
    ``slots_cap`` must not exceed ``max_slots``."""
    ints = (n_map, n_reduce, slots_cap, n_events_active)
    floats = (m_avg, r_avg, think_ms)
    tables = (think0, st_m, st_r, td)
    B, H = think0.shape
    E = st_m.shape[1]
    _check(ints, floats, tables, B, H, E)
    dev = think0.device
    kw = dict(max_slots=max_slots, warmup_jobs=warmup_jobs, replay=replay)
    if dev.type == "cpu":
        return ref.qn_event(*ints, *floats, *tables, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no qn_event kernel for device {dev}")
    args = tuple(x.contiguous() for x in ints + floats + tables)
    resp_sum = torch.empty(B, dtype=torch.float32, device=dev)
    resp_cnt = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return resp_sum, resp_cnt
    scratch = (None, None)
    if 4 * (6 * H + 2 * max_slots) > SMEM_LIMIT:
        scratch = (torch.empty((B, max_slots), dtype=torch.float32,
                               device=dev),
                   torch.empty((B, max_slots), dtype=torch.int32,
                               device=dev))
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qn_event_launch(
            *(x.data_ptr() for x in args), resp_sum.data_ptr(),
            resp_cnt.data_ptr(),
            *(None if s is None else s.data_ptr() for s in scratch),
            B, H, int(max_slots), E, int(warmup_jobs), int(bool(replay)),
            stream)
    build.check(rc, "qn_event")
    build.count(qn_event)
    return resp_sum, resp_cnt


qn_event.launches = 0


def sim_batch(n_map, n_reduce, m_avg, r_avg, think_ms, slots_cap, seed,
              n_events_active, m_samples, r_samples, *, h_users: int,
              max_slots: int, n_events: int, warmup_jobs: int):
    """One fused simulation over a flat lane batch, on the device of its
    tensors: per-lane ``(B,)`` parameters, shared replay lists (or None).
    Returns ``(mean_resp, resp_cnt)`` per lane."""
    think0, st_m, st_r, td = event_streams(
        think_ms, seed, n_events_active, h_users=h_users, n_events=n_events,
        m_samples=m_samples, r_samples=r_samples)
    resp_sum, resp_cnt = qn_event(
        n_map, n_reduce, slots_cap, n_events_active, m_avg, r_avg, think_ms,
        think0, st_m, st_r, td, max_slots=max_slots,
        warmup_jobs=warmup_jobs, replay=m_samples is not None)
    return resp_sum / torch.clamp(resp_cnt, min=1.0), resp_cnt
