"""Wrappers of the fused QN event loop and of its random draw tables.

``event_streams`` draws every lane's tables: a CUDA tensor launches
``csrc/qn_streams.cu`` (bit-identical to the plain version), a CPU tensor
takes the plain version in ``ref.py`` (eager ``repro_torch.rng``, the
counterpart of the reference's ``kernels/qn_event/kernel.py:
event_streams``).  ``qn_event`` runs the event loop: a CUDA tensor
launches ``csrc/qn_event.cu``, a CPU tensor takes ``ref.qn_event``.  Each
wrapper's ``launches`` counts its kernel launches, and ``qn_event.routes``
the launches of each of its four kernels, as the library reports the one
it ran.  A build or launch failure raises; a CUDA tensor never takes the
plain version.
``sim_batch`` composes the two into the reference's ``_sim_batch_jit``
contract.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.qn_event import ref


def event_streams(think_ms, seed, n_events_active, *, h_users: int,
                  n_events: int, m_samples=None, r_samples=None):
    """Per-lane tables on the device of ``seed``: ``(think0, st_m, st_r,
    td)``, float32 ``(B, H)`` and three ``(B, E)`` (in exponential mode
    ``st_r`` is ``st_m``), drawn as ``ref.event_streams`` documents from
    int64 seeds ``(B,)``, per-lane budgets ``n_events_active`` and think
    times ``think_ms`` ``(B,)``, and in replay mode the shared float32
    sample lists.  On the card the seeds are taken modulo 2**32 as the
    plain version's keys take them; the plain version also raises on a
    seed outside int32, which the kernel path does not check (it would
    wait for the device)."""
    dev = seed.device
    if dev.type == "cpu":
        return ref.event_streams(think_ms, seed, n_events_active,
                                 h_users=h_users, n_events=n_events,
                                 m_samples=m_samples, r_samples=r_samples)
    if dev.type != "cuda":
        raise ValueError(f"no event_streams kernel for device {dev}")
    replay = m_samples is not None
    lists = (m_samples, r_samples) if replay else ()
    B = seed.shape[0] if seed.dim() == 1 else -1
    for x in (think_ms, n_events_active, *lists):
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError("event_streams takes tensors on one device")
    if B < 0 or think_ms.shape != (B,) or n_events_active.shape != (B,) \
            or any(x.dim() != 1 for x in lists):
        raise ValueError("seeds, budgets and think times must be (B,), "
                         "sample lists 1-D")
    H, E = int(h_users), int(n_events)
    f32 = dict(dtype=torch.float32, device=dev)
    seed = seed.to(torch.int64).contiguous()
    nea = n_events_active.to(torch.int32).contiguous()
    tm = think_ms.to(torch.float32).contiguous()
    lists = tuple(x.to(torch.float32).contiguous() for x in lists)
    think0 = torch.empty((B, H), **f32)
    st_m = torch.empty((B, E), **f32)
    st_r = torch.empty((B, E), **f32) if replay else st_m
    td = torch.empty((B, E), **f32)
    list_ptrs = [x.data_ptr() for x in lists] or [None, None]
    list_lens = [x.shape[0] for x in lists] or [0, 0]
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qn_streams_launch(
            seed.data_ptr(), nea.data_ptr(), tm.data_ptr(), *list_ptrs,
            think0.data_ptr(), st_m.data_ptr(), st_r.data_ptr(),
            td.data_ptr(), B, H, E, *list_lens, int(replay), stream)
    build.check(rc, "event_streams")
    build.count(event_streams)
    return think0, st_m, st_r, td


event_streams.launches = 0


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
             warmup_jobs: int, replay: bool, general: bool = False):
    """Every lane's event loop; returns ``(resp_sum, resp_cnt)``, float32
    ``(B,)``.  Counts are int32 ``(B,)``, times float32 ``(B,)``, ``think0``
    ``(B, H)`` and the draw tables ``(B, E)``, all on one device.
    ``slots_cap`` must not exceed ``max_slots``.  Times, means and draws
    are durations, never negative: the card's kernel orders clocks by
    their bits.  On the card lanes of at most 32 users take
    ``qn_event_fast`` up to 512 slots and ``qn_event_wide`` up to 16384,
    lanes of 33 to 2048 users ``qn_event_many`` up to 16384 slots (with
    fewer than 2**20 events); more users or slots (or any lane, with
    ``general=True``: the kernels give the same bits, and the flag lets
    them be timed and checked against each other) take
    ``qn_event_general``, whose state needs
    ``qn_event_scratch_bytes`` of global scratch a lane once it outgrows
    the card's shared memory.  The library decides (``plan()`` in
    ``csrc/qn_event.cu``) and reports the kernel it ran."""
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
    lib = build.library()
    with torch.cuda.device(dev):
        # the lane's state lives in shared memory, or past the card's
        # shared memory in a global slice per lane
        nbytes = lib.qn_event_scratch_bytes(H, int(max_slots), E)
        if nbytes < 0:
            raise RuntimeError(f"qn_event cannot lay out H={H} users and "
                               f"{max_slots} slots")
        scratch = torch.empty((B, nbytes), dtype=torch.uint8, device=dev) \
            if nbytes else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        route = ctypes.c_int(-1)
        rc = lib.qn_event_launch(
            *(x.data_ptr() for x in args), resp_sum.data_ptr(),
            resp_cnt.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, H, int(max_slots), E, int(warmup_jobs), int(bool(replay)),
            int(bool(general)), ctypes.byref(route), stream)
    build.check(rc, "qn_event")
    build.count(qn_event, ROUTES[route.value])
    return resp_sum, resp_cnt


# the kernels by the route index the library reports (enum Route in
# csrc/qn_event.cu)
ROUTES = ("qn_event_general", "qn_event_fast", "qn_event_wide",
          "qn_event_many")
qn_event.launches = 0
qn_event.routes = dict.fromkeys(ROUTES, 0)


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
