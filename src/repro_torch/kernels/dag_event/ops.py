"""Wrappers of the K-stage DAG event loop and of its random draw tables.

``dag_streams`` draws every lane's tables: a CUDA tensor launches
``csrc/dag_streams.cu`` (bit-identical to the plain version), a CPU tensor
takes the plain version in ``ref.py``.  ``dag_event`` runs the event loop:
a CUDA tensor launches one of the two kernels of ``csrc/dag_event.cu``,
the one ``route`` names (``dag_event_fast`` for lanes of at most 32 users,
512 slots, 31 stages within their stage arrays and 2**22 - 1 events;
``dag_event_kernel``, the general route, for any other), a CPU tensor
takes ``ref.dag_event``.
Each wrapper's ``launches`` counts its kernel launches, and
``dag_event.routes`` the launches of each route.  A build or launch
failure raises; a CUDA tensor never takes the plain version, and a lane
batch never takes a route ``route`` did not name.  ``sim_batch`` composes
the two into the reference's ``_dag_sim_batch_jit`` contract: on the card
through one C entry point (``dag_sim_launch``) that launches both kernels
on one stream into one allocation, counted on ``dag_streams`` and
``dag_event`` as the two wrappers count them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dag_event import ref


def _table_views(buf, B: int, H: int, E: int, replay: bool):
    """``(think0, st, td)`` cut from ``buf``, float32 words laid out as the
    kernel writes them (``csrc/dag_streams.cu``): st ``(B, E)`` (int32
    sample indices in replay mode, float32 unit draws otherwise), then td
    float32 ``(B, E)``, then think0 float32 ``(B, H)``."""
    n = B * E
    st = buf.as_strided((B, E), (E, 1), 0)
    return (buf.as_strided((B, H), (H, 1), 2 * n),
            st.view(torch.int32) if replay else st,
            buf.as_strided((B, E), (E, 1), n))


def _as(x, dtype):
    """``x`` as a contiguous tensor of ``dtype`` (itself where it is one)."""
    return (x if x.dtype == dtype else x.to(dtype)).contiguous()


def _lane_inputs(think_ms, seed, n_events_active, dev):
    """The tables' per-lane inputs on ``dev`` as the kernel reads them:
    int64 seeds, int32 budgets, float32 think times, all ``(B,)``."""
    B = seed.shape[0] if seed.dim() == 1 else -1
    for x in (think_ms, n_events_active):
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError("dag_streams takes tensors on one device")
    if B < 0 or think_ms.shape != (B,) or n_events_active.shape != (B,):
        raise ValueError("seeds, budgets and think times must be (B,)")
    return (_as(seed, torch.int64), _as(n_events_active, torch.int32),
            _as(think_ms, torch.float32))


def dag_streams(think_ms, seed, n_events_active, *, h_users: int,
                n_events: int, n_samples: int = None):
    """Per-lane tables on the device of ``seed``: ``(think0, st, td)``,
    float32 ``(B, H)``, ``(B, E)`` int32 sample indices (replay mode,
    ``n_samples`` given) or float32 unit draws, and float32 ``(B, E)``,
    drawn as ``ref.dag_streams`` documents from int64 seeds ``(B,)``,
    per-lane budgets and think times ``(B,)``.  On the card the seeds are
    taken modulo 2**32 as the plain version's keys take them; the plain
    version also raises on a seed outside int32, which the kernel path
    does not check (it would wait for the device).  On the card the three
    tables are views of one allocation (``_table_views``)."""
    dev = seed.device
    if dev.type == "cpu":
        return ref.dag_streams(think_ms, seed, n_events_active,
                               h_users=h_users, n_events=n_events,
                               n_samples=n_samples)
    if dev.type != "cuda":
        raise ValueError(f"no dag_streams kernel for device {dev}")
    seed, nea, tm = _lane_inputs(think_ms, seed, n_events_active, dev)
    replay = n_samples is not None
    if replay and int(n_samples) <= 0:
        raise ValueError("replay mode needs at least one sample")
    B, H, E = seed.shape[0], int(h_users), int(n_events)
    buf = torch.empty(B * (2 * E + H), dtype=torch.float32, device=dev)
    if B * (2 * E + H):
        rc = build.launch(dev, build.library().dag_streams_launch,
                          seed.data_ptr(), nea.data_ptr(), tm.data_ptr(),
                          buf.data_ptr(), B, H, E,
                          int(n_samples) if replay else 0, int(replay))
        build.check(rc, "dag_streams")
        build.count(dag_streams)
    return _table_views(buf, B, H, E, replay)


dag_streams.launches = 0


# dag_event_fast's limits, as csrc/dag_event.cu fits_fast() checks them:
# a user a thread of one warp, 16 slots a thread, the stage depth in the
# queue key's 5-bit field (31 - depth), the arrival rank in its 22 bits
FAST_USERS, FAST_SLOTS, FAST_STAGES, FAST_EVENTS = 32, 512, 31, 1 << 22
ROUTES = ("dag_event_fast", "dag_event_general")


def route(h_users: int, max_slots: int, n_stages: int, n_events: int,
          general: bool = False, depth: int = 0) -> str:
    """The kernel a lane batch of ``h_users`` users, ``max_slots`` slots,
    stage arrays ``n_stages`` wide, ``n_events`` events and lanes of at
    most ``depth`` stages (the largest ``n_stages`` of a lane) takes on
    the card: ``"dag_event_fast"`` when all fit its limits (at most 32
    users, 512 slots, 31 stages, fewer than 2**22 events, and no lane
    deeper than its stage arrays) and ``general`` is False, else
    ``"dag_event_general"`` (``dag_event_kernel``).  A deeper lane's
    stages past the arrays read their last row, as the reference's
    gathers clamp; its queue key may outgrow the fast route's stage field
    and its replay row pass the arrays' width, so it takes the general
    route, which gathers as the reference does.  The two give the same
    bits; ``general=True`` lets them be held and timed against each other.
    The only place the route is decided."""
    fits = (h_users <= FAST_USERS and max_slots <= FAST_SLOTS
            and n_stages <= FAST_STAGES and depth <= n_stages
            and n_events < FAST_EVENTS)
    return ROUTES[0] if fits and not general else ROUTES[1]


def _depth(n_stages, depth) -> int:
    """The deepest lane's stage count: ``depth`` as the caller read it on
    the host, or read from ``n_stages`` (a wait on the device)."""
    if depth is not None:
        return int(depth)
    return int(n_stages.max()) if n_stages.numel() else 0


def _check_lanes(ints, floats, stages, samples, B, dev):
    for x in ints + floats + stages + \
            ((samples,) if samples is not None else ()):
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError("dag_event takes tensors on one device")
    for x in ints:
        if x.shape != (B,) or x.dtype != torch.int32:
            raise ValueError("lane counts must be int32 (B,)")
    for x in floats:
        if x.shape != (B,) or x.dtype != torch.float32:
            raise ValueError("lane parameters must be float32 (B,)")
    n_tasks, t_avg = stages
    if n_tasks.dim() != 2 or n_tasks.shape[0] != B or \
            n_tasks.shape[1] == 0 or n_tasks.dtype != torch.int32 or \
            t_avg.shape != n_tasks.shape or t_avg.dtype != torch.float32:
        raise ValueError("stage arrays must be int32 and float32 (B, K), "
                         "K > 0")
    if samples is not None and (samples.dim() != 2
                                or samples.dtype != torch.float32
                                or 0 in samples.shape):
        raise ValueError("samples must be float32 (K_s, NS), K_s, NS > 0")


def _check(ints, floats, stages, tables, samples, B, H, E):
    dev = tables[0].device
    for x in tables:
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError("dag_event takes tensors on one device")
    _check_lanes(ints, floats, stages, samples, B, dev)
    think0, st, td = tables
    if think0.shape != (B, H) or think0.dtype != torch.float32:
        raise ValueError("think0 must be float32 (B, H)")
    want = torch.int32 if samples is not None else torch.float32
    if st.shape != (B, E) or st.dtype != want:
        raise ValueError(f"the service table must be {want} (B, E)")
    if td.shape != (B, E) or td.dtype != torch.float32:
        raise ValueError("the think table must be float32 (B, E)")


def dag_event(n_tasks, t_avg, n_stages, slots_cap, n_events_active,
              think_ms, think0, st, td, samples=None, *, max_slots: int,
              warmup_jobs: int, general: bool = False, depth: int = None):
    """Every lane's K-stage event loop; returns ``(resp_sum, resp_cnt)``,
    float32 ``(B,)``.  Stage arrays are ``(B, K)`` (int32 task counts,
    float32 means) padded past each lane's ``n_stages``, the lane counts
    int32 ``(B,)``, ``think_ms`` float32 ``(B,)``, ``think0`` ``(B, H)``
    and the draw tables ``(B, E)``; with ``samples`` (float32 ``(K_s,
    NS)``) the batch replays them and ``st`` holds int32 indices below NS.
    A stage past the stage arrays' or the samples' rows reads their last
    row, as the reference's gathers clamp, so a lane may be deeper than
    the arrays are wide.  All on one device.  ``slots_cap`` must not
    exceed ``max_slots``.  Times, means and draws are durations, never
    negative: the card's kernels order clocks by their bits.  On the card
    the batch takes the kernel ``route(H, max_slots, K, E, general,
    depth)`` names, with ``depth`` the largest ``n_stages`` (read from the
    device where the caller does not give it); on the general route the
    lane's state needs ``dag_event_scratch_bytes`` of global scratch once
    it outgrows the card's shared memory."""
    ints = (n_stages, slots_cap, n_events_active)
    floats = (think_ms,)
    stages = (n_tasks, t_avg)
    tables = (think0, st, td)
    B, H = think0.shape
    E = st.shape[1]
    _check(ints, floats, stages, tables, samples, B, H, E)
    dev = think0.device
    kw = dict(max_slots=max_slots, warmup_jobs=warmup_jobs)
    if dev.type == "cpu":
        return ref.dag_event(n_tasks, t_avg, n_stages, slots_cap,
                             n_events_active, think_ms, think0, st, td,
                             samples, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no dag_event kernel for device {dev}")
    args = tuple(x.contiguous() for x in stages + ints + floats + tables)
    smp = samples.contiguous() if samples is not None else None
    resp = torch.empty(2 * B, dtype=torch.float32, device=dev)
    if B == 0:
        return resp[:B], resp[B:]
    K = n_tasks.shape[1]
    took = route(H, int(max_slots), K, E, general, _depth(n_stages, depth))
    lib = build.library()
    scratch = _scratch(lib, took, B, H, int(max_slots), dev)
    rc = build.launch(
        dev, lib.dag_event_launch, *(x.data_ptr() for x in args),
        None if smp is None else smp.data_ptr(), resp.data_ptr(),
        resp.data_ptr() + 4 * B,
        None if scratch is None else scratch.data_ptr(),
        B, K, H, int(max_slots), E, 0 if smp is None else smp.shape[1],
        0 if smp is None else smp.shape[0], int(warmup_jobs),
        int(smp is not None), int(took == ROUTES[0]))
    build.check(rc, took)
    build.count(dag_event, took)
    return resp[:B], resp[B:]


dag_event.launches = 0
dag_event.routes = dict.fromkeys(ROUTES, 0)


def _scratch(lib, took, B, H, max_slots, dev):
    """The general route's global scratch, a slice per lane, where a
    lane's state outgrows the card's shared memory (None otherwise)."""
    if took == ROUTES[0]:
        return None
    nbytes = lib.dag_event_scratch_bytes(H, max_slots)
    if nbytes < 0:
        raise RuntimeError(f"dag_event cannot lay out H={H} users and "
                           f"{max_slots} slots")
    return torch.empty((B, nbytes), dtype=torch.uint8, device=dev) \
        if nbytes else None


def sim_batch(n_tasks, t_avg, n_stages, think_ms, slots_cap, seed,
              n_events_active, samples, *, h_users: int, max_slots: int,
              n_events: int, warmup_jobs: int, depth: int = None):
    """One fused simulation over a flat lane batch, on the device of its
    tensors: ``(B, K)`` stage arrays, per-lane ``(B,)`` parameters, the
    shared replay lists ``(K_s, NS)`` (or None); ``depth`` is the largest
    ``n_stages`` as the caller knows it on the host (read from the device
    otherwise).  Returns ``(mean_resp, resp_cnt)`` per lane: the same bits
    as ``dag_streams`` then ``dag_event``.  On the card both kernels run
    from one C entry point on one stream, their tables and outputs in one
    allocation, and each launch counts on its wrapper (``dag_streams``;
    ``dag_event`` and its route)."""
    dev = seed.device
    n_samples = None if samples is None else samples.shape[1]
    if dev.type != "cuda":
        think0, st, td = dag_streams(
            think_ms, seed, n_events_active, h_users=h_users,
            n_events=n_events, n_samples=n_samples)
        resp_sum, resp_cnt = dag_event(
            n_tasks, t_avg, n_stages, slots_cap, n_events_active, think_ms,
            think0, st, td, samples, max_slots=max_slots,
            warmup_jobs=warmup_jobs, depth=depth)
        return resp_sum / torch.clamp(resp_cnt, min=1.0), resp_cnt
    seed, nea, tm = _lane_inputs(think_ms, seed, n_events_active, dev)
    B = seed.shape[0]
    ints = (n_stages, slots_cap, n_events_active)
    _check_lanes(ints, (think_ms,), (n_tasks, t_avg), samples, B, dev)
    H, E, S = int(h_users), int(n_events), int(max_slots)
    if B == 0:
        empty = torch.empty(0, dtype=torch.float32, device=dev)
        return empty, empty
    K = n_tasks.shape[1]
    deepest = _depth(n_stages, depth)
    took = route(H, S, K, E, depth=deepest)
    lanes = (n_tasks.contiguous(), t_avg.contiguous(),
             n_stages.contiguous(), slots_cap.contiguous())
    smp = samples.contiguous() if samples is not None else None
    lib = build.library()
    scratch = _scratch(lib, took, B, H, S, dev)
    at = B * (2 * E + H)                # the outputs follow the tables
    buf = torch.empty(at + 2 * B, dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    rc = build.launch(
        dev, lib.dag_sim_launch, seed.data_ptr(),
        *(x.data_ptr() for x in lanes), nea.data_ptr(), tm.data_ptr(),
        None if smp is None else smp.data_ptr(), ptr, ptr + 4 * at,
        None if scratch is None else scratch.data_ptr(), B, K, H, S, E,
        0 if smp is None else smp.shape[1],
        0 if smp is None else smp.shape[0], int(warmup_jobs),
        int(smp is not None), int(took == ROUTES[0]), deepest)
    build.check(rc, took)
    build.count(dag_streams)
    build.count(dag_event, took)
    resp_sum = buf.as_strided((B,), (1,), at)
    resp_cnt = buf.as_strided((B,), (1,), at + B)
    return resp_sum / torch.clamp(resp_cnt, min=1.0), resp_cnt
