"""Closed fork-join QN simulation (paper §3.1, Figure 2) on PyTorch.

The port of the reference's ``repro/core/qn_sim.py``, both gaits.
``response_time_batch`` marshals a candidate sweep into one flat lane
batch (lane = candidate x replication), pads it exactly as the reference
does (candidate axis to the shape grid, scan length to the batch maximum,
each lane keeping its own logical event budget), cuts each lane's slots
to those its users can fill (``slots_in_use``: the same bits) and
``max_slots`` to their bucket, and runs it as ONE fused dispatch of
``kernels.qn_event``: the
draw tables are made on the device, then the event-loop kernel runs every
lane.  The dispatch accounting (``sim_stats``/``padding_stats``) uses the
reference's formulas, so the two packages' counter deltas agree call for
call.  The device decides the implementation: CUDA tensors launch the
kernel, CPU tensors take its plain version.

The scalar point-wise gait (``simulate``/``response_time``, the paper's
one simulation per probe) runs each replication as one single-lane
``kernels.qn_event`` dispatch with the same cut, seed and budget as
the reference's scalar program, so a scalar probe equals the same
candidate's lane of ``response_time_batch`` exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import partition as _partition
from repro_torch.core import shapes as _shapes
from repro_torch.kernels.qn_event import ops as qn_event_ops
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace


@dataclass(frozen=True)
class QNParams:
    n_map: int
    n_reduce: int
    m_avg: float                 # mean map-task service [ms]
    r_avg: float                 # mean reduce-task service [ms]
    think_ms: float              # Z_i
    h_users: int
    slots: int                   # FCR capacity = total containers
    n_events: int = 200_000
    warmup_jobs: int = 10
    seed: int = 0


def events_needed(n_map: int, n_reduce: int, warmup_jobs: int,
                  min_jobs: int = 40) -> int:
    """Event budget heuristic: ~2 events per task (dispatch+completion) + 2
    per job, times jobs; padded 1.5x."""
    per_job = 2 * (n_map + n_reduce) + 4
    return int(1.5 * per_job * (min_jobs + warmup_jobs))


def slots_in_use(slots, h_users, n_map, n_reduce):
    """The slots a lane can ever fill, ``min(slots, max(1, h_users *
    max(n_map, n_reduce)))`` (scalars or numpy arrays).  A user has at
    most ``max(n_map, n_reduce)`` tasks in flight and a dispatch takes the
    first free slot, so a task starts in slot j only while slots 0..j-1
    are busy: no slot at or past ``h_users * max(n_map, n_reduce)`` is
    ever used, and a lane cut to that many gives the same bits.  Both
    gaits cut their lanes here before bucketing ``max_slots``, so the
    event loop lays out and routes only the slots that can be used."""
    return np.minimum(slots, np.maximum(
        1, h_users * np.maximum(n_map, n_reduce)))


def padded_event_budget(n_map: int, n_reduce: int, *, min_jobs: int = 40,
                        warmup_jobs: int = 10) -> int:
    """The pow2-bucketed logical event budget of one (candidate,
    replication) lane — what ``response_time_batch`` scans for it."""
    return _shapes.pow2(events_needed(int(n_map), int(n_reduce),
                                      warmup_jobs, min_jobs))


# ---------------------------------------------------------------------------
# Dispatch accounting: the reference's ``qn.*`` counters, in the port's own
# registry (so a parity test can read both packages' deltas side by side).
# ---------------------------------------------------------------------------

_SIM_STAT_KEYS = ("dispatches", "lanes", "padded_lanes",
                  "events_total", "events_useful")
_REG = _obs_metrics.registry()
_QN_COUNTERS = {k: _REG.counter(f"qn.{k}") for k in _SIM_STAT_KEYS}
_QN_BUCKET = {k: _REG.counter(f"qn.bucket_{k}") for k in
              ("padded_lanes", "padded_events")}
_QN_SHARD = {k: _REG.counter(f"qn.shard_{k}") for k in
             ("padded_lanes", "padded_events")}
_QN_DEVICES = _REG.gauge(
    "qn.devices", help="lane shards (devices) of the last fused dispatch")
_QN_WASTE = _REG.gauge(
    "qn.padded_waste_ratio",
    help="1 - events_useful/events_total over process lifetime")


def _count_dispatch(n: int = 1, *, lanes: int = None, padded_lanes: int = 0,
                    events_total: int = 0, events_useful: int = 0,
                    bucket_padded_lanes: int = 0,
                    bucket_padded_events: int = 0,
                    shard_padded_lanes: int = 0,
                    shard_padded_events: int = 0,
                    devices: int = 1) -> None:
    with _REG.lock:
        _QN_COUNTERS["dispatches"].inc(n)
        _QN_COUNTERS["lanes"].inc(n if lanes is None else lanes)
        _QN_COUNTERS["padded_lanes"].inc(padded_lanes)
        _QN_COUNTERS["events_total"].inc(events_total)
        _QN_COUNTERS["events_useful"].inc(events_useful)
        _QN_BUCKET["padded_lanes"].inc(bucket_padded_lanes)
        _QN_BUCKET["padded_events"].inc(bucket_padded_events)
        _QN_SHARD["padded_lanes"].inc(shard_padded_lanes)
        _QN_SHARD["padded_events"].inc(shard_padded_events)
        _QN_DEVICES.set(devices)
        tot = _QN_COUNTERS["events_total"].value
        if tot:
            _QN_WASTE.set(1.0 - _QN_COUNTERS["events_useful"].value / tot)


def padding_stats() -> dict:
    """Split of the padding overhead into lane-grid rounding
    (``bucket_*``), shard rounding (``shard_*``, always 0 on one device)
    and batch padding (real lanes scanned past their own budget)."""
    with _REG.lock:
        total = _QN_COUNTERS["events_total"].value
        useful = _QN_COUNTERS["events_useful"].value
        b_events = _QN_BUCKET["padded_events"].value
        s_events = _QN_SHARD["padded_events"].value
        return {"bucket_padded_lanes": _QN_BUCKET["padded_lanes"].value,
                "bucket_padded_events": b_events,
                "shard_padded_lanes": _QN_SHARD["padded_lanes"].value,
                "shard_padded_events": s_events,
                "batch_padded_events": total - useful - b_events - s_events,
                "events_total": total, "events_useful": useful}


def dispatch_count() -> int:
    """Total simulator device dispatches issued by this process so far."""
    return _QN_COUNTERS["dispatches"].value


def sim_stats() -> dict:
    """Process-wide simulator counters: ``dispatches``, ``lanes`` (incl.
    padding), ``padded_lanes``, ``events_total`` and ``events_useful``."""
    with _REG.lock:
        return {k: _QN_COUNTERS[k].value for k in _SIM_STAT_KEYS}


def reset_sim_stats() -> None:
    """Zero every simulator counter and the derived waste-ratio gauge."""
    with _REG.lock:
        for c in (*_QN_COUNTERS.values(), *_QN_BUCKET.values(),
                  *_QN_SHARD.values()):
            c.reset()
        _QN_WASTE.reset()


def _combine(means, cnts) -> Tuple[float, float]:
    """Count-weighted mean across replications, in host float64.  Returns
    (inf, 0.0) when no replication completed a job."""
    good = [(float(m), float(c)) for m, c in zip(means, cnts) if c > 0]
    if not good:
        return float("inf"), 0.0
    tot = sum(c for _, c in good)
    return sum(m * c for m, c in good) / tot, tot


class PendingBatch:
    """Handle to a dispatched batch whose device tensors are not yet read.
    ``resolve()`` copies them to the host (one sync) and combines the
    replications in float64; ``resolve_batches`` reads many handles with
    one copy.  Resolution is memoized."""

    def __init__(self, mean, cnt, C: int, R: int):
        self._mean, self._cnt = mean, cnt
        self._C, self._R = C, R
        self._out: "np.ndarray | None" = None

    def _finish(self, mean, cnt) -> np.ndarray:
        if self._out is None:
            C, R = self._C, self._R
            mean = np.asarray(mean, np.float64).reshape(-1, R)[:C]
            cnt = np.asarray(cnt, np.float64).reshape(-1, R)[:C]
            out = np.full((C,), np.inf)
            for c in range(C):
                out[c] = _combine(mean[c], cnt[c])[0]
            self._out = out
            self._mean = self._cnt = None      # free the device buffers
        return self._out

    def resolve(self) -> np.ndarray:
        if self._out is None:
            both = torch.stack([self._mean, self._cnt]).cpu().numpy()
            return self._finish(both[0], both[1])
        return self._out

    @classmethod
    def resolved(cls, out) -> "PendingBatch":
        """A pre-resolved handle (empty batches, cache hits)."""
        pb = cls(None, None, 0, 1)
        pb._out = np.asarray(out, np.float64)
        return pb


def resolve_batches(batches) -> list:
    """Resolve many ``PendingBatch`` handles with ONE device-to-host copy
    (one host sync per scheduling round).  Already-resolved handles pass
    through."""
    batches = list(batches)
    todo = [b for b in batches if b._out is None]
    if todo:
        flat = torch.cat([torch.cat([b._mean, b._cnt]) for b in todo])
        flat = flat.cpu().numpy()
        at = 0
        for b in todo:
            n = b._mean.numel()
            b._finish(flat[at:at + n], flat[at + n:at + 2 * n])
            at += 2 * n
    return [b._out for b in batches]


def response_time_batch(n_map, n_reduce, m_avg, r_avg, think_ms,
                        h_users: int, slots, min_jobs: int = 40,
                        warmup_jobs: int = 10, seed: int = 0,
                        replications: int = 2,
                        m_samples=None, r_samples=None,
                        device=None, defer: bool = False):
    """Mean response time [ms] of C candidates in ONE fused dispatch.

    ``n_map``/``n_reduce``/``m_avg``/``r_avg``/``think_ms``/``slots`` are
    scalars or broadcastable 1-D arrays over the candidates; ``h_users``
    is one int for the batch.  With ``m_samples``/``r_samples`` the batch
    runs in JMT replayer mode on the shared duration lists.  Returns a
    float64 ``(C,)`` array (``inf`` where no replication completed a job),
    or with ``defer=True`` a ``PendingBatch`` that resolves to it.
    """
    dev = resolve_device(device)
    shape = np.broadcast_shapes(*(np.shape(np.asarray(x)) for x in
                                  (n_map, n_reduce, m_avg, r_avg,
                                   think_ms, slots)))
    C = int(np.prod(shape, dtype=np.int64)) if shape else 1

    def _b(x, dt):
        return np.broadcast_to(np.asarray(x, dt), (C,)).copy()

    nm = _b(n_map, np.int64)
    nr = _b(n_reduce, np.int64)
    ma = _b(m_avg, np.float32)
    ra = _b(r_avg, np.float32)
    tk = _b(think_ms, np.float32)
    sl = _b(slots, np.int64)

    if m_samples is not None:
        ms = torch.as_tensor(np.asarray(m_samples, np.float32), device=dev)
        rs = torch.as_tensor(np.asarray(r_samples, np.float32), device=dev)
        ma = np.zeros_like(ma)      # replay mode ignores the profile means
        ra = np.zeros_like(ra)
    else:
        ms = rs = None

    # per-candidate logical budget: the RNG fold offset of its think stream
    n_ev = np.asarray([padded_event_budget(int(nm[c]), int(nr[c]),
                                           min_jobs=min_jobs,
                                           warmup_jobs=warmup_jobs)
                       for c in range(C)], np.int64)
    scan_len = int(n_ev.max())
    sl = slots_in_use(sl, int(h_users), nm, nr)
    max_slots = _shapes.bucket_slots(int(sl.max()))
    (nm, nr, ma, ra, tk, sl, n_ev), seeds, shards = fused_lanes(
        (nm, nr, ma, ra, tk, sl, n_ev), n_ev, replications=replications,
        seed=seed)

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(dev)

    i32, f32 = torch.int32, torch.float32
    impl = "cuda" if dev.type == "cuda" else "plain"
    with _obs_trace.span(f"kernel:{impl}", cat="kernel",
                         lanes=len(seeds), candidates=C,
                         scan_len=scan_len, max_slots=max_slots,
                         h_users=int(h_users), replay=ms is not None,
                         devices=shards, shard_lanes=len(seeds) // shards):
        mean, cnt = qn_event_ops.sim_batch(
            t(nm, i32), t(nr, i32), t(ma, f32), t(ra, f32), t(tk, f32),
            t(sl, i32), t(seeds, torch.int64), t(n_ev, i32), ms, rs,
            h_users=int(h_users), max_slots=max_slots, n_events=scan_len,
            warmup_jobs=warmup_jobs)
    pending = PendingBatch(mean, cnt, C, replications)
    return pending if defer else pending.resolve()


def fused_lanes(arrays, n_ev, *, replications: int, seed: int):
    """The flat lane layout of one fused dispatch over C candidates, as the
    reference lays it out, and its count in the simulator counters (the
    reference's formulas).  The candidate axis of every array in
    ``arrays`` (leading dimension C) is padded to the lane grid by
    replicating the last candidate (lanes are independent; the copies are
    dropped on resolve), then each candidate is repeated for its
    ``replications`` lanes, seeded ``seed + 1000*r``.  ``n_ev`` holds the
    candidates' logical budgets.  Returns ``(lane arrays, seeds,
    shards)``."""
    C = len(n_ev)
    scan_len = int(np.max(n_ev))
    shards = _partition.shard_count(C)
    C_single = _shapes.bucket_lanes(C)
    C_pad = _partition.bucket_lanes(C, shards)
    if C_pad > C:
        pad = lambda x: np.concatenate(
            [x, np.repeat(x[-1:], C_pad - C, axis=0)])
        arrays = [pad(x) for x in arrays]
    R = replications
    shard_pad = max(C_pad - C_single, 0)
    bucket_pad = (C_pad - C) - shard_pad
    _count_dispatch(
        lanes=C_pad * R, padded_lanes=(C_pad - C) * R,
        events_total=scan_len * C_pad * R,
        events_useful=int(np.sum(n_ev)) * R,
        bucket_padded_lanes=bucket_pad * R,
        bucket_padded_events=scan_len * bucket_pad * R,
        shard_padded_lanes=shard_pad * R,
        shard_padded_events=scan_len * shard_pad * R,
        devices=shards)
    seeds = seed + 1000 * np.tile(np.arange(R, dtype=np.int64), C_pad)
    return [np.repeat(x, R, axis=0) for x in arrays], seeds, shards


def _simulate(p: QNParams, replications: int, m_samples, r_samples,
              device) -> Tuple[float, float]:
    """The scalar gait: each replication is one single-lane dispatch of
    ``kernels.qn_event`` at the pow2 budget of ``p.n_events`` (fold offset
    and scan length alike) and the bucketed ``max_slots`` of the slots in
    use (``slots_in_use``), seeded
    ``p.seed + 1000*r``.  Replay mode ignores the profile means."""
    dev = resolve_device(device)
    ne = _shapes.bucket_events(p.n_events)
    replay = m_samples is not None
    if replay:
        ms = torch.as_tensor(np.asarray(m_samples, np.float32), device=dev)
        rs = torch.as_tensor(np.asarray(r_samples, np.float32), device=dev)
        m_avg = r_avg = 0.0
    else:
        ms = rs = None
        m_avg, r_avg = p.m_avg, p.r_avg

    def t(x, dt):
        return torch.tensor([x], dtype=dt, device=dev)

    i32, f32 = torch.int32, torch.float32
    slots = int(slots_in_use(p.slots, p.h_users, p.n_map, p.n_reduce))
    lane = (t(p.n_map, i32), t(p.n_reduce, i32), t(m_avg, f32),
            t(r_avg, f32), t(p.think_ms, f32), t(slots, i32))
    span_args = dict(events=ne, replay=True) if replay else dict(events=ne)
    outs = []
    for r in range(replications):
        _count_dispatch(events_total=ne, events_useful=ne)
        with _obs_trace.span("kernel:scalar", cat="kernel", **span_args):
            outs.append(torch.cat(qn_event_ops.sim_batch(
                *lane, t(p.seed + 1000 * r, torch.int64), t(ne, i32),
                ms, rs, h_users=int(p.h_users),
                max_slots=_shapes.bucket_slots(slots), n_events=ne,
                warmup_jobs=p.warmup_jobs)))
    if not outs:
        return _combine([], [])
    res = torch.stack(outs).cpu().numpy()      # one read for all of them
    return _combine(res[:, 0], res[:, 1])


def simulate(p: QNParams, replications: int = 3,
             device=None) -> Tuple[float, float]:
    """Returns (mean response [ms], total completed jobs counted) of
    ``replications`` exponential-mode runs, one dispatch each."""
    return _simulate(p, replications, None, None, device)


def response_time(n_map: int, n_reduce: int, m_avg: float, r_avg: float,
                  think_ms: float, h_users: int, slots: int,
                  min_jobs: int = 40, warmup_jobs: int = 10,
                  seed: int = 0, replications: int = 2,
                  m_samples=None, r_samples=None, device=None) -> float:
    """Mean response time of one configuration, one dispatch per
    replication.  With ``m_samples``/``r_samples`` service times replay
    the duration lists (JMT replayer mode); otherwise they are exponential
    with the profile means."""
    p = QNParams(n_map=n_map, n_reduce=n_reduce, m_avg=m_avg, r_avg=r_avg,
                 think_ms=think_ms, h_users=h_users, slots=slots,
                 n_events=events_needed(n_map, n_reduce, warmup_jobs,
                                        min_jobs),
                 warmup_jobs=warmup_jobs, seed=seed)
    return _simulate(p, replications, m_samples, r_samples, device)[0]
