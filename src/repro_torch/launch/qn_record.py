"""Measured QN/AMVA kernel record, the reference's ``launch/qn_record``:
the planner's two hot kernels, each cell timed in two implementations.

    python -m repro_torch.launch.qn_record [--quick] [--device cpu]

The cells are the reference's: the fused QN event simulation
(``qn_event`` at two full shapes and one quick one, its arguments laid
out as ``qn_sim.response_time_batch`` lays out a nu frontier) and the
batched AMVA fixed point (``amva_ps`` at (4096, 10), (65536, 20) and
quick (1024, 10)).  The implementations are ``"plain"`` (the kernel's
``ref.py``) and ``"cuda"`` (the hand-written kernel through ``ops``), on
the same inputs on one device; ``parity_bit_exact`` says whether their
outputs are equal bit for bit, which is the port's contract.  On the CPU
(``device="cpu"``) only ``"plain"`` runs and ``parity_bit_exact`` is
``None``.  The port compiles no program it could ask for a cost
analysis, so ``cost_analysis`` holds the reference's error form and
``launch/roofline.analyze_kernel_record`` reads 0 flops from it.

The record (the reference's keys) goes to ``results/dryrun_qn_torch.json``
by default; ``launch/roofline.analyze_qn_file`` reads it.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device

DRYRUN_QN = "results/dryrun_qn_torch.json"

NO_COST_ANALYSIS = {"error": "no cost analysis: the port runs hand-written "
                             "CUDA kernels and plain PyTorch, and compiles "
                             "no XLA program to ask one of"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bench(fn, args, kwargs, reps: int, dev: torch.device):
    out = fn(*args, **kwargs)          # build + warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    _sync(dev)
    return (time.perf_counter() - t0) / reps, out


def _impls(dev: torch.device, cuda_fn, plain_fn):
    impls = [("plain", plain_fn)]
    if dev.type == "cuda":
        impls.append(("cuda", cuda_fn))
    return impls


def _parity(outs: dict) -> Optional[bool]:
    if "cuda" not in outs:
        return None
    a, b = outs["plain"], outs["cuda"]
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _qn_batch(dev: torch.device, *, batch: int, n_map: int, n_reduce: int,
              m_avg: float, r_avg: float, think_ms: float, h_users: int,
              min_jobs: int, warmup_jobs: int, seed: int = 0):
    """One fused-batch argument set, laid out as
    ``qn_sim.response_time_batch`` lays out a nu frontier (a pow2 batch,
    per-lane budgets and seeds), so the cell is a dispatch shape of the
    planner."""
    from repro_torch.core import qn_sim, shapes

    nus = np.arange(1, batch + 1, dtype=np.int64)
    n_ev = qn_sim.padded_event_budget(n_map, n_reduce, min_jobs=min_jobs,
                                      warmup_jobs=warmup_jobs)
    full = lambda v, dt: torch.full((batch,), v, dtype=dt, device=dev)
    i32, f32 = torch.int32, torch.float32
    args = (full(n_map, i32), full(n_reduce, i32), full(m_avg, f32),
            full(r_avg, f32), full(think_ms, f32),
            torch.as_tensor(nus, dtype=i32, device=dev),
            torch.as_tensor(seed + 1000 * np.arange(batch), dtype=torch.int64,
                            device=dev),
            full(n_ev, i32), None, None)
    statics = dict(h_users=h_users, max_slots=shapes.pow2(int(nus.max())),
                   n_events=n_ev, warmup_jobs=warmup_jobs)
    return args, statics


def _qn_cell(cell: dict, reps: int, dev: torch.device) -> List[dict]:
    from repro_torch.kernels.qn_event import ops, ref

    args, statics = _qn_batch(dev, **cell)
    lanes = cell["batch"]
    events = statics["n_events"] * lanes
    recs, outs = [], {}
    for impl, fn in _impls(dev, ops.sim_batch, ref.sim_batch):
        rec = {"cell": "qn_event", "impl": impl, **{
            k: cell[k] for k in ("batch", "n_map", "n_reduce", "h_users",
                                 "min_jobs", "warmup_jobs")},
            "n_events": statics["n_events"], "max_slots": statics["max_slots"],
            "lanes": lanes, "events_total": events,
            "cost_analysis": dict(NO_COST_ANALYSIS)}
        wall, outs[impl] = _bench(fn, args, statics, reps, dev)
        rec["wall_s"] = wall
        rec["events_per_s"] = events / wall
        recs.append(rec)
    bit = _parity(outs)
    for r in recs:
        r["parity_bit_exact"] = bit
    return recs


def _amva_cell(n: int, h_users: int, reps: int, dev: torch.device,
               seed: int = 0) -> List[dict]:
    from repro_torch.core.mva import PS_ITERS
    from repro_torch.kernels.amva import ops, ref

    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    a = f32(rng.uniform(1.0, 50.0, n))
    b = f32(rng.uniform(0.1, 5.0, n))
    z = f32(rng.uniform(1.0, 100.0, n))
    h = torch.full((n,), float(h_users), dtype=torch.float32, device=dev)
    recs, outs = [], {}
    for impl, fn in _impls(dev, ops.ps_fixed_point, ref.ps_fixed_point):
        rec = {"cell": "amva_ps", "impl": impl, "batch": n,
               "h_users": h_users, "iters": PS_ITERS,
               "cost_analysis": dict(NO_COST_ANALYSIS)}
        wall, outs[impl] = _bench(fn, (a, b, z, h), {}, reps, dev)
        rec["wall_s"] = wall
        rec["candidates_per_s"] = n / wall
        recs.append(rec)
    bit = _parity(outs)
    for r in recs:
        r["parity_bit_exact"] = bit
    return recs


def record_qn_cells(out: Optional[str] = DRYRUN_QN, quick: bool = False,
                    device=None) -> List[dict]:
    """Measure every cell on ``device`` (the CUDA card by default; it
    raises without one unless given ``device="cpu"``); write the JSON
    record to ``out`` (skipped when None) and return it.  ``quick``
    shrinks the batch and budget to a smoke size."""
    dev = resolve_device(device)
    if quick:
        qn_cells = [dict(batch=8, n_map=8, n_reduce=2, m_avg=40.0,
                         r_avg=60.0, think_ms=1000.0, h_users=3,
                         min_jobs=8, warmup_jobs=2)]
        amva_cells = [(1024, 10)]
        reps = 2
    else:
        qn_cells = [
            dict(batch=16, n_map=16, n_reduce=4, m_avg=40.0, r_avg=60.0,
                 think_ms=1000.0, h_users=5, min_jobs=16, warmup_jobs=4),
            dict(batch=32, n_map=64, n_reduce=16, m_avg=30.0, r_avg=80.0,
                 think_ms=10000.0, h_users=10, min_jobs=24, warmup_jobs=6),
        ]
        amva_cells = [(4096, 10), (65536, 20)]
        reps = 3
    recs: List[dict] = [{"cell": "meta", "backend": dev.type,
                         "quick": quick}]
    for cell in qn_cells:
        recs.extend(_qn_cell(cell, reps, dev))
    for n, h in amva_cells:
        recs.extend(_amva_cell(n, h, reps, dev))
    if out is not None:
        p = Path(out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(recs, indent=1))
    return recs


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DRYRUN_QN)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    recs = record_qn_cells(out=args.out, quick=args.quick,
                           device=args.device)
    print(f"{len(recs) - 1} kernel cells -> {args.out}")
    return recs


if __name__ == "__main__":
    main()
