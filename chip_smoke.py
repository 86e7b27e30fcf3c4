"""Drive the PyTorch/CUDA port of the planner on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line or a few:
  1. the device, and the card's name and power limit from nvidia-smi;
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc call);
  3. hold each kernel against its plain PyTorch version on the card, on
     identical inputs: qn_event in exponential and replay mode (padding,
     single-slot and short-budget lanes) at a reduced event budget, amva
     at several sizes; both must be bit-identical;
  4. the main path at real size: the paper's §4.3 scenario (TPC-DS Q1 on
     250 GB, 10 users, 160 s deadline, m4.xlarge + CINECA, JMT-replayer
     mode) through DSpace4Cloud.run() and .run_fast() at the defaults,
     and the quickstart problem (exponential mode) through .run(); each
     drive resets the kernels' launch counts first and reads them after;
     a small replay problem is also planned on the card and on the CPU
     (plain versions), and the decisions must agree;
  5. each kernel's time at the main path's shapes (CUDA events, after a
     warm-up), its bound, and its plain version's time.
The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Any failure exits nonzero before it.
Needs one CUDA card, nvcc, and the repository's src/ beside this file.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # non-tensor float32, H100 SXM data sheet
# one non-tensor instruction per lane per clock: the float32 rate above
# counts an FMA as two operations; a compare or a max is one instruction
H100_INSTR_PER_S = H100_FP32_OPS_PER_S / 2

# Decisions of the JAX reference (src/repro) for the same calls, printed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks.port_reference_decisions
# on a CPU host (JAX 0.9.0).
REFERENCE = {
 "Q1-10u.run": {
  "qn_dispatches": 2,
  "classes": {
   "Q1-10u": {
    "vm_type": "m4.xlarge",
    "nu": 40,
    "reserved": 28,
    "spot": 12,
    "cost_per_h": 7.0,
    "predicted_ms": 158747.29693983402,
    "feasible": True
   }
  }
 },
 "Q1-10u.run_fast": {
  "qn_dispatches": 2,
  "classes": {
   "Q1-10u": {
    "vm_type": "m4.xlarge",
    "nu": 40,
    "reserved": 28,
    "spot": 12,
    "cost_per_h": 7.0,
    "predicted_ms": 158747.29693983402,
    "feasible": True
   }
  }
 },
 "quickstart.run": {
  "qn_dispatches": 2,
  "classes": {
   "bi-dashboards": {
    "vm_type": "m4.xlarge",
    "nu": 5,
    "reserved": 4,
    "spot": 1,
    "cost_per_h": 0.95,
    "predicted_ms": 49770.77734375,
    "feasible": True
   },
   "nightly-etl": {
    "vm_type": "m4.xlarge",
    "nu": 2,
    "reserved": 1,
    "spot": 1,
    "cost_per_h": 0.29000000000000004,
    "predicted_ms": 409866.53125,
    "feasible": True
   }
  }
 }
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the current stream, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def quickstart_problem(P):
    """The two-class, two-VM problem of examples/quickstart.py."""
    JobProfile, VMType, AC = P.JobProfile, P.VMType, P.ApplicationClass
    interactive = JobProfile(n_map=64, n_reduce=16, m_avg=4000, m_max=9000,
                             r_avg=2000, r_max=4500)
    batchy = JobProfile(n_map=400, n_reduce=64, m_avg=8000, m_max=18000,
                        r_avg=5000, r_max=11000)
    small = VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                   containers_per_core=2)
    big = VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90, speed=1.35)
    return P.Problem(classes=[
        AC(name="bi-dashboards", h_users=8, think_ms=10_000,
           deadline_ms=60_000, eta=0.3,
           profiles={"m4.xlarge": interactive,
                     "c20.node": interactive.scaled(1.35)}),
        AC(name="nightly-etl", h_users=2, think_ms=30_000,
           deadline_ms=600_000, eta=0.5,
           profiles={"m4.xlarge": batchy, "c20.node": batchy.scaled(1.35)}),
    ], vm_types=[small, big])


def small_replay_problem(P):
    """One class, two VM types, task counts small enough for the plain
    versions on the CPU; replay lists made from a numpy seed."""
    JobProfile, VMType = P.JobProfile, P.VMType
    prof = JobProfile(n_map=8, n_reduce=2, m_avg=3000, m_max=7000,
                      r_avg=1500, r_max=3500)
    vms = [VMType(name="m4.xlarge", cores=4, sigma=0.07, pi=0.22,
                  containers_per_core=2),
           VMType(name="c20.node", cores=20, sigma=0.35, pi=0.90,
                  speed=1.35)]
    cls = P.ApplicationClass(
        name="small", h_users=4, think_ms=10_000, deadline_ms=9_000,
        eta=0.3, profiles={"m4.xlarge": prof, "c20.node": prof.scaled(1.35)})
    rng = np.random.default_rng(3)
    samples = {}
    for vm in vms:
        f = 1.0 / vm.speed
        samples[("small", vm.name)] = (
            (rng.lognormal(np.log(3000), 0.4, 256) * f).astype(np.float32),
            (rng.lognormal(np.log(1500), 0.4, 128) * f).astype(np.float32))
    return P.Problem(classes=[cls], vm_types=vms), samples


def decisions(report) -> dict:
    return {name: {k: s.as_dict()[k] for k in
                   ("vm_type", "nu", "reserved", "spot", "cost_per_h",
                    "predicted_ms", "feasible")}
            for name, s in report.solutions.items()}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, os.path.join(root, "src"))

    from repro_torch.core import optimizer, problem, qn_sim, tpcds
    from repro_torch.kernels import build
    from repro_torch.kernels.amva import ops as amva_ops
    from repro_torch.kernels.amva import ref as amva_ref
    from repro_torch.kernels.qn_event import ops as qn_ops
    from repro_torch.kernels.qn_event import ref as qn_ref
    from repro_torch.obs import trace

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{kind} x{torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    build.library()
    usage = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"(libqn_{build.source_hash()}.so); ptxas: {' | '.join(usage)}",
          flush=True)

    # ----------------------------------------------- kernels vs plain (card)
    gen = np.random.default_rng(11)
    H, S, E = 10, 512, 4096
    lanes = [  # (n_map, n_reduce, slots_cap, n_events_active)
        (500, 1, 432, E), (500, 1, 300, E), (64, 16, 40, E), (64, 16, 7, E),
        (8, 2, 1, E), (8, 2, 3, E // 3), (400, 64, 512, E), (1, 1, 1, 0),
        (32, 8, 16, E // 2), (3, 0, 2, E), (16, 4, 64, 1), (500, 1, 512, E),
    ]
    B = len(lanes)
    cols = list(zip(*lanes))
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    nm, nr, cap, nea = (i32(c) for c in cols)
    ma = f32(gen.uniform(2000, 9000, B))
    ra = f32(gen.uniform(1000, 5000, B))
    tm = f32(gen.uniform(5000, 30000, B))
    seeds = torch.tensor(1000 * np.arange(B), dtype=torch.int64, device=dev)
    m_list = f32(gen.lognormal(np.log(5000), 0.5, 2048))
    r_list = f32(gen.lognormal(np.log(2500), 0.5, 2048))
    qn_err = 0.0
    for replay in (False, True):
        smp = (m_list, r_list) if replay else (None, None)
        tables = qn_ops.event_streams(tm, seeds, nea, h_users=H, n_events=E,
                                      m_samples=smp[0], r_samples=smp[1])
        args = (nm, nr, cap, nea, ma, ra, tm, *tables)
        kw = dict(max_slots=S, warmup_jobs=8, replay=replay)
        ks, kc = qn_ops.qn_event(*args, **kw)
        ps, pc = qn_ref.qn_event(*args, **kw)
        same = torch.equal(ks, ps) and torch.equal(kc, pc)
        qn_err = max(qn_err, float((ks - ps).abs().max()),
                     float((kc - pc).abs().max()))
        print(f"[check] qn_event replay={replay} B={B} E={E} S={S} H={H}: "
              f"bit-identical={same} jobs={kc.tolist()}", flush=True)
        if not same:
            fail(f"qn_event differs from its plain version (replay={replay})")
        if float(kc.sum()) <= 0:
            fail("qn_event check completed no job")
    if float(kc[7]) != 0.0:
        fail("a padding lane (zero budget) reported jobs")
    amva_err = 0.0
    for n in (1, 7, 97, 128, 1000, 4097):
        a = f32(np.abs(gen.normal(size=n)) * 1e4)
        b = f32(np.abs(gen.normal(size=n)) * 1e3)
        z = f32(np.full(n, 1e4))
        h = f32(np.round(np.abs(gen.normal(size=n)) * 10 + 1))
        k = amva_ops.ps_fixed_point(a, b, z, h)
        p = amva_ref.ps_fixed_point(a, b, z, h)
        amva_err = max(amva_err, float((k - p).abs().max()))
        if not torch.equal(k, p):
            fail(f"amva differs from its plain version at N={n}")
    print(f"[check] amva N=1,7,97,128,1000,4097: bit-identical=True",
          flush=True)

    # ------------------------------------------------------------ main path
    DSpace4Cloud = optimizer.DSpace4Cloud
    prob, samples, _ = tpcds.scenario_problem("Q1", 10, 160_000.0)
    drives = [("Q1-10u.run", lambda: DSpace4Cloud(
                   prob, samples=samples).run()),
              ("Q1-10u.run_fast", lambda: DSpace4Cloud(
                   prob, samples=samples).run_fast()),
              ("quickstart.run", lambda: DSpace4Cloud(
                   quickstart_problem(problem), min_jobs=20,
                   replications=1).run())]
    launches = {"qn_event": 0, "amva": 0}
    mismatches = []
    shape_count = collections.Counter()
    for name, drive in drives:
        qn_ops.qn_event.launches = 0
        amva_ops.ps_fixed_point.launches = 0
        qn_sim.reset_sim_stats()
        t0 = time.perf_counter()
        with trace.tracing() as tracer:
            rep = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "Q1-10u.run":
            shape_count.update(
                (sp.args["lanes"], sp.args["scan_len"], sp.args["max_slots"],
                 sp.args["h_users"]) for sp in tracer.by_name("kernel:cuda"))
        n_qn = qn_ops.qn_event.launches
        n_amva = amva_ops.ps_fixed_point.launches
        launches["qn_event"] += n_qn
        launches["amva"] += n_amva
        got = decisions(rep)
        print(f"[main] {name}: wall={wall:.3f} s qn_dispatches="
              f"{rep.qn_dispatches} launches qn_event={n_qn} amva={n_amva} "
              f"events={rep.telemetry['qn']['events_total']} "
              f"decisions={json.dumps(got)}", flush=True)
        ref = REFERENCE.get(name)
        if ref is not None:
            print(f"[main] {name} reference: qn_dispatches="
                  f"{ref['qn_dispatches']} decisions="
                  f"{json.dumps(ref['classes'])}", flush=True)
            for cls, want in ref["classes"].items():
                have = got[cls]
                same = all(have[k] == want[k] for k in
                           ("vm_type", "nu", "reserved", "spot"))
                if not same or ref["qn_dispatches"] != rep.qn_dispatches:
                    mismatches.append(name)
                print(f"[main] {name} {cls}: predicted_ms port "
                      f"{have['predicted_ms']!r} reference "
                      f"{want['predicted_ms']!r} equal="
                      f"{have['predicted_ms'] == want['predicted_ms']}",
                      flush=True)
        if n_qn != rep.qn_dispatches or n_qn <= 0:
            fail(f"{name}: qn_event launches {n_qn} != fused dispatches "
                 f"{rep.qn_dispatches}")
        if name.endswith("run_fast") and n_amva <= 0:
            fail(f"{name}: the amva kernel was not launched")
        for cls, sol in got.items():
            if not (np.isfinite(sol["predicted_ms"]) and sol["nu"] >= 1
                    and sol["reserved"] + sol["spot"] == sol["nu"]):
                fail(f"{name}: malformed solution for {cls}: {sol}")
    print(f"[main] decisions differing from the reference: "
          f"{sorted(set(mismatches)) or 'none'}", flush=True)

    # device busy share of one Q1 run() (torch.profiler, CUDA activity)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_run:
        t0 = time.perf_counter()
        DSpace4Cloud(prob, samples=samples).run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = collections.Counter()
    for ev in prof_run.events():       # device-side kernel records only
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kernel.values())
    top = ", ".join(f"{k[:40]}={v:.2f}" for k, v in by_kernel.most_common(5))
    print(f"[profile] Q1-10u.run: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; top ms: {top}"
          if busy_ms > 0 else
          f"[profile] Q1-10u.run: wall {wall_ms:.2f} ms, device time not "
          f"measured (the profiler recorded no device activity)",
          flush=True)

    small, small_samples = small_replay_problem(problem)
    on_card = decisions(DSpace4Cloud(small, samples=small_samples,
                                     min_jobs=10).run())
    on_cpu = decisions(DSpace4Cloud(small, samples=small_samples,
                                    min_jobs=10, device="cpu").run())
    for cls in on_cpu:
        a, b = on_card[cls], on_cpu[cls]
        if any(a[k] != b[k] for k in ("vm_type", "nu", "reserved", "spot")):
            fail(f"small replay problem: card {a} != cpu {b}")
    print(f"[main] small replay problem, card vs cpu: decisions equal; "
          f"predicted_ms card={[v['predicted_ms'] for v in on_card.values()]}"
          f" cpu={[v['predicted_ms'] for v in on_cpu.values()]}", flush=True)

    # ---------------------------------------------------------------- times
    # qn_event at every dispatch shape of the Q1 run() above: lanes of
    # m4.xlarge candidates up to the shape's max_slots, 2 replications.
    # Each shape is held against the plain version with the depth cut to
    # E_cut events; the commonest one is also timed at full depth.
    cls = prob.classes[0]
    vm = prob.vm_types[0]
    prof = cls.profile_for(vm)
    m_s, r_s = samples[(cls.name, vm.name)]
    E_cut = 8192

    def main_lanes(Bm, E_main, S_main, H_main):
        nu_top = max(1, S_main // vm.slots)
        caps = [max(1, nu_top - k // 2) * vm.slots for k in range(Bm)]
        lane_args = (i32([prof.n_map] * Bm), i32([prof.n_reduce] * Bm),
                     i32(caps), i32([E_main] * Bm), f32([0.0] * Bm),
                     f32([0.0] * Bm), f32([cls.think_ms] * Bm))
        seeds_m = torch.tensor(1000 * (np.arange(Bm) % 2),
                               dtype=torch.int64, device=dev)
        streams_kw = dict(h_users=H_main, n_events=E_main,
                          m_samples=f32(m_s), r_samples=f32(r_s))
        make = lambda: qn_ops.event_streams(lane_args[6], seeds_m,
                                            lane_args[3], **streams_kw)
        return lane_args, make

    shapes = [s for s, _ in shape_count.most_common()]
    checked = {}
    for Bm, E_main, S_main, H_main in shapes:
        lane_args, make = main_lanes(Bm, E_main, S_main, H_main)
        tables = make()
        cut = (*lane_args[:3], i32([E_cut] * Bm), *lane_args[4:], tables[0],
               *(t[:, :E_cut].contiguous() for t in tables[1:]))
        cut_kw = dict(max_slots=S_main, warmup_jobs=8, replay=True)
        ks, kc = qn_ops.qn_event(*cut, **cut_kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps, pc = qn_ref.qn_event(*cut, **cut_kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(ks, ps) and torch.equal(kc, pc)):
            fail(f"qn_event differs from its plain version at the main "
                 f"path's widths B={Bm} S={S_main} H={H_main}")
        qn_err = max(qn_err, float((ks - ps).abs().max()),
                     float((kc - pc).abs().max()))
        cut_ms = cuda_ms(lambda: qn_ops.qn_event(*cut, **cut_kw), 3)
        checked[(Bm, E_main, S_main, H_main)] = (plain_ms, cut_ms)
        print(f"[check] qn_event at the main path's widths B={Bm} "
              f"S={S_main} H={H_main}, E={E_cut}: bit-identical=True; "
              f"kernel {cut_ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)

    (Bm, E_main, S_main, H_main), n_shape = shape_count.most_common(1)[0]
    lane_args, make = main_lanes(Bm, E_main, S_main, H_main)
    tables = make()
    streams_ms = cuda_ms(make, 2)
    run_qn = lambda: qn_ops.qn_event(*lane_args, *tables, max_slots=S_main,
                                     warmup_jobs=8, replay=True)
    qn_ms = cuda_ms(run_qn, 3)
    _, cnt = run_qn()
    if not bool((cnt > 0).all()):
        fail("qn_event at the main path's shape left a lane without jobs")
    qn_plain_ms, qn_cut_ms = checked[(Bm, E_main, S_main, H_main)]
    # bound: each table and parameter read once, each output written once;
    # per active event the least work the function needs: a log2(S)
    # selection among the slots for each of the two slot choices (first
    # free, earliest end, as from a heap) and 4*H user compares (reduce
    # key, map key, think end, pending), one instruction each
    active = int(lane_args[3].sum())
    qn_bytes = 4 * (3 * Bm * E_main + Bm * H_main + 7 * Bm + 2 * Bm)
    log_s = max(1, (S_main - 1).bit_length())
    qn_ops_n = active * (2 * log_s + 4 * H_main)
    qn_bound = 1e3 * max(qn_bytes / H100_BYTES_PER_S,
                         qn_ops_n / H100_INSTR_PER_S)
    print(f"[time] qn_event B={Bm} E={E_main} S={S_main} H={H_main} "
          f"({n_shape} of the run's dispatches had this shape): "
          f"{qn_ms:.3f} ms/launch ({active / qn_ms * 1e3:.3e} "
          f"lane-events/s); event_streams {streams_ms:.3f} ms; bound "
          f"{qn_bound:.4f} ms ({qn_bytes} bytes, {qn_ops_n} operations); "
          f"at E={E_cut}: kernel {qn_cut_ms:.3f} ms, plain "
          f"{qn_plain_ms:.1f} ms", flush=True)

    # amva at the frontier of run_fast: span 64 -> 97 points
    n_am = 97
    nus_am = np.arange(20, 20 + n_am)
    a_am = f32(2.0e6 / (nus_am * 8))
    am_args = (a_am, f32([9000.0] * n_am), f32([10000.0] * n_am),
               f32([10.0] * n_am))
    am_ms = cuda_ms(lambda: amva_ops.ps_fixed_point(*am_args), 50)
    am_plain_ms = cuda_ms(lambda: amva_ref.ps_fixed_point(*am_args), 5)
    am_bytes = 4 * 5 * n_am
    am_ops_n = n_am * 40 * 6       # mul, add, div, max, fma (2) per round
    am_bound = 1e3 * max(am_bytes / H100_BYTES_PER_S,
                         am_ops_n / H100_FP32_OPS_PER_S)
    print(f"[time] amva N={n_am}: {am_ms:.4f} ms/launch, plain "
          f"{am_plain_ms:.3f} ms, bound {am_bound:.6f} ms", flush=True)

    record = {"kernels": [
        {"name": "qn_event", "route": "cuda",
         "source": "src/repro_torch/csrc/qn_event.cu",
         "replaces": "src/repro/kernels/qn_event/kernel.py:255",
         "launches": launches["qn_event"], "max_abs_err": qn_err,
         "ms": qn_ms, "plain_ms": qn_plain_ms,
         "plain_shape": f"B={Bm} E={E_cut} S={S_main} H={H_main}",
         "ms_at_plain_shape": qn_cut_ms,
         "bound_ms": qn_bound,
         "bound_by": ("operations" if qn_ops_n / H100_INSTR_PER_S
                      > qn_bytes / H100_BYTES_PER_S else "bytes"),
         "library_ms": None,
         "library_note": "no single PyTorch call simulates the network"},
        {"name": "amva", "route": "cuda",
         "source": "src/repro_torch/csrc/amva.cu",
         "replaces": "src/repro/kernels/amva/kernel.py:94",
         "launches": launches["amva"], "max_abs_err": amva_err,
         "ms": am_ms, "plain_ms": am_plain_ms,
         "bound_ms": am_bound,
         "bound_by": ("operations" if am_ops_n / H100_FP32_OPS_PER_S
                      > am_bytes / H100_BYTES_PER_S else "bytes"),
         "library_ms": None,
         "library_note": "no single PyTorch call iterates the fixed point"},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
