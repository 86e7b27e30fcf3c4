"""Time the DAG draw tables and the AMVA fixed point of the port from a
given source tree, so that two trees can be compared on one card in one
process each, in turns:

    python3 benchmarks/torch_streams_amva_ab.py <tree>/src <label>

e.g. a parent unpacked into a gitignored directory (``git archive``) and
the working tree, run parent, change, change, parent.  The shapes are the
main path's: the draw tables at dag_sweep's frontier (16 lanes of the
Spark chain, E = 8192, H = 3, seed 0, exponential mode), ``sim_batch``
on them (the tables and the event loop), and the AMVA frontier of
``run_fast`` (Q1-10u on m4.xlarge, 97 points from nu = 20).  Prints the
label and a JSON object of milliseconds:

- ``dag_streams``: ``call`` (CUDA events over back-to-back calls, which
  the host bounds), ``host`` (the host's time a call, not waiting for the
  card), ``queued`` (the calls queued behind a spin: the kernel's own time);
- ``sim_batch``: ``host`` and ``call`` (to its end, bound by the event
  loop);
- ``ps_fixed_point`` (N = 97 tensors): ``call``, ``host``, ``queued``, and
  ``round_ns``, a round of its dependent chain on one thread (a long
  launch against a short one);
- ``amva_frontier``: ``host``, the planner's call with its read-back;
- ``ps_frontier`` (the frontier entry) and ``launch_floor`` (an empty
  kernel queued back to back), where the tree has them (null otherwise).

Needs a CUDA card; imports only torch, numpy and the tree's
``repro_torch``.
"""
import inspect
import json
import sys
import time

sys.path.insert(0, sys.argv[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import evaluators, tpcds  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.amva import ops as amva_ops  # noqa: E402
from repro_torch.kernels.dag_event import ops as dag_ops  # noqa: E402

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(reps):
        fn()
    en.record()
    torch.cuda.synchronize()
    return st.elapsed_time(en) / reps


def host_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def queued_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6) * reps)       # ~1 ms a call at ~2 GHz
    st.record()
    for _ in range(reps):
        fn()
    en.record()
    torch.cuda.synchronize()
    return st.elapsed_time(en) / reps


i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
out = {}

# the draw tables and the fused simulation at dag_sweep's frontier shape
B, K, H, E, S = 16, 4, 3, 8192, 128
lanes = (i32([[48, 24, 12, 4]] * B), f32([[1200.0, 900.0, 1500.0, 2500.0]] * B),
         i32([K] * B), i32([8 * n for n in range(1, 17)]), i32([E] * B),
         f32([9000.0] * B))
seeds = torch.zeros(B, dtype=torch.int64, device=dev)
tables = lambda: dag_ops.dag_streams(lanes[5], seeds, lanes[4],  # noqa: E731
                                     h_users=H, n_events=E)
out["dag_streams"] = {"call": cuda_ms(tables, 200),
                      "host": host_ms(tables, 200),
                      "queued": queued_ms(tables)}
# the depth read on the host, as core/dag.py passes it, where the tree
# takes it
depth = dict(depth=K) if "depth" in inspect.signature(
    dag_ops.sim_batch).parameters else {}
sim = lambda: dag_ops.sim_batch(  # noqa: E731
    lanes[0], lanes[1], lanes[2], lanes[5], lanes[3], seeds, lanes[4], None,
    h_users=H, max_slots=S, n_events=E, warmup_jobs=4, **depth)
out["sim_batch"] = {"host": host_ms(sim, 20), "call": cuda_ms(sim, 5),
                    "jobs": float(sim()[1].sum())}

# the AMVA fixed point at run_fast's frontier: 97 points from nu = 20
prob = tpcds.scenario_problem("Q1", 10, 160_000.0)[0]
cls, vm = prob.classes[0], prob.vm_types[0]
n = 97
nus = np.arange(20, 20 + n)
args = (f32(2.0e6 / (nus * 8)), f32([9000.0] * n), f32([10000.0] * n),
        f32([10.0] * n))
fixed = lambda: amva_ops.ps_fixed_point(*args)  # noqa: E731
one = (f32([2.0e6 / 160]), f32([9000.0]), f32([10000.0]), f32([10.0]))
chain = [cuda_ms(lambda m=m: amva_ops.ps_fixed_point(*one, iters=m), 20)
         for m in (40, 40040)]
out["ps_fixed_point"] = {"call": cuda_ms(fixed, 200),
                         "host": host_ms(fixed, 200),
                         "queued": queued_ms(fixed),
                         "round_ns": (chain[1] - chain[0]) * 1e6 / 40000}
frontier = lambda: evaluators.amva_frontier(cls, vm, 20, 19 + n,  # noqa
                                            device=dev)
out["amva_frontier"] = {"host": host_ms(frontier, 200),
                        "t_sum": float(frontier().astype(np.float64).sum())}
if hasattr(amva_ops, "ps_frontier"):
    entry = lambda: amva_ops.ps_frontier(  # noqa: E731
        2.0e6, 8, 20, n, 9000.0, 10000.0, 10.0, device=dev)
    if not torch.equal(entry(), fixed()):
        raise SystemExit("the frontier entry differs from ps_fixed_point")
    out["ps_frontier"] = {"call": cuda_ms(entry, 200),
                          "host": host_ms(entry, 200),
                          "queued": queued_ms(entry)}
else:
    out["ps_frontier"] = None
lib = build.library()
if hasattr(lib, "launch_floor_launch"):
    empty = lambda: build.launch(dev, lib.launch_floor_launch)  # noqa: E731
    out["launch_floor"] = {"queued": queued_ms(empty),
                           "host": host_ms(empty, 200)}
else:
    out["launch_floor"] = None
print(sys.argv[2], json.dumps(out), flush=True)
