"""Time the DAG event loop (``dag_event``, on the route ``ops.route`` names:
``dag_event_fast`` here) from a given source tree, so that two trees can
be compared on one card in one process each, in turns:

    python3 benchmarks/torch_dag_event_ab.py <tree>/src <label>

e.g. a parent unpacked into a gitignored directory (``git archive``) and
the working tree, run parent, change, change, parent.  The lanes are 16
candidates of a 4-stage chain with dag_sweep's frontier widths (the Spark
chain's 48/24/12/4 tasks, stage means 1200/900/1500/2500 ms, 3 users, 9 s
think, 8..128 slots in a 128-slot batch, seed 0, exponential mode) at
E = 8192 (warm-up 4) and E = 16384 (warm-up 8).  Prints the label, for
each E ``(ms a launch, ns an event, the response sum, the job count)``
over 10 launches after a warm-up one (CUDA events), and the launches by
route.  Needs a CUDA card; imports only torch and the tree's
``repro_torch``.
"""
import inspect
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.kernels.dag_event import ops  # noqa: E402

dev = torch.device("cuda", 0)
i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
B, K, H = 16, 4, 3
nus = list(range(1, 17))
out = {}
# the stage depth given where the tree takes it, as core/dag.py gives it
# (else the wrapper reads it from the card before each launch)
depth = dict(depth=K) if "depth" in inspect.signature(
    ops.dag_event).parameters else {}
for E, warm in ((8192, 4), (16384, 8)):
    lanes = (i32([[48, 24, 12, 4]] * B),
             f32([[1200.0, 900.0, 1500.0, 2500.0]] * B),
             i32([K] * B), i32([8 * n for n in nus]), i32([E] * B),
             f32([9000.0] * B))
    tab = ops.dag_streams(lanes[5], torch.zeros(B, dtype=torch.int64,
                                                device=dev),
                          lanes[4], h_users=H, n_events=E)

    def run():
        return ops.dag_event(*lanes, *tab, None, max_slots=128,
                             warmup_jobs=warm, **depth)

    s, c = run()
    torch.cuda.synchronize()
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(10):
        run()
    en.record()
    torch.cuda.synchronize()
    ms = st.elapsed_time(en) / 10
    out[E] = (ms, ms * 1e6 / E, float(s.sum()), float(c.sum()))
print(sys.argv[2], out, dict(ops.dag_event.routes), flush=True)
