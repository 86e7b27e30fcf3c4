"""Time the QN event loop (``qn_event``, on the route the library names)
from a given source tree, so that two trees can be compared on one card in
one process each, in turns:

    python3 benchmarks/torch_qn_event_ab.py <tree>/src <label>

e.g. a parent unpacked into a gitignored directory (``git archive``) and
the working tree, run parent, change, change, parent.  The lanes are the
paper's Q1-10u scenario (``tpcds.scenario_problem("Q1", 10, 160_000.0)``:
500 maps, 1 reduce, 10 s think, its replay lists, m4.xlarge), seed 0 and
1000 as ``chip_smoke.py`` draws them, at three shapes:

  * ``b32``: the batched run's dispatch, 32 lanes of 131072 events at 512
    slots (caps nu * 8 from the top of the bucket down), H = 10;
  * ``b1``: a point-wise probe, one lane of 131072 events at 384 slots;
  * ``wide_h10`` / ``wide_h20``: a cost_deadline probe past 512 slots, one
    lane of cap 8000 in a batch of 8192 slots, 65536 events of which
    37725 active (Q1's ``events_needed``), H = 10 and 20; there the
    general kernel (``general=True``) is timed too;
  * ``cap_h64`` / ``cap_h2048``: a capacity planner's serving lane past
    its 512 events (one map and one reduce a job, exponential means of 40
    and 60 ms): one lane of 16384 events, H = 64 in 64 slots (150 ms
    think) and H = 2048 in 384 (330 ms), on the route the library names
    (``qn_event_many`` since it exists) and on the general kernel.

Prints the label and per shape ``(ms a launch, ns an event, the route's
launches, the response sum, the job count)`` over 5 launches after a
warm-up one (CUDA events); ns an event is over the active events.  Needs
a CUDA card; imports only torch, numpy and the tree's ``repro_torch``.
"""
import sys

sys.path.insert(0, sys.argv[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import tpcds  # noqa: E402
from repro_torch.kernels.qn_event import ops  # noqa: E402

dev = torch.device("cuda", 0)
i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
prob, samples, _ = tpcds.scenario_problem("Q1", 10, 160_000.0)
cls, vm = prob.classes[0], prob.vm_types[0]
prof = cls.profile_for(vm)
m_s, r_s = (f32(np.asarray(x, np.float32))
            for x in samples[(cls.name, vm.name)])


def lanes(B, E, active, S, H, caps):
    args = (i32([prof.n_map] * B), i32([prof.n_reduce] * B), i32(caps),
            i32([active] * B), f32([0.0] * B), f32([0.0] * B),
            f32([cls.think_ms] * B))
    seeds = torch.tensor(1000 * (np.arange(B) % 2), dtype=torch.int64,
                         device=dev)
    tables = ops.event_streams(args[6], seeds, args[3], h_users=H,
                               n_events=E, m_samples=m_s, r_samples=r_s)
    return args, tables


def cap_lanes(E, S, H, think):
    args = (i32([1]), i32([1]), i32([S]), i32([E]), f32([40.0]),
            f32([60.0]), f32([think]))
    tables = ops.event_streams(
        args[6], torch.tensor([5], dtype=torch.int64, device=dev), args[3],
        h_users=H, n_events=E)
    return args, tables


def timed(args, tables, S, active, general=False, replay=True):
    def run():
        return ops.qn_event(*args, *tables, max_slots=S, warmup_jobs=8,
                            replay=replay, general=general)

    before = dict(ops.qn_event.routes)
    s, c = run()
    torch.cuda.synchronize()
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(5):
        run()
    en.record()
    torch.cuda.synchronize()
    ms = st.elapsed_time(en) / 5
    took = [r for r, n in ops.qn_event.routes.items() if n > before.get(r, 0)]
    return (ms, ms * 1e6 / active, took, float(s.sum()), float(c.sum()))


out = {}
slots = vm.slots
nu_top = 512 // slots
out["b32"] = timed(*lanes(32, 131072, 131072, 512, 10,
                          [max(1, nu_top - k // 2) * slots
                           for k in range(32)]), 512, 131072)
out["b1"] = timed(*lanes(1, 131072, 131072, 384, 10, [384]), 384, 131072)
for H in (10, 20):
    a, t = lanes(1, 65536, 37725, 8192, H, [8000])
    out[f"wide_h{H}"] = timed(a, t, 8192, 37725)
    out[f"wide_h{H}_general"] = timed(a, t, 8192, 37725, general=True)
for H, S, think in ((64, 64, 150.0), (2048, 384, 330.0)):
    a, t = cap_lanes(16384, S, H, think)
    out[f"cap_h{H}"] = timed(a, t, S, 16384, replay=False)
    out[f"cap_h{H}_general"] = timed(a, t, S, 16384, general=True,
                                     replay=False)
print(sys.argv[2], out, flush=True)
