"""Time the flash backward's routes from a given source tree beside
torch's SDPA backward, at the float32 check row and at nemotron-4-340b's
training attention:

    python3 benchmarks/torch_flash_bwd_routes.py <tree>/src <label>

Shapes (``chip_smoke.py``'s FA_BWD_CHECKS rows FA_BWD_F32_ROW and
FA_BWD_NEMOTRON_ROW): ``granite_f32`` B=2, S=1024, H=32, KV=8, Dh=64,
float32, causal; ``nemotron`` B=1, S=4096, H=96, KV=8, Dh=192, bfloat16,
causal.  Inputs are drawn on the card from seed 7, the forward's out and
lse come from the tree's own kernel.

For each shape, the ms a call (CUDA events, after a warm-up call) of:
the simt route's three kernels (``fa_bwd_delta``, ``fa_bwd_dkdv``,
``fa_bwd_dq``), ``flash_attention_bwd`` (the route ``bwd_route`` picks),
where the tree has them the parts kernels one by one (``fa_bwd_prep``,
``fa_bwd_dq_parts``, ``fa_bwd_dkdv_parts``), torch's SDPA backward
through autograd (``enable_gqa``; a yardstick the port never calls) and
the plain version; the function's bound (``chip_smoke.fa_bwd_bounds``)
and the largest difference of each route from the plain version.  The
timing, the inputs and the bound are ``chip_smoke.py``'s (this
checkout's), the kernels the tree's: a tree without the parts kernels
(one before them) is timed all the same.  Prints one JSON line with the
card's name and power limit.  Needs a CUDA card; imports only torch,
``chip_smoke`` and the tree's ``repro_torch``.
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path[:0] = [sys.argv[1], str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

SHAPES = {"granite_f32": (cs.FA_BWD_F32_ROW, 10),   # (row, simt reps)
          "nemotron": (cs.FA_BWD_NEMOTRON_ROW, 3)}


def max_diff(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def main():
    build.library()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"label": sys.argv[2], "card": smi}
    parts = hasattr(ops, "fa_bwd_prep")
    for name, (label, reps) in SHAPES.items():
        _, B, S, H, KV, Dh, causal, window, dtype = cs.fa_bwd_row(label)
        q, k, v, dout = cs.fa_bwd_inputs(dev, B, S, H, KV, Dh, dtype, 7)
        kw = dict(causal=causal, window=window)
        out, lse = ops.flash_attention_fwd(q, k, v, **kw)
        a = (causal, window)
        delta = ops.fa_bwd_delta(out, dout)
        sargs = (q, k, v, dout, lse, delta, *a)
        row = {"shape": cs.fa_bwd_shape(B, S, H, KV, Dh, causal, dtype),
               "route": ops.bwd_route(q, k, v),
               "simt_ms": {
                   "fa_bwd_delta": cs.cuda_ms(lambda: ops.fa_bwd_delta(
                       out, dout), reps),
                   "fa_bwd_dkdv": cs.cuda_ms(lambda: ops.fa_bwd_dkdv(
                       *sargs), reps),
                   "fa_bwd_dq": cs.cuda_ms(lambda: ops.fa_bwd_dq(*sargs),
                                           reps)}}
        row["simt_total_ms"] = sum(row["simt_ms"].values())
        if parts and ops.bwd_kernels(dtype, Dh) == "parts":
            rows, ops_t = ops.fa_bwd_prep(q, k, v, out, dout, lse)
            row["parts_ms"] = {
                "fa_bwd_prep": cs.cuda_ms(lambda: ops.fa_bwd_prep(
                    q, k, v, out, dout, lse), 20),
                "fa_bwd_dq_parts": cs.cuda_ms(lambda: ops.fa_bwd_dq_parts(
                    q, ops_t, rows, *a), 20),
                "fa_bwd_dkdv_parts": cs.cuda_ms(
                    lambda: ops.fa_bwd_dkdv_parts(q, k, ops_t, rows, *a),
                    20)}
            row["parts_total_ms"] = sum(row["parts_ms"].values())
        row["flash_attention_bwd_ms"] = cs.cuda_ms(
            lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw),
            reps)
        row["sdpa_bwd_ms"] = cs.sdpa_bwd_ms(q, k, v, dout, causal, 10)
        row["bound_ms"] = cs.fa_bwd_bounds(B, S, H, KV, Dh, causal, window,
                                           dtype)["function"][0]
        want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        row["plain_ms"] = cs.cuda_ms(lambda: ref.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw), 1)
        row["route_max_diff"] = max_diff(ops.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw), want)
        row["simt_max_diff"] = max_diff(
            (ops.fa_bwd_dq(*sargs), *ops.fa_bwd_dkdv(*sargs)), want)
        res[name] = row
        del q, k, v, dout, out, lse, delta, want
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
