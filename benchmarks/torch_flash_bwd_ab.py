"""Time the flash backward's wgmma route (``fa_bwd_dq_wgmma``, which
writes the rows buffer, then ``fa_bwd_dkdv_wgmma``) from a given source tree,
so that two trees can be compared on one card in one process each, in
turns:

    python3 benchmarks/torch_flash_bwd_ab.py <tree>/src <label>

e.g. a parent unpacked into a gitignored directory (``git archive``) and
the working tree, run parent, change, change, parent.  The shapes are
``chip_smoke.py``'s FA_BWD_CHECKS rows in bfloat16: granite-3-2b's
training shape (B=8, S=1024, H=32, KV=8, Dh=64, causal), gemma3-27b's
local window (B=1, S=2048, H=32, KV=16, Dh=128, window 1024),
llama4-scout's GQA group 5 (B=1, S=1024, H=40, KV=8, Dh=128), zamba2-7b's
head dim 112 (B=2, S=896, H=KV=32) and whisper-tiny's non-causal encoder
(B=4, S=1500, H=KV=6, Dh=64); inputs drawn on the card from seed 7, the
forward's out and lse from the tree's own kernel.

Prints one JSON line: the label, the card, the ptxas performance notes
(C75xx) on the backward's kernels of a fresh build, and per shape the ms
of a dq launch and of a dkdv launch (CUDA events, 30 launches after a
warm-up one), and the largest difference of the route's (dq, dk, dv)
from the simt route's.  A tree that lacks these wrappers (one before
the wgmma route) cannot be timed by this script.  Needs a CUDA card; imports only
torch and the tree's ``repro_torch``.
"""
import json
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

SHAPES = {  # label: (B, S, H, KV, Dh, causal, window)
    "granite_training": (8, 1024, 32, 8, 64, True, 0),
    "gemma3_window": (1, 2048, 32, 16, 128, True, 1024),
    "llama4_group5": (1, 1024, 40, 8, 128, True, 0),
    "zamba2_dh112": (2, 896, 32, 32, 112, True, 0),
    "whisper_encoder": (4, 1500, 6, 6, 64, False, 0),
}


def cuda_ms(fn, reps):
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


def main():
    build.library()
    notes = [ln[ln.find("(C75"):][:90] for ln in build.build_log.splitlines()
             if "(C75" in ln and "wgmma_kernel" in ln and "fa_bwd" in ln]
    dev = torch.device("cuda", 0)
    res = {"label": sys.argv[2], "card": torch.cuda.get_device_name(0),
           "ptxas_notes": notes}
    for name, (B, S, H, KV, Dh, causal, window) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v, dout = (torch.randn((B, S, n, Dh), generator=g, device=dev
                                     ).to(torch.bfloat16)
                         for n in (H, KV, KV, H))
        out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window)
        _, rows = ops.fa_bwd_dq_wgmma(q, k, v, out, dout, lse, causal,
                                      window)
        row = {"dq_ms": cuda_ms(lambda: ops.fa_bwd_dq_wgmma(
                   q, k, v, out, dout, lse, causal, window), 30),
               "dkdv_ms": cuda_ms(lambda: ops.fa_bwd_dkdv_wgmma(
                   q, k, v, dout, rows, causal, window), 30)}
        got = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                      causal=causal, window=window)
        delta = ops.fa_bwd_delta(out, dout)
        dk, dv = ops.fa_bwd_dkdv(q, k, v, dout, lse, delta, causal, window)
        simt = (ops.fa_bwd_dq(q, k, v, dout, lse, delta, causal, window),
                dk, dv)
        row["max_diff_vs_simt"] = max(float((a.float() - b.float()).abs()
                                            .max()) for a, b in zip(got, simt))
        res[name] = row
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
