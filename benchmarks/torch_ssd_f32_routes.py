"""Time the SSD forward's routes from a given source tree:

    python3 benchmarks/torch_ssd_f32_routes.py <tree>/src <label>

At mamba2-780m's prefill shape in float32 (``chip_smoke.SSD_F32_TIME``:
B=4, S=1024, H=48, P=64, N=128, chunk 128), ``chip_smoke.time_ssd_f32``:
the parts route's call (``ssd_split``, then the four parts kernels) and
``ssd_f32_kernel``'s (``ops.launch(..., "f32")``) in turns on the same
float32 inputs, the split and the parts kernels alone and each kernel on
the device, the plain versions, the bounds, and each route's largest
error against plain.  A tree without the parts route times
``ssd_f32_kernel`` alone.  Then ``chip_smoke.time_ssd``: the bf16 wgmma
route at mamba2-780m's and zamba2-7b's prefill shapes (the call, its
device time from the profiler and queued, the host's time a call).  The
timing is this checkout's ``chip_smoke.py``, the kernels the tree's.
Prints one JSON line with the card's name and power limit.  Needs a CUDA
card; imports only torch, ``chip_smoke`` and the tree's ``repro_torch``.
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path[:0] = [sys.argv[1], str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402


def main():
    build.library()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"label": sys.argv[2], "card": smi}
    if hasattr(ops, "ssd_split"):
        res["mamba2_f32"] = cs.time_ssd_f32(dev, ops, ref, *cs.SSD_F32_TIME)
    else:
        args = cs.ssd_inputs(dev, *cs.SSD_F32_TIME, cs.F32_3, 7)
        res["mamba2_f32"] = {"f32_ms": cs.cuda_ms(
            lambda: ops.launch(*args, 128, "f32"), 10)}
        print(f"[time] ssd_f32_kernel {res['mamba2_f32']['f32_ms']:.4f} ms",
              flush=True)
    res["bf16"] = cs.time_ssd(dev, ops, ref)
    print(json.dumps(res, default=str), flush=True)


if __name__ == "__main__":
    main()
