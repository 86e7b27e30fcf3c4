"""Time the float32 flash forward's two routes from a given source tree:

    python3 benchmarks/torch_flash_f32_routes.py <tree>/src <label>

At granite-3-2b's heads (``chip_smoke.FA_F32_TIME``: B=4, S=1024, H=32,
KV=8, Dh=64, causal) and at head dim 128 (B=2, S=1024, H=32, KV=8),
``chip_smoke.time_flash_f32``: the wgmma route's call (``fa_fwd_split``
then ``fa_fwd_parts_kernel``) and ``fa_f32_kernel``'s
(``ops.flash_attention_simt``) in turns on the same inputs, each kernel
alone and on the device, the plain versions, torch's SDPA in float32 (a
yardstick the port never calls), the bounds, and each route's largest
error against plain.  The
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
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

SHAPES = {"granite_f32": cs.FA_F32_TIME, "dh128": (2, 1024, 32, 8, 128)}


def main():
    build.library()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"label": sys.argv[2], "card": smi}
    for name, shape in SHAPES.items():
        res[name] = cs.time_flash_f32(dev, ops, ref, *shape)
        torch.cuda.empty_cache()
    print(json.dumps(res, default=str), flush=True)


if __name__ == "__main__":
    main()
