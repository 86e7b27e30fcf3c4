"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.
Random-inits a reduced (smoke) config of any registry arch from a seeded
generator on the device, in its working dtypes
(``serve.step.init_working_params``), serves a synthetic request stream
through the batching engine and prints latency/throughput.  The audio
(``whisper-tiny``) and vision (``phi-3-vision-4.2b``) archs get the
engine's front-end stub: zero frame or patch embeddings.  ``--device``
defaults to the CUDA card and fails without one; ``--device cpu`` runs
the plain PyTorch versions of the kernels.

As in the reference, every request of a round is left-padded to the
round's longest prompt, and a Mamba2 (``mamba2-780m``) or hybrid
(``zamba2-7b``) prefill needs that length to be a multiple of the SSD
chunk: 16 in the smoke configs, so pass e.g. ``--prompt 32`` (the default
of 24 raises ``ValueError`` for them)."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.serve.engine import BatchingEngine
from repro_torch.serve.step import init_working_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_working_params(cfg, gen)
    eng = BatchingEngine(cfg, params, max_batch=args.batch)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=args.prompt).tolist()
        eng.submit(prompt, gen_len=args.gen)
    done = eng.run()
    summary = BatchingEngine.summarize(done)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
