"""Capacity-planner CLI, the reference's ``launch/plan``: the
D-SPACE4Cloud tool for TPU fleets.

    python -m repro_torch.launch.plan serve --arch granite-3-2b \\
        --sessions 64 --deadline-ms 20000
    python -m repro_torch.launch.plan train --arch gemma3-27b \\
        --steps 100000 --deadline-h 336

Reads roofline profiles from a dry-run record (``--dryrun``, by default
``results/dryrun.json``, which the reference's multi-device dry run
writes) and prints the cost-optimal slice type, count and
reserved/preemptible mix as the reference's CLI prints them.  ``--device``
is where the serving plan's QN probes run: the CUDA card by default (it
fails without one); ``--device cpu`` runs the plain PyTorch event loop.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.capacity import (
    ServingClass,
    TPUCapacityPlanner,
    TrainClass,
    load_dryrun,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["serve", "train"])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--dryrun", default="results/dryrun.json")
    # serving
    ap.add_argument("--sessions", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=256)
    ap.add_argument("--think-ms", type=float, default=10_000)
    ap.add_argument("--deadline-ms", type=float, default=30_000)
    ap.add_argument("--eta", type=float, default=0.3)
    ap.add_argument("--no-qn", action="store_true",
                    help="analytic initial solution only (no QN verify)")
    # training
    ap.add_argument("--steps", type=int, default=50_000)
    ap.add_argument("--deadline-h", type=float, default=336.0)
    ap.add_argument("--device", default=None,
                    help="torch device of the QN probes (default: the "
                         "current CUDA card)")
    args = ap.parse_args(argv)

    planner = TPUCapacityPlanner(load_dryrun(args.dryrun),
                                 device=args.device)
    if args.mode == "serve":
        cls = ServingClass(
            name=f"serve-{args.arch}", arch=args.arch,
            prompt_len=args.prompt, gen_len=args.gen,
            h_sessions=args.sessions, think_ms=args.think_ms,
            deadline_ms=args.deadline_ms, eta=args.eta)
        sols = planner.plan_serving([cls], use_qn=not args.no_qn)
    else:
        cls = TrainClass(name=f"train-{args.arch}", arch=args.arch,
                         steps=args.steps, deadline_h=args.deadline_h,
                         eta=args.eta)
        sols = planner.plan_training([cls])

    for name, sol in sols.items():
        print(json.dumps({"class": name, **sol.as_dict()}, indent=1))
    return sols


if __name__ == "__main__":
    main()
