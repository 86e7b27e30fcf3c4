"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains a reduced (smoke) config of any registry arch, or with ``--full``
its full-size config, through the trainer (synthetic data, AdamW in the
config's optimizer mode, checkpoints with ``--ckpt-dir``).  ``--device``
defaults to the CUDA card and fails without one; ``--device cpu`` runs
the plain PyTorch versions of the kernels.  A Mamba2 or hybrid arch needs
``--seq`` a multiple of its SSD chunk (128 at full size, 16 in the smoke
configs) or under it.

    python -m repro_torch.launch.train --arch granite-3-2b --full \\
        --steps 4 --batch 8 --seq 1024
    python -m repro_torch.launch.train --arch mamba2-780m --full \\
        --steps 4 --batch 8 --seq 1024
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="the full-size config (one card must hold it)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    tc = TrainerConfig(
        steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup=max(10, args.steps // 20),
                        mode=cfg.optimizer_mode))
    trainer = Trainer(cfg, tc, device=args.device)
    state, step = trainer.run()
    losses = trainer.losses()
    print(f"[train] done at step {step}: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} over {len(losses)} steps", flush=True)
    return trainer


if __name__ == "__main__":
    main()
