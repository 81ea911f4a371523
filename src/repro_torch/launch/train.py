"""Training launcher, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 50 --batch 8 --seq 128 [--optimizer amc_adamw]

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen1.5-0.5b --reduced --steps 6 --batch 4 --seq 32

The flags are those of `repro.launch.train`. Weights are random, from
seed 0; the data is `SyntheticLM`'s stream. ``--mesh pod`` and
``--mesh multipod`` exit with code 2: the port has no sharding yet.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.train import TrainSettings
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "amc_adamw"])
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--mesh", default="local",
                    choices=["local", "pod", "multipod"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' is the only "
                         "way onto the CPU)")
    args = ap.parse_args(argv)
    if args.mesh != "local":
        print(f"--mesh {args.mesh}: the port has no sharded training yet "
              f"(distributed/sharding.py is not ported); use --mesh local",
              file=sys.stderr)
        sys.exit(2)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    settings = TrainSettings(optimizer=args.optimizer, lr=args.lr,
                             grad_accum=args.grad_accum,
                             q_chunk=min(1024, args.seq))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         schedule=args.schedule,
                         warmup=max(2, args.steps // 10),
                         ckpt_every=max(5, args.steps // 5))
    try:
        tr = Trainer(cfg, shape, settings, tcfg, device=args.device)
    except ValueError as e:     # audio / vlm: the stream has no frames
        print(e, file=sys.stderr)
        sys.exit(2)
    losses = tr.train()
    print(f"[train] {cfg.name}: step {tr.current_step()} "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    tr.close()


if __name__ == "__main__":
    main()
