"""Training launcher, on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 50 --batch 8 --seq 128 [--optimizer amc_adamw]

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen1.5-0.5b --reduced --steps 6 --batch 4 --seq 32

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen1.5-0.5b --steps 50 --batch 8 --seq 128 --mesh local

The flags are those of `repro.launch.train`. Weights are random, from
seed 0; the data is `SyntheticLM`'s stream. ``--mesh local`` trains on
one device in a single process, and under a launcher's world of N ranks
(torchrun's environment) on the (N, 1) ("data", "model") mesh, one card
a rank (the CPU with gloo under ``--device cpu``). ``--mesh pod`` and
``--mesh multipod`` build the (16, 16) and (2, 16, 16) production
meshes, and exit with code 2, naming the world they need, under any
other world size.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.launch import mesh as mesh_lib
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
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh != "local":
        need = math.prod(mesh_lib.MULTIPOD_SHAPE if args.mesh == "multipod"
                         else mesh_lib.POD_SHAPE)
        if world != need:
            print(f"--mesh {args.mesh}: the production mesh needs a world "
                  f"of {need} ranks (torchrun); this one has {world}",
                  file=sys.stderr)
            sys.exit(2)
    mesh = None
    if world > 1 or args.mesh != "local":
        device = _join_world(args.device)
        args.device = str(device)
        mesh = (mesh_lib.make_local_mesh(device.type) if args.mesh == "local"
                else mesh_lib.make_production_mesh(
                    multi_pod=args.mesh == "multipod",
                    device_type=device.type))

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
        tr = Trainer(cfg, shape, settings, tcfg, device=args.device,
                     mesh=mesh)
    except ValueError as e:     # audio / vlm: the stream has no frames
        print(e, file=sys.stderr)
        sys.exit(2)
    losses = tr.train()
    if mesh is None or dist.get_rank() == 0:
        print(f"[train] {cfg.name}: step {tr.current_step()} "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    tr.close()
    if mesh is not None:
        dist.destroy_process_group()


def _join_world(device):
    """Initialise the process group from the launcher's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE): NCCL with one card a
    rank (LOCAL_RANK), or gloo on the CPU. Returns this rank's device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


if __name__ == "__main__":
    main()
