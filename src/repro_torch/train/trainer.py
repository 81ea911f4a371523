"""Trainer: train steps + checkpointing + fault tolerance, on one device
or on a mesh.

The port of `repro.train.trainer`: the train step (train/step.py), the
synthetic data pipeline (prefetch, checkpointable position), asynchronous
atomic checkpoints, auto-resume, simulated failure injection
(`Supervisor`) and straggler monitoring. Without a mesh the state lives
on one device (the card unless ``device="cpu"``). With a `mesh` (a
DeviceMesh over an initialised process group, `launch.mesh`), as the JAX
Trainer: `Rules.make(mesh, cfg, shape)`, parameters and optimizer state
as DTensors at their placements (every rank draws the same parameters
from the seed and keeps its shard), each batch key distributed by
`batch_pspecs` (every rank draws the same `SyntheticLM` batch and keeps
its shard), a replicated loss; checkpoints gather every leaf and rank 0
writes them.

Its stream (`SyntheticLM`) carries tokens and targets only, as the JAX
Trainer's does; the audio and vlm families read frames / patches as well,
so the Trainer refuses them (they train through `make_train_step` on
batches that carry those inputs).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import PrefetchIterator, SyntheticLM
from repro_torch.data.pipeline import to_tensors
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import StragglerMonitor, Supervisor
from repro_torch.distributed.sharding import Rules, local_shard
from repro_torch.models.params import abstract_params, init_params
from repro_torch.optim import SCHEDULES, adamw
from repro_torch.train import step as step_lib


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    schedule: str = "cosine"       # cosine | wsd
    warmup: int = 10
    seed: int = 0
    keep_ckpts: int = 3


class Trainer:
    """`params` (optional) is the master tree to start from, on the
    trainer's device; by default `init_params(cfg, seed=tcfg.seed)`. A
    checkpoint in `tcfg.ckpt_dir` is resumed from."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 settings: step_lib.TrainSettings, tcfg: TrainerConfig,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 *, device=None, params: Optional[dict] = None, mesh=None):
        extra = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
        if extra is not None:
            raise ValueError(
                f"Trainer: the {cfg.family} family reads batch[{extra!r}], "
                f"which the Trainer's SyntheticLM stream does not carry; "
                f"train it through train.step.make_train_step on batches "
                f"with {extra!r}")
        self.cfg, self.shape = cfg, shape
        self.settings, self.tcfg = settings, tcfg
        self.mesh, self.rules = mesh, None
        if mesh is not None:
            if not dist.is_initialized():
                raise RuntimeError(
                    "Trainer: a mesh needs an initialised process group")
            self.rules = Rules.make(mesh, cfg, shape)
            device = mesh.device_type if device is None else device
        self.device = resolve_device(device)
        lr_fn = lambda step: SCHEDULES[tcfg.schedule](
            step, peak_lr=settings.lr, warmup=tcfg.warmup,
            total=tcfg.total_steps)
        self._step_fn = step_lib.make_train_step(cfg, settings, self.rules,
                                                 lr_fn=lr_fn)
        opt_init, _ = adamw.make_optimizer(settings.optimizer)
        if params is None:
            params = init_params(cfg, seed=tcfg.seed, device=self.device)
        put = lambda b: to_tensors(b, self.device)
        if self.rules is not None:
            params = step_lib.distribute(params, abstract_params(cfg),
                                         self.rules)
            b_specs = step_lib.batch_pspecs(cfg, shape, self.rules)
            put = lambda b: {k: local_shard(t, mesh, b_specs[k])
                             for k, t in to_tensors(b, self.device).items()}
        self.state = step_lib.TrainState(
            params, opt_init(params),
            torch.zeros((), dtype=torch.int32, device=self.device))
        self.data = PrefetchIterator(
            SyntheticLM(cfg.vocab, shape.seq_len,
                        shape.global_batch, seed=tcfg.seed),
            put_fn=put)
        self.ckpt = ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir,
                                               keep=tcfg.keep_ckpts)
        self.straggler = StragglerMonitor()
        self.supervisor = Supervisor(self._restore_latest)
        self.failure_injector = failure_injector
        self.losses: list = []
        self._maybe_resume()

    # -- checkpoint/restore --------------------------------------------------

    def _save(self, step: int) -> None:
        self.ckpt.save(step, self.state,
                       extra={"data": self.data.state_dict(),
                              "losses": [float(l) for l in self.losses]})

    def _maybe_resume(self) -> None:
        latest = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if latest is not None:
            self._restore(latest)

    def _restore_latest(self) -> int:
        self.ckpt.wait()
        if self.mesh is not None:
            dist.barrier()      # rank 0's write is on disk for every rank
        latest = ckpt_lib.latest_step(self.tcfg.ckpt_dir)
        if latest is None:
            raise RuntimeError("failure before any checkpoint")
        self._restore(latest)
        return latest

    def _restore(self, step: int) -> None:
        self.state, extra = ckpt_lib.restore(self.tcfg.ckpt_dir, step,
                                             self.state)
        self.data.load_state_dict(extra["data"])
        self.losses = list(extra.get("losses", []))

    # -- loop -----------------------------------------------------------------

    def current_step(self) -> int:
        return int(self.state.step)

    def train(self, n_steps: Optional[int] = None) -> list:
        target = (self.tcfg.total_steps if n_steps is None
                  else self.current_step() + n_steps)
        while self.current_step() < target:
            step = self.current_step()

            def one():
                if self.failure_injector is not None:
                    self.failure_injector(step)
                batch = next(self.data)
                t0 = time.time()
                self.state, loss = self._step_fn(self.state, batch)
                loss = float(loss)
                self.straggler.record(step, time.time() - t0)
                self.losses.append(loss)
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self._save(step + 1)

            self.supervisor.run_step(one)
        self.ckpt.wait()
        return self.losses

    def close(self):
        self.data.close()
        self.ckpt.wait()
