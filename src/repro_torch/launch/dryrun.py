"""Dry run of every (arch x shape x mesh) cell, allocating nothing: the
port of `repro.launch.dryrun`.

The JAX tool lowers and compiles each cell for 256 or 512 host
stand-ins and reads the roofline terms from the compiled artifact. Here
the device is `meta`, by design (it is not a CPU fallback), and no
process group exists:

  * the mesh is a stand-in with a `shape` dict, (16, 16) over ("data",
    "model") or (2, 16, 16) with "pod" in front (`Rules` reads nothing
    but the axis sizes); `run_cell(mesh=...)` takes any other, and the
    single-pod run records every cell at `NODE_MESH`, (32, 8), too;
  * per-device argument bytes are exact, from `Rules.make` at the card's
    `HBM_BYTES` and the pspecs of `train/step.py`: the parameters, the
    optimizer state of a train cell, the cache of a decode cell and the
    inputs of `configs.input_specs`;
  * the unsharded global step (`make_train_step`, `make_prefill_step`,
    `make_decode_step` over `model.abstract_cache`) is traced once on
    `meta` under `launch.op_analysis.OpAnalysis`: FLOPs, bytes and
    kernel launches a step. The per-device FLOPs and bytes are those
    totals over the mesh's devices, which assumes an even partition.

Collectives are absent from the record, not zero: the JAX tool reads
them from XLA's partitioned HLO, and without ranks the port has no
partitioned program to read. A device's memory is its arguments plus
the temporaries: the trace's peak live bytes over the devices (an even
partition again).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k [--multi-pod] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCHS, SHAPES, cell_applicable, get_arch,
                                 get_shape, input_specs)
from repro_torch.distributed.sharding import Rules
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.op_analysis import analyze as analyze_ops
from repro_torch.models import model as M
from repro_torch.models.params import abstract_params
from repro_torch.train import step as step_lib
from repro_torch.tree import flatten, tree_map

COLLECTIVES_NOTE = ("collectives need ranks: the port has no partitioned "
                    "program to read them from (queued in ROADMAP)")
PARTITION_NOTE = "traced totals of the unsharded step / n_devices (even)"
GiB16 = 16 * 1024 ** 3
# the other layout of 256 cards the single-pod run records: an H100 node's
# NVLink domain is 8 GPUs, so the model axis inside a node
NODE_MESH = {"data": 32, "model": 8}


class StandInMesh:
    """A mesh of axis sizes only: what `Rules` reads, no devices."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values())


def stand_in_mesh(multi_pod: bool = False) -> StandInMesh:
    """The production layouts of `launch.mesh`: (16, 16) or (2, 16, 16)."""
    shape, names = ((mesh_lib.MULTIPOD_SHAPE, mesh_lib.MULTIPOD_AXES)
                    if multi_pod else (mesh_lib.POD_SHAPE, mesh_lib.POD_AXES))
    return StandInMesh(dict(zip(names, shape)))


def default_settings(cfg) -> step_lib.TrainSettings:
    """The JAX tool's rule: AMC-Adam over 5e10 parameters; gradient
    accumulation 4 over 1e11, 2 over 8e9, else 1 (it balances FSDP
    weight-gather traffic against activation memory)."""
    n = cfg.param_count()
    accum = 4 if n > 1e11 else (2 if n > 8e9 else 1)
    return step_lib.TrainSettings(
        optimizer="amc_adamw" if n > 5e10 else "adamw",
        grad_accum=accum, q_chunk=1024)


def shard_nbytes(shape, dtype: torch.dtype, spec, axes: dict) -> int:
    """Bytes one device holds of a tensor laid out at pspec `spec`: each
    dim over the product of its mesh axes, rounded up (an uneven shard
    is padded)."""
    n = dtype.itemsize
    for d, ax in zip(shape, spec):
        parts = math.prod(axes[a] for a in ax) if ax else 1
        n *= -(-d // parts)
    return n


def tree_shard_nbytes(abstract, rules: Rules) -> int:
    """Per-device bytes of a tree of `PSpec` leaves."""
    axes = rules.axis_sizes
    return sum(flatten(tree_map(
        lambda l: shard_nbytes(l.shape, l.dtype, rules.pspec(*l.axes), axes),
        abstract))[0])


def cell_bytes(cfg, shape, rules: Rules, settings) -> dict:
    """Per-device argument bytes of the cell's step: parameters,
    optimizer state and step counter (train), cache (decode) and
    inputs."""
    axes = rules.axis_sizes
    ap = abstract_params(cfg)
    out = {"params": tree_shard_nbytes(ap, rules), "opt": 0, "step": 0,
           "cache": 0}
    if shape.kind == "train":
        out["opt"] = tree_shard_nbytes(
            step_lib.opt_abstract(ap, settings.optimizer), rules)
        out["step"] = 4
    elif shape.kind == "decode":
        out["cache"] = tree_shard_nbytes(
            M.abstract_cache(cfg, shape.global_batch, shape.seq_len), rules)
    specs = step_lib.batch_pspecs(cfg, shape, rules)
    out["inputs"] = sum(shard_nbytes(t.shape, t.dtype, specs[k], axes)
                        for k, t in input_specs(cfg, shape).items())
    return out


def _on_meta(abstract):
    return tree_map(lambda l: torch.empty(l.shape, dtype=l.dtype,
                                          device="meta"), abstract)


def cell_step(cfg, shape, settings):
    """(step fn, its meta arguments): the unsharded global step of the
    cell, on the abstract trees and `input_specs`."""
    ap = abstract_params(cfg)
    params, batch = _on_meta(ap), input_specs(cfg, shape)
    if shape.kind == "train":
        state = step_lib.TrainState(
            params,
            _on_meta(step_lib.opt_abstract(ap, settings.optimizer)),
            torch.empty((), dtype=torch.int32, device="meta"))
        return step_lib.make_train_step(cfg, settings), (state, batch)
    if shape.kind == "prefill":
        return step_lib.make_prefill_step(cfg, settings), (params, batch)
    cache = _on_meta(M.abstract_cache(cfg, shape.global_batch,
                                      shape.seq_len))
    return step_lib.make_decode_step(cfg), (params, cache, batch)


def build_cell(arch: str, shape_name: str, mesh, settings=None):
    """(step fn, its meta arguments, per-device argument bytes) of one
    cell: the unsharded global step, and the bytes its arguments take on
    one device of `mesh` under the port's rules."""
    cfg, shape = get_arch(arch), get_shape(shape_name)
    settings = settings or default_settings(cfg)
    fn, args = cell_step(cfg, shape, settings)
    return fn, args, cell_bytes(cfg, shape, Rules.make(mesh, cfg, shape),
                                settings)


def trace(fn, args, watch=()) -> tuple:
    """(outputs, `OpAnalysis` totals) of one call of `fn` on `args`."""
    return analyze_ops(fn, *args, watch=watch)


_last_trace: dict = {}


def _trace_cell(key: tuple, fn, args) -> tuple:
    """`trace` of a cell's step, kept for the cell's next layout (the
    unsharded step does not depend on the mesh)."""
    if key not in _last_trace:
        _last_trace.clear()
        _last_trace[key] = trace(fn, args)
    return _last_trace[key]


def output_bytes(cfg, shape, rules: Rules, out) -> int:
    """Per-device bytes of what the step returns beside what it writes in
    place: a train step's loss (its new state goes into the donated
    state); a prefill / decode step's float32 logits at ("batch", None,
    "vocab") and its cache at the cache pspecs."""
    if shape.kind == "train":
        return 4
    axes = rules.axis_sizes
    return shard_nbytes(out[0].shape, out[0].dtype,
                        rules.pspec("batch", None, "vocab"), axes) \
        + tree_shard_nbytes(M.abstract_cache(cfg, shape.global_batch,
                                             shape.seq_len), rules)


def analyze(totals: dict, arg_bytes: dict, out_bytes: int, cfg, shape,
            mesh) -> dict:
    """The record of one traced cell (`repro.launch.dryrun.analyze`'s
    keys where the port has the quantity)."""
    n_dev = mesh.n_devices
    flops_dev = totals["flops"] / n_dev
    bytes_dev = totals["bytes_accessed"] / n_dev
    temp_dev = totals["peak_live_bytes"] / n_dev
    compute_s = flops_dev / mesh_lib.PEAK_BF16_FLOPS
    memory_s = bytes_dev / mesh_lib.HBM_BW
    model_flops_dev = cfg.model_flops(shape) / n_dev
    terms = {"compute_s": compute_s, "memory_s": memory_s}
    dominant = max(terms, key=terms.get)
    args = sum(arg_bytes.values())
    total = args + temp_dev
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": dict(mesh.shape),
        "n_devices": int(n_dev),
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "partition": PARTITION_NOTE,
        "collectives": None, "collectives_note": COLLECTIVES_NOTE,
        "compute_s": compute_s, "memory_s": memory_s, "dominant": dominant,
        "model_flops_per_device": model_flops_dev,
        "useful_flops_ratio": (model_flops_dev / flops_dev
                               if flops_dev else 0.0),
        "roofline_fraction": (compute_s / max(terms.values())
                              if max(terms.values()) > 0 else 0.0),
        "memory": {
            "argument_bytes": args, "arguments": dict(arg_bytes),
            "output_bytes": out_bytes, "temp_bytes": temp_dev,
            "total_gib_per_device": total / 2 ** 30,
            "fits_80gb": bool(total < mesh_lib.HBM_BYTES),
            "note": "arguments + temporaries; temporaries (outputs "
                    "included) are the traced step's peak live bytes / "
                    "n_devices (even)",
        },
        "kernels": {k: v["launches"] for k, v in totals["kernels"].items()},
        "ops": sum(totals["ops_by_name"].values()),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = "results/dryrun_torch", settings=None,
             mesh=None) -> dict:
    """Trace one cell and write its record. `mesh` (a `shape` dict or a
    stand-in, such as `NODE_MESH`) replaces the production layout; its
    record's file is tagged with its axis sizes."""
    if mesh is None:
        mesh = stand_in_mesh(multi_pod)
        layout = "multipod" if multi_pod else "pod"
    else:
        mesh = mesh if hasattr(mesh, "n_devices") else StandInMesh(mesh)
        layout = "x".join(str(v) for v in mesh.shape.values())
    cfg, shape = get_arch(arch), get_shape(shape_name)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "skipped": True,
               "reason": reason}
    else:
        t0 = time.time()
        settings = settings or default_settings(cfg)
        fn, args, arg_bytes = build_cell(arch, shape_name, mesh, settings)
        out, totals = _trace_cell((arch, shape_name, settings), fn, args)
        rules = Rules.make(mesh, cfg, shape)
        rec = analyze(totals, arg_bytes, output_bytes(cfg, shape, rules,
                                                      out), cfg, shape, mesh)
        if shape.kind != "train":
            # the inference profile keeps FSDP ("embed" over "data") only
            # where the TP-sharded weights take half a device's memory
            rec["inference_fsdp"] = bool(rules.resolve("embed"))
            rec["inference_fsdp_at_16gib"] = bool(Rules.make(
                mesh, cfg, shape, hbm_bytes=GiB16).resolve("embed"))
        rec.update({"skipped": False, "trace_s": time.time() - t0})
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}_{shape_name}_{layout}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()

    cells = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    # the single-pod run records each cell at NODE_MESH too (per-device
    # bytes of the other layout of 256 cards; the trace is shared)
    meshes = [None] if args.multi_pod else [None, NODE_MESH]
    failures = []
    for (a, s), m in ((c, m) for c in cells for m in meshes):
        try:
            rec = run_cell(a, s, args.multi_pod, args.out, mesh=m)
            status = ("SKIP " + rec.get("reason", "")[:40] if rec["skipped"]
                      else f"ok dom={rec['dominant']} "
                           f"comp={rec['compute_s']:.3e}s "
                           f"mem={rec['memory_s']:.3e}s "
                           f"hbm={rec['memory']['total_gib_per_device']:.2f}"
                           f"GiB")
        except Exception as e:
            traceback.print_exc()
            failures.append((a, s, str(e)[:200]))
            status = "FAIL " + str(e)[:120]
        lay = "" if m is None else "x".join(map(str, m.values()))
        print(f"[dryrun] {a:24s} {s:12s} {lay:5s} {status}", flush=True)
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("all cells passed")


if __name__ == "__main__":
    main()
