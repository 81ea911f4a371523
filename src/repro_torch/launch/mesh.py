"""Device meshes over the process group, and the card's constants.

The port of `repro.launch.mesh`. Single pod: (16, 16) over ("data",
"model"), 256 ranks; multi-pod: (2, 16, 16) over ("pod", "data",
"model"), 512 ranks, the "pod" axis carrying pure data parallelism (and,
optionally, the microbatch pipeline of `distributed/pipeline.py`), with
the compressed gradient all-reduce across its slow links. The shapes are
the JAX package's so that `Rules` decide as its rules do; on H100 nodes
an NVLink domain is 8 GPUs, so a (32, 8) layout (the model axis inside a
node) is an open question of the production layout.

Every mesh is a `torch.distributed.device_mesh.DeviceMesh` over an
initialised process group: the launcher (`torchrun`) or the caller
initialises it, with its address, world size and rank; nothing here
initialises one.

Functions, not module constants: importing this module touches no device
and no process group.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")


def world_size() -> int:
    """Ranks of the initialised process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A DeviceMesh of `shape` over `names` on the initialised process
    group, whose world must be prod(shape) ranks. Raises without a
    process group: a mesh never stands for the unsharded path."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no initialised process group (call "
            "torch.distributed.init_process_group, or launch with torchrun)")
    need = math.prod(shape)
    if dist.get_world_size() != need:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} ranks; the "
                         f"process group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model"): 256 or 512 ranks, and a ValueError naming that size when
    the world is another."""
    shape, names = ((MULTIPOD_SHAPE, MULTIPOD_AXES) if multi_pod
                    else (POD_SHAPE, POD_AXES))
    need, have = math.prod(shape), world_size()
    if have != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'pod'} mesh {shape} "
            f"needs a world of {need} ranks; this one has {have}")
    return make_mesh(shape, names, device_type)


def make_local_mesh(device_type: str = "cuda"):
    """(world, 1) over ("data", "model"): every rank of the process group
    on the data axis."""
    return make_mesh((world_size(), 1), ("data", "model"), device_type)


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or the `shape` dict of anything
    that carries one (the tests' stand-in meshes)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


# NVIDIA H100 80GB HBM3 (SXM) hardware constants for the roofline, per card
PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way (NVLink 4, 18 links)
HBM_BYTES = 80 * 10**9          # capacity
