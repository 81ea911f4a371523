"""The meta route of the kernel entries: shape propagation for a trace.

On `meta` tensors (the dry run's trace, `launch/op_analysis.py`) an
entry of `kernels/ops.py` computes nothing. Its `*_meta` function returns
outputs of the kernel's shapes and dtypes on `meta` and tells every
active observer of one launch (under the CUDA wrapper's own rule: an
empty call launches nothing), the kernel's FLOPs (its products, 2 a
multiply-add, as a dot is counted) and the bytes its bound counts: each
operand read once, each result written once. The CUDA wrappers'
`launches` counters (`ops.launch_counts`) are left alone: they count
launches on the card, and nothing is launched here; the prediction is
the observer's (`OpAnalysis.kernels`). A read
that depends on the data (a row's length, the pages a table names) is
counted at its most, since a meta tensor holds no values.
"""
from __future__ import annotations

import math

import torch

# the active observers (`op_analysis.OpAnalysis` while it is entered)
OBSERVERS: list = []


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def empty(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def nbytes(*ts) -> int:
    """Bytes of the given tensors (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def launched(name: str, flops: int, n_bytes: int,
             launches: bool = True) -> None:
    """Report one launch of kernel `name` to the active observers
    (unless `launches` is False: the card would launch nothing)."""
    if not launches:
        return
    for obs in OBSERVERS:
        obs.kernel(name, flops, n_bytes)


def plane_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of `shape` and `dtype` that is never made."""
    return math.prod(shape) * dtype.itemsize
