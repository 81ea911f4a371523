"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Never falls back to the CPU on its own — without a card
    and without an explicit ``device="cpu"`` this raises.

    On CUDA it also pins full-precision float32 matmuls (no TF32 in
    cuBLAS or cuDNN, no reduced-precision bf16 reductions), so the plain
    torch ops on the path compute what the CPU reference computes."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev
