"""PyTorch/CUDA port of the augmented-memory serving stack.

The package mirrors `repro`'s module layout (`configs`, `core`, `models`,
`kernels`, `serve`) and imports only torch, numpy and the standard
library. Entry points run on CUDA unless the caller passes
``device="cpu"``; see `repro_torch.device.resolve_device`.
"""
