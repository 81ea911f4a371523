"""Device dispatch for the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, whose wrapper raises on what it
cannot take. There is no fallback from one to the other. The explicit
``plain=True`` of the reference routes (the JAX package's ``use_ref``)
is a caller's choice, never a recovery from a failed launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dual_plane_matmul import (dual_plane_matmul_cuda,
                                                   dual_plane_matmul_plain)
from repro_torch.kernels.imc_dot import (imc_dot_cuda, imc_dot_plain,
                                         imc_dual_dot_cuda,
                                         imc_dual_dot_plain)
from repro_torch.kernels.packed_kv_attention import (
    packed_kv_attention_cuda, packed_kv_attention_plain)
from repro_torch.kernels.paged_kv_attention import (
    paged_kv_attention_cuda, paged_kv_attention_plain,
    paged_kv_attention_window_cuda, paged_kv_attention_window_plain)
from repro_torch.kernels.quantize_pack_kv import (
    paged_kv_write_cuda, paged_kv_write_plain, quantize_pack_kv_cuda,
    quantize_pack_kv_integrity_cuda, quantize_pack_kv_masked_cuda,
    quantize_pack_kv_plain)
from repro_torch.kernels.ternary_matmul import (dense_matmul_cuda,
                                                dense_matmul_plain,
                                                ternary_matmul_cuda,
                                                ternary_matmul_plain)

KERNELS = {"ternary_matmul": ternary_matmul_cuda,
           "dense_matmul": dense_matmul_cuda,
           "dual_plane_matmul": dual_plane_matmul_cuda,
           "paged_kv_attention": paged_kv_attention_cuda,
           "paged_kv_attention_window": paged_kv_attention_window_cuda,
           "quantize_pack_kv": quantize_pack_kv_cuda,
           "quantize_pack_kv_masked": quantize_pack_kv_masked_cuda,
           "quantize_pack_kv_integrity": quantize_pack_kv_integrity_cuda,
           "paged_kv_write": paged_kv_write_cuda,
           "packed_kv_attention": packed_kv_attention_cuda,
           "imc_dot": imc_dot_cuda,
           "imc_dual_dot": imc_dual_dot_cuda}


def _cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def ternary_matmul(x, w_packed, scale, *, plain: bool = False):
    """y = x @ unpack(w_packed) * scale, weights 2 bits a value. ``plain``
    takes the plain version on any device (matmul_impl="dense")."""
    fn = ternary_matmul_plain if plain or _cpu(x) else ternary_matmul_cuda
    return fn(x, w_packed, scale)


def dense_matmul(x, w, *, layout: str = "kn", plain: bool = False):
    """x (..., K) @ w (K, N), or @ w.T for w (N, K) with layout "nk" (the
    tied head read from the embedding), with the port's fixed-order GEMM:
    a row's bits do not depend on how many rows the call has. ``plain``
    takes `x @ w` on any device (the unpaired weights of a route other
    than "packed", and the dense-weight families)."""
    if plain or _cpu(x):
        return dense_matmul_plain(x, w, layout)
    lead, K = x.shape[:-1], x.shape[-1]
    y = dense_matmul_cuda(x.reshape(-1, K), w, layout)
    return y.reshape(*lead, y.shape[-1])


def dual_plane_matmul(x, buf, hi_scale, lo_scale, *, plain: bool = False):
    """(y_hi, y_lo) = x @ both int4 planes of one uint8 buffer, each times
    its scale. ``plain`` takes the plain version on any device
    (matmul_impl="dense")."""
    fn = dual_plane_matmul_plain if plain or _cpu(x) \
        else dual_plane_matmul_cuda
    return fn(x, buf, hi_scale, lo_scale)


def imc_dot(x, wp, scale, *, fmt: str = "ternary", abits: int = 8,
            plain: bool = False):
    """Bit-serial in-array dot over packed weights consumed as stored:
    `fmt` "ternary" (K//4, N) u8 trits, "int4" (K//2, N) u8 row pairs or
    "int8" (K, N) i8; activations quantized per row to `abits` (1/4/8)
    bits. ``plain`` takes the plain version on any device (the JAX
    ``use_ref``)."""
    fn = imc_dot_plain if plain or _cpu(x) else imc_dot_cuda
    return fn(x, wp, scale, fmt=fmt, abits=abits)


def imc_dual_dot(x, buf, hi_scale, lo_scale, *, abits: int = 8,
                 plain: bool = False):
    """Bit-serial in-array dot over BOTH int4 planes of one uint8 buffer:
    one activation stream, two results (y_hi, y_lo)."""
    fn = imc_dual_dot_plain if plain or _cpu(x) else imc_dual_dot_cuda
    return fn(x, buf, hi_scale, lo_scale, abits=abits)


def paged_kv_attention(q, kn, vn, kp, vp, k_scale, v_scale, lengths,
                       page_table, page_modes, *, kv_bits: int = 4):
    """Flash-decode of one query per row over the paged two-plane pool."""
    fn = paged_kv_attention_plain if _cpu(q) else paged_kv_attention_cuda
    return fn(q, kn, vn, kp, vp, k_scale, v_scale, lengths, page_table,
              page_modes, kv_bits=kv_bits)


def paged_kv_attention_window(q, kn, vn, kp, vp, k_scale, v_scale, starts,
                              page_table, page_modes, *, kv_bits: int = 4):
    """The speculative-verify read: q (B, KV, W, Hg, D), window slot w
    attends to the tokens < starts + w + 1, bit-identical per slot to
    `paged_kv_attention` at that length."""
    fn = paged_kv_attention_window_plain if _cpu(q) \
        else paged_kv_attention_window_cuda
    return fn(q, kn, vn, kp, vp, k_scale, v_scale, starts, page_table,
              page_modes, kv_bits=kv_bits)


def packed_kv_attention(q, k, v, k_scale, v_scale, lengths, *, bs: int = 512,
                        kv_bits: int = 4, debug_visits: bool = False):
    """Flash-decode of one query per row over a contiguous head-major packed
    cache (B, KV, S, D//2 | D) with per-token scales (B, KV, S); lengths
    run past S on a ring and are clamped to it. With `debug_visits` (the
    kernel only) also returns the blocks each (row, KV head) processed."""
    if _cpu(q):
        if debug_visits:
            raise ValueError("visit counting is a kernel-path feature: pass "
                             "CUDA tensors")
        return packed_kv_attention_plain(q, k, v, k_scale, v_scale, lengths,
                                         kv_bits=kv_bits)
    return packed_kv_attention_cuda(q, k, v, k_scale, v_scale, lengths,
                                    bs=bs, kv_bits=kv_bits,
                                    debug_visits=debug_visits)


def paged_kv_write(kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write, commit,
                   page_table, page_modes, *, page_size: int, policy: str,
                   aug_bits: int) -> None:
    """One layer's KV write into the paged pool, IN PLACE: k_new / v_new
    (B, T, KV, hd) at positions pos (B, T) into each token's page in the
    plane its mode picks (write == False: the dump page 0; commit ==
    False: zeros), packed to `aug_bits` in the Augmented plane."""
    fn = paged_kv_write_plain if _cpu(k_new) else paged_kv_write_cuda
    fn(kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write, commit, page_table,
       page_modes, page_size=page_size, policy=policy, aug_bits=aug_bits)


def quantize_pack_kv(kv: torch.Tensor, valid=None):
    """kv (..., D) bf16 -> (packed (..., D//2) uint8, scale (..., 1) bf16),
    the layout `models.layers.pack_kv_int4` produces. `valid` (bool,
    broadcastable to kv.shape[:-1]), optional, is the speculative
    store-back mask: rows the verify pass rejected are written as zero
    bytes and a unit scale (the masked body)."""
    lead, D = kv.shape[:-1], kv.shape[-1]
    flat = kv.reshape(-1, D)
    if valid is None:
        fn = quantize_pack_kv_plain if _cpu(kv) else quantize_pack_kv_cuda
        p, s = fn(flat)
    else:
        vflat = torch.broadcast_to(valid, lead).reshape(-1)
        fn = quantize_pack_kv_plain if _cpu(kv) \
            else quantize_pack_kv_masked_cuda
        p, s = fn(flat, vflat)
    return (p.reshape(*lead, D // 2),
            s.reshape(*lead, 1).to(torch.bfloat16))
