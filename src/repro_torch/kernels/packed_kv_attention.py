"""Flash-decode attention over a contiguous head-major packed KV cache (the
hybrid family's ring KV): one query per row, GQA.

Replaces `repro/kernels/packed_kv_attention.py:packed_kv_attention_pallas`
(body `_kv_attn_kernel`). CUDA source: `csrc/packed_kv_attention.cu`.

What bounds it on an H100: bytes — the packed K and V of the blocks that
hold a valid token, read once (recurrentgemma-9b: B=4, MQA, S=2048,
D=256 int4 is 2.1 MB). One CTA per (row, KV head) walks the row's
`bs`-token blocks in order and streams each block's K, then its V, through
shared memory in 128-token tiles, packed; the block's scores stay in
shared memory for the once-per-block online-softmax update. With MQA at
B=4 that is 4 CTAs on 132 SMs: splitting the sequence across CTAs is the
redesign that would approach the bound.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library
from repro_torch.models.layers import NEG_INF, unpack_int4_pairs

THREADS = 512
TILE_MAX = 128
SHARED_LIMIT = 227 * 1024       # dynamic shared memory one CTA may opt into


def packed_kv_attention_plain(q, k, v, k_scale, v_scale, lengths, *,
                              kv_bits: int = 4):
    """Dequantize + dense float32 softmax (the oracle
    `repro.kernels.ref.packed_kv_attention_ref` computes). q (B, KV, Hg, D)
    bf16; k/v (B, KV, S, D//2) uint8 for kv_bits 4 or (B, KV, S, D) int8
    for kv_bits 8; scales (B, KV, S); lengths (B,) clamped to S. Returns
    (B, KV, Hg, D) bf16. A row of length 0 attends uniformly to all S
    slots, as the oracle does."""
    D = q.shape[-1]
    S = k.shape[2]
    lengths = lengths.long().clamp(max=S)
    k_int = unpack_int4_pairs(k) if kv_bits == 4 else k
    v_int = unpack_int4_pairs(v) if kv_bits == 4 else v
    kf = k_int.float() * k_scale.float()[..., None]          # (B,KV,S,D)
    vf = v_int.float() * v_scale.float()[..., None]
    s = torch.einsum("bkhd,bksd->bkhs", q.float(), kf) / (D ** 0.5)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkhs,bksd->bkhd", p, vf).to(torch.bfloat16)


def shared_bytes(Hg: int, D: int, bs: int, kv_bits: int) -> int:
    """Dynamic shared memory of one CTA (`shared_bytes` of the source)."""
    d_store = D // 2 if kv_bits == 4 else D
    tile = min(bs, TILE_MAX)
    return 4 * (Hg * D + Hg * bs + 2 * bs + 3 * Hg) \
        + 4 * tile * (d_store // 4 + 1)


def packed_kv_attention_cuda(q, k, v, k_scale, v_scale, lengths, *,
                             bs: int = 512, kv_bits: int = 4,
                             debug_visits: bool = False):
    """Launch the CUDA kernel; same contract as `packed_kv_attention_plain`
    for rows of length >= 1 (a row of length 0 gives the mean V of its
    first block, as the TPU kernel does). `bs` is the sequence block, the
    unit of the online-softmax update and of the skipping of blocks past a
    row's length (min(bs, S); S % bs == 0). With `debug_visits` also
    returns the blocks each (row, KV head) processed, (B, KV) int32:
    max(cdiv(min(len, S), bs), 1)."""
    ts = (q, k, v, k_scale, v_scale, lengths)
    if not all(t.is_cuda for t in ts):
        raise ValueError("packed_kv_attention_cuda takes CUDA tensors")
    B, KV, Hg, D = q.shape
    S = k.shape[2]
    bs = min(bs, S)
    d_store = D // 2 if kv_bits == 4 else D
    want = torch.uint8 if kv_bits == 4 else torch.int8
    if kv_bits not in (4, 8) or q.dtype != torch.bfloat16 \
            or k.dtype != want or v.dtype != want \
            or k_scale.dtype != torch.bfloat16 \
            or v_scale.dtype != torch.bfloat16:
        raise TypeError(f"packed_kv_attention_cuda: unsupported dtypes "
                        f"(kv_bits={kv_bits}, q {q.dtype}, k {k.dtype}, "
                        f"scales {k_scale.dtype})")
    if k.shape != (B, KV, S, d_store) or v.shape != k.shape \
            or k_scale.shape != (B, KV, S) or v_scale.shape != (B, KV, S) \
            or lengths.shape != (B,):
        raise ValueError(f"packed_kv_attention_cuda: inconsistent shapes "
                         f"q {tuple(q.shape)} k {tuple(k.shape)} scales "
                         f"{tuple(k_scale.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if bs < 1 or S % bs:
        raise ValueError(f"S={S} is not a multiple of bs={bs}")
    if D % 32 or Hg * D > 8 * THREADS:
        raise ValueError(f"Hg={Hg}, D={D}: D must be a multiple of 32 and "
                         f"Hg * D <= {8 * THREADS}")
    shm = shared_bytes(Hg, D, bs, kv_bits)
    if shm > SHARED_LIMIT:
        raise ValueError(f"Hg={Hg}, D={D}, bs={bs}: {shm} B of shared "
                         f"memory exceed one CTA")
    q, k, v, k_scale, v_scale = (t.contiguous() for t in
                                 (q, k, v, k_scale, v_scale))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("packed_kv_attention_cuda: k and v must be 16-byte "
                         "aligned (the kernel reads them as 16-byte vectors)")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    visits = (torch.empty((B, KV), dtype=torch.int32, device=q.device)
              if debug_visits else None)
    err = library().packed_kv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if visits is None else visits.data_ptr(), B, KV, Hg, D, S, bs,
        kv_bits, torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "packed_kv_attention")
    packed_kv_attention_cuda.launches += B * KV > 0
    return (out, visits) if debug_visits else out


packed_kv_attention_cuda.launches = 0
