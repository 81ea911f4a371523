"""Flash-decode attention over a contiguous head-major packed KV cache (the
hybrid family's ring KV): one query per row, GQA.

Replaces `repro/kernels/packed_kv_attention.py:packed_kv_attention_pallas`
(body `_kv_attn_kernel`). CUDA source: `csrc/packed_kv_attention.cu`.

What bounds it on an H100: bytes — the packed K and V of the valid
tokens, read once (recurrentgemma-9b: B=4, MQA, S=2048, D=256 int4 is 2.1
MB at a full ring). The sequence is split across CTAs, one 64-token
chunk each (grid (B * KV, cdiv(S, 64)), sized from shapes alone); each
CTA streams its chunk's packed K and V into shared memory with cp.async,
runs both products on bf16 tensor-core MMAs (the Hg <= 16 query heads are
the MMA's 16 rows) and writes a partial (max, denominator, accumulator)
to scratch; a second kernel merges a row's chunks. `bs` stays the unit of
block skipping and visit counting.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.build import check, library
from repro_torch.models.layers import NEG_INF, unpack_int4_pairs

CHUNK = 64                      # tokens of one CTA (csrc constant)
MROWS = 16                      # query heads one CTA takes: the MMA's m
MAX_D = 256                     # output lanes the PV warps hold in registers
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


def shared_bytes(D: int, kv_bits: int) -> int:
    """Dynamic shared memory of one chunk CTA (`shared_bytes` of the
    source): q as 16 padded bf16 rows, the chunk's packed K and V rows
    (16 bytes of padding each), its scales, bf16 p * v_scale and the
    per-warp softmax statistics."""
    d_store = D // 2 if kv_bits == 4 else D
    return 2 * MROWS * (D + 8) + 2 * CHUNK * (d_store + 16) + 2 * 4 * CHUNK \
        + 2 * MROWS * (CHUNK + 8) + 2 * 4 * 4 * MROWS


def scratch_bytes(B: int, KV: int, Hg: int, D: int, S: int) -> int:
    """Bytes of the scratch the merge reads: per chunk of each (row, KV
    head), a (max, denominator) pair and an Hg x D f32 accumulator per
    query head, and the chunk's first and last `bs`-block."""
    return B * KV * -(-S // CHUNK) * (Hg * D * 4 + Hg * 8 + 8)


def packed_kv_attention_cuda(q, k, v, k_scale, v_scale, lengths, *,
                             bs: int = 512, kv_bits: int = 4,
                             debug_visits: bool = False):
    """Launch the CUDA kernel; same contract as `packed_kv_attention_plain`
    for rows of length >= 1 (a row of length 0 gives the mean V of its
    first block, as the TPU kernel does). `bs` is the sequence block, the
    unit of the online-softmax update and of the skipping of blocks past a
    row's length (min(bs, S); S % bs == 0). With `debug_visits` also
    returns the `bs`-blocks whose tokens each (row, KV head) read, counted
    on the device, (B, KV) int32: max(cdiv(min(len, S), bs), 1). One call
    is one launch in the count, though it runs two kernels (the chunks,
    then their merge)."""
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
    if not 1 <= Hg <= MROWS or D % 32 or D > MAX_D:
        raise ValueError(f"Hg={Hg}, D={D}: need 1 <= Hg <= {MROWS}, D a "
                         f"multiple of 32 and D <= {MAX_D}")
    shm = shared_bytes(D, kv_bits)
    if shm > SHARED_LIMIT:
        raise ValueError(f"D={D}: {shm} B of shared memory exceed one CTA")
    q, k, v, k_scale, v_scale = (t.contiguous() for t in
                                 (q, k, v, k_scale, v_scale))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("packed_kv_attention_cuda: k and v must be 16-byte "
                         "aligned (the kernel reads them as 16-byte vectors)")
    if q.data_ptr() % 4:           # the kernel reads q in bf16 pairs
        q = q.clone()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    visits = (torch.empty((B, KV), dtype=torch.int32, device=q.device)
              if debug_visits else None)
    scratch = torch.empty(scratch_bytes(B, KV, Hg, D, S), dtype=torch.uint8,
                          device=q.device)
    err = library().packed_kv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if visits is None else visits.data_ptr(), scratch.data_ptr(),
        B, KV, Hg, D, S, bs, kv_bits,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "packed_kv_attention")
    packed_kv_attention_cuda.launches += B * KV > 0
    return (out, visits) if debug_visits else out


packed_kv_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# Meta route (`kernels/meta.py`): shapes, launches, FLOPs and bytes
# ---------------------------------------------------------------------------

def packed_kv_attention_meta(q, k, v, k_scale, v_scale, lengths, *,
                             bs: int = 512, kv_bits: int = 4,
                             debug_visits: bool = False):
    """Every row at its most: all S slots of its cache read."""
    B, KV, Hg, D = q.shape
    S = k.shape[2]
    out = meta.empty(q.shape, torch.bfloat16)
    meta.launched("packed_kv_attention", 4 * B * KV * Hg * S * D,
                  meta.nbytes(q, k, v, k_scale, v_scale, lengths, out),
                  B * KV > 0)
    if debug_visits:
        return out, meta.empty((B, KV), torch.int32)
    return out
