"""Flash-decode attention over the paged two-plane KV pool.

Replaces `repro/kernels/paged_kv_attention.py:paged_kv_attention_pallas`
(body `_paged_kernel`). CUDA source: `csrc/paged_kv_attention.cu`.

What bounds it on an H100: bytes — the pages each row holds, read once.
One CTA per (row, KV head) walks the row's page table in order, up to
four pages per barrier round, copying each page's contiguous K/V block
with 16-byte loads from the plane its mode bit names (bf16, or int4/int8
levels whose per-token scales apply to score columns and to p); the
online softmax stays in registers. The TPU kernel's hold-previous gather
indices are a DMA-reuse device; this kernel reads the true
(page_table, page_modes).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library
from repro_torch.models.layers import NEG_INF, unpack_int4_pairs

SHARED_LIMIT = 48 * 1024 - 256   # dynamic shared memory left to one CTA


def paged_gather_kv(kn, vn, kp, vp, k_scale, v_scale, page_table,
                    page_modes, kv_bits: int = 4):
    """Gather the paged pool into dense head-major float32 caches
    (B, KV, maxP*page, D): the logical cache each row's page table names.
    Tail pages past a row's length hold whatever their physical page
    holds; callers mask them by length."""
    B, maxP = page_table.shape
    KV, page, D = kn.shape[1], kn.shape[2], kn.shape[3]
    aug = page_modes == 1
    n_sel = torch.where(aug, 0, page_table).long()
    p_sel = torch.where(aug, page_table, 0).long()

    def dense(nrm, pkd, scl):
        g_n = nrm[n_sel].float()                       # (B,maxP,KV,page,D)
        ints = pkd[p_sel]
        ints = unpack_int4_pairs(ints) if kv_bits == 4 else ints
        g_p = ints.float() * scl[p_sel].float()[..., None]
        out = torch.where(aug[:, :, None, None, None], g_p, g_n)
        return out.permute(0, 2, 1, 3, 4).reshape(B, KV, maxP * page, D)

    return dense(kn, kp, k_scale), dense(vn, vp, v_scale)


def paged_kv_attention_plain(q, kn, vn, kp, vp, k_scale, v_scale, lengths,
                             page_table, page_modes, *, kv_bits: int = 4):
    """Gather + dense float32 softmax (the oracle
    `repro.kernels.ref.paged_kv_attention_ref` computes).
    q (B, KV, Hg, D) bf16 -> (B, KV, Hg, D) bf16."""
    D = q.shape[-1]
    k, v = paged_gather_kv(kn, vn, kp, vp, k_scale, v_scale, page_table,
                           page_modes, kv_bits=kv_bits)
    S = k.shape[2]
    lengths = lengths.long().clamp(max=S)
    s = torch.einsum("bkhd,bksd->bkhs", q.float(), k) / (D ** 0.5)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkhs,bksd->bkhd", p, v).to(torch.bfloat16)


def shared_bytes(hg: int, d: int, page: int) -> int:
    return 4 * (hg * d + 2 * page * d + 2 * page + hg * page)


def paged_kv_attention_cuda(q, kn, vn, kp, vp, k_scale, v_scale, lengths,
                            page_table, page_modes, *, kv_bits: int = 4):
    """Launch the CUDA kernel; same contract as `paged_kv_attention_plain`."""
    ts = (q, kn, vn, kp, vp, k_scale, v_scale, lengths, page_table,
          page_modes)
    if not all(t.is_cuda for t in ts):
        raise ValueError("paged_kv_attention_cuda takes CUDA tensors")
    B, KV, Hg, D = q.shape
    page = kn.shape[2]
    maxP = page_table.shape[1]
    d_store = D // 2 if kv_bits == 4 else D
    want_packed = torch.uint8 if kv_bits == 4 else torch.int8
    if kv_bits not in (4, 8) or q.dtype != torch.bfloat16 \
            or kn.dtype != torch.bfloat16 or vn.dtype != torch.bfloat16 \
            or kp.dtype != want_packed or vp.dtype != want_packed \
            or k_scale.dtype != torch.bfloat16 \
            or v_scale.dtype != torch.bfloat16:
        raise TypeError("paged_kv_attention_cuda: unsupported dtypes "
                        f"(kv_bits={kv_bits}, q {q.dtype}, kn {kn.dtype}, "
                        f"kp {kp.dtype}, scales {k_scale.dtype})")
    if kn.shape[1:] != (KV, page, D) or vn.shape != kn.shape \
            or kp.shape[1:] != (KV, page, d_store) or vp.shape != kp.shape \
            or k_scale.shape != kp.shape[:3] or v_scale.shape != kp.shape[:3] \
            or lengths.shape != (B,) or page_table.shape != (B, maxP) \
            or page_modes.shape != (B, maxP):
        raise ValueError("paged_kv_attention_cuda: inconsistent shapes")
    if Hg * D > 1024 or shared_bytes(Hg, D, page) > SHARED_LIMIT:
        raise ValueError(f"Hg={Hg}, D={D}, page={page} exceed one CTA")
    if (page * d_store) % 16 or (page * D) % 8:
        raise ValueError(f"page={page}, D={D}: a page block must be a "
                         f"whole number of 16-byte vectors")
    ints = [t.to(torch.int32).contiguous()
            for t in (lengths, page_table, page_modes)]
    ts = [t.contiguous() for t in (q, kn, vn, kp, vp, k_scale, v_scale)]
    if any(t.data_ptr() % 16 for t in ts[1:5]):
        raise ValueError("paged_kv_attention_cuda: arenas must be 16-byte "
                         "aligned (the kernel reads pages as 16-byte vectors)")
    out = torch.empty((B, KV, Hg, D), dtype=torch.bfloat16, device=q.device)
    err = library().paged_kv_attention(
        *[t.data_ptr() for t in ts], *[t.data_ptr() for t in ints],
        out.data_ptr(), B, KV, Hg, D, page, maxP, kv_bits,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_kv_attention")
    paged_kv_attention_cuda.launches += 1
    return out


paged_kv_attention_cuda.launches = 0
