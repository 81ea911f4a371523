"""Flash-decode attention over the paged two-plane KV pool: one query per
row (decode), or a window of W causal queries per row (speculative
verify).

Replaces `repro/kernels/paged_kv_attention.py:paged_kv_attention_pallas`
(body `_paged_kernel`) and `paged_kv_attention_window_pallas`. CUDA
source: `csrc/paged_kv_attention.cu`, one kernel with two C entry points,
counted apart as `paged_kv_attention` and `paged_kv_attention_window`.

What bounds it on an H100: bytes — the pages each row holds, read once.
One CTA per (row, KV head) walks the row's page table in order, up to
four pages per barrier round, copying each page's contiguous K/V block
with 16-byte loads from the plane its mode bit names (bf16, or int4/int8
levels whose per-token scales apply to score columns and to p); the
online softmax stays in registers. The TPU kernel's hold-previous gather
indices are a DMA-reuse device; this kernel reads the true
(page_table, page_modes). Window slot w attends to the tokens
< starts + w + 1 in the same page walk, and is bit-identical to the
decode walk at that length (a page past its horizon adds exactly zero).
A window with more outputs than one CTA holds (`window_plan`) is cut
into groups of slots, one CTA each, each walking the row's pages itself.
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


def _dense_attention(q, k, v, lengths):
    """q (B, KV, Hg, D) over dense caches k/v (B, KV, S, D) f32, each row
    to its length: f32 scores, -1e30 past the length, f32 softmax."""
    D = q.shape[-1]
    S = k.shape[2]
    lengths = lengths.long().clamp(max=S)
    s = torch.einsum("bkhd,bksd->bkhs", q.float(), k) / (D ** 0.5)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkhs,bksd->bkhd", p, v).to(torch.bfloat16)


def paged_kv_attention_plain(q, kn, vn, kp, vp, k_scale, v_scale, lengths,
                             page_table, page_modes, *, kv_bits: int = 4):
    """Gather + dense float32 softmax (the oracle
    `repro.kernels.ref.paged_kv_attention_ref` computes).
    q (B, KV, Hg, D) bf16 -> (B, KV, Hg, D) bf16."""
    k, v = paged_gather_kv(kn, vn, kp, vp, k_scale, v_scale, page_table,
                           page_modes, kv_bits=kv_bits)
    return _dense_attention(q, k, v, lengths)


def paged_kv_attention_window_plain(q, kn, vn, kp, vp, k_scale, v_scale,
                                    starts, page_table, page_modes, *,
                                    kv_bits: int = 4):
    """The window read (the oracle `repro.kernels.ref.
    paged_kv_attention_window_ref` computes): q (B, KV, W, Hg, D) bf16,
    slot w attends to the tokens < starts + w + 1. Each slot is the decode
    plain version at that length, op for op, so slot w is identical to
    `paged_kv_attention_plain` at lengths starts + w + 1."""
    k, v = paged_gather_kv(kn, vn, kp, vp, k_scale, v_scale, page_table,
                           page_modes, kv_bits=kv_bits)
    return torch.stack([_dense_attention(q[:, :, w], k, v, starts + w + 1)
                        for w in range(q.shape[2])], dim=2)


MAX_OUTPUTS = 4096               # (slot, head, lane) outputs a CTA owns


def shared_bytes(rows: int, d: int, page: int) -> int:
    """Dynamic shared memory of one CTA loading one page per barrier
    round; rows = slots * Hg score rows."""
    return 4 * (rows * d + 2 * page * d + 2 * page + rows * page)


def window_plan(W: int, Hg: int, D: int, page: int) -> int:
    """Window slots one CTA takes: the W slots cut into as few groups as
    fit a CTA (at most MAX_OUTPUTS outputs, one page a barrier round in
    SHARED_LIMIT), spread evenly over the groups. Raises where not even
    one slot fits."""
    per = min(W, MAX_OUTPUTS // (Hg * D))
    while per > 0 and shared_bytes(per * Hg, D, page) > SHARED_LIMIT:
        per -= 1
    if per < 1:
        raise ValueError(f"Hg={Hg}, D={D}, page={page}: one window slot "
                         f"exceeds one CTA")
    groups = -(-W // per)
    return -(-W // groups)


def _launch(name, q, kn, vn, kp, vp, k_scale, v_scale, base, page_table,
            page_modes, kv_bits):
    """Check the operands and launch entry point `name`; q is
    (B, KV, W, Hg, D) and `base` holds lengths (decode) or starts."""
    ts = (q, kn, vn, kp, vp, k_scale, v_scale, base, page_table,
          page_modes)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name}_cuda takes CUDA tensors")
    B, KV, W, Hg, D = q.shape
    page = kn.shape[2]
    maxP = page_table.shape[1]
    d_store = D // 2 if kv_bits == 4 else D
    want_packed = torch.uint8 if kv_bits == 4 else torch.int8
    if kv_bits not in (4, 8) or q.dtype != torch.bfloat16 \
            or kn.dtype != torch.bfloat16 or vn.dtype != torch.bfloat16 \
            or kp.dtype != want_packed or vp.dtype != want_packed \
            or k_scale.dtype != torch.bfloat16 \
            or v_scale.dtype != torch.bfloat16:
        raise TypeError(f"{name}_cuda: unsupported dtypes "
                        f"(kv_bits={kv_bits}, q {q.dtype}, kn {kn.dtype}, "
                        f"kp {kp.dtype}, scales {k_scale.dtype})")
    if kn.shape[1:] != (KV, page, D) or vn.shape != kn.shape \
            or kp.shape[1:] != (KV, page, d_store) or vp.shape != kp.shape \
            or k_scale.shape != kp.shape[:3] or v_scale.shape != kp.shape[:3] \
            or base.shape != (B,) or page_table.shape != (B, maxP) \
            or page_modes.shape != (B, maxP):
        raise ValueError(f"{name}_cuda: inconsistent shapes")
    wc = window_plan(W, Hg, D, page)
    if (page * d_store) % 16 or (page * D) % 8:
        raise ValueError(f"page={page}, D={D}: a page block must be a "
                         f"whole number of 16-byte vectors")
    ints = [t.to(torch.int32).contiguous()
            for t in (base, page_table, page_modes)]
    ts = [t.contiguous() for t in (q, kn, vn, kp, vp, k_scale, v_scale)]
    if any(t.data_ptr() % 16 for t in ts[1:5]):
        raise ValueError(f"{name}_cuda: arenas must be 16-byte aligned (the "
                         f"kernel reads pages as 16-byte vectors)")
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    decode = name == "paged_kv_attention"
    shape = (B, KV, Hg, D) if decode else (B, KV, W, Hg, D)
    err = getattr(library(), name)(
        *[t.data_ptr() for t in ts], *[t.data_ptr() for t in ints],
        out.data_ptr(), *shape, page, maxP, kv_bits,
        *(() if decode else (wc,)),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, name)
    return out


def paged_kv_attention_cuda(q, kn, vn, kp, vp, k_scale, v_scale, lengths,
                            page_table, page_modes, *, kv_bits: int = 4):
    """Launch the CUDA kernel; same contract as `paged_kv_attention_plain`."""
    out = _launch("paged_kv_attention", q[:, :, None], kn, vn, kp, vp,
                  k_scale, v_scale, lengths, page_table, page_modes, kv_bits)
    paged_kv_attention_cuda.launches += 1
    return out[:, :, 0]


def paged_kv_attention_window_cuda(q, kn, vn, kp, vp, k_scale, v_scale,
                                   starts, page_table, page_modes, *,
                                   kv_bits: int = 4):
    """Launch the window entry point; same contract as
    `paged_kv_attention_window_plain`."""
    out = _launch("paged_kv_attention_window", q, kn, vn, kp, vp, k_scale,
                  v_scale, starts, page_table, page_modes, kv_bits)
    paged_kv_attention_window_cuda.launches += 1
    return out


paged_kv_attention_cuda.launches = 0
paged_kv_attention_window_cuda.launches = 0
