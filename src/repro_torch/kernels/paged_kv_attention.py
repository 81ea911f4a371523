"""Flash-decode attention over the paged two-plane KV pool: one query per
row (decode), or a window of W causal queries per row (speculative
verify).

Replaces `repro/kernels/paged_kv_attention.py:paged_kv_attention_pallas`
(body `_paged_kernel`) and `paged_kv_attention_window_pallas`. CUDA
source: `csrc/paged_kv_attention.cu`, one split-page kernel and its merge
with two C entry points, counted apart as `paged_kv_attention` and
`paged_kv_attention_window`.

What bounds it on an H100: bytes — the pages each row holds, read once.
A row's page walk is split across CTAs, one chunk of `chunk_plan(page)`
whole pages (64 tokens) each, grid (B * KV, cdiv(maxP, pages a chunk)
[, slot groups]) sized from shapes alone; each CTA streams its pages' K
and V blocks from the plane each page's mode bit names (bf16, or
int4/int8 levels whose per-token scales apply to score columns and to
p) with cp.async, runs both products on bf16 tensor-core MMAs (the W *
Hg (slot, head) rows are the MMA's rows) and writes a partial (max,
denominator, accumulator) per row to scratch; a second kernel merges a
row's chunks in chunk order. The TPU kernel's hold-previous gather
indices are a DMA-reuse device; this kernel reads the true (page_table,
page_modes). Window slot w attends to the tokens < starts + w + 1 and is
bit-identical to the decode read at that length: chunk boundaries come
from the page index alone, a row's MMA results do not see the other
rows, a token past a slot's horizon adds exact zeros, and the merge
takes exactly the slot's chunks in order (`paged_split_merge_mirror` in
tests/torch_paged_mirror.py rehearses this order on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library
from repro_torch.models.layers import NEG_INF, unpack_int4_pairs

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


CHUNK = 64                      # tokens of one chunk CTA, at most (csrc)
MAX_ROWS = 64                   # (slot, head) rows one CTA takes: 4 tiles
MAX_D = 256                     # output lanes the PV warps hold


def chunk_plan(page: int) -> int:
    """Pages of one chunk CTA: the whole pages that fit 64 tokens. It
    reads the page size alone, so the decode read and every window slot
    cut a row's pages at the same boundaries."""
    if page % 8 or not 8 <= page <= CHUNK:
        raise ValueError(f"page={page}: need a multiple of 8 in "
                         f"[8, {CHUNK}]")
    return CHUNK // page


def window_plan(W: int, Hg: int) -> int:
    """Window slots one CTA takes: the W slots cut into as few groups of
    at most MAX_ROWS (slot, head) rows as there must be, spread evenly
    over the groups. A row's arithmetic is the same in any group. Raises
    where not even one slot fits."""
    per = min(W, MAX_ROWS // Hg)
    if per < 1:
        raise ValueError(f"Hg={Hg}: one window slot exceeds one CTA "
                         f"({MAX_ROWS} rows)")
    groups = -(-W // per)
    return -(-W // groups)


def scratch_bytes(B: int, KV: int, W: int, Hg: int, D: int, page: int,
                  maxP: int) -> int:
    """Bytes of the scratch the merge reads: per chunk of each (row, KV
    head), an f32 accumulator of D lanes and a (max, denominator) pair
    for each of the W * Hg (slot, head) rows."""
    return B * KV * -(-maxP // chunk_plan(page)) * W * Hg * (D * 4 + 8)


def _on_card(name, *ts):
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} takes CUDA tensors")


def _launch(name, q, kn, vn, kp, vp, k_scale, v_scale, base, page_table,
            page_modes, kv_bits, scratch=None):
    """Check the operands' shapes and types and launch entry point
    `name` (the callers check that they lie on the card); q is
    (B, KV, W, Hg, D) and `base` holds lengths (decode) or starts. The
    chunks' partials go to `scratch` (`scratch_bytes` uint8 on the card),
    or to one made here."""
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
    if D % 32 or D > MAX_D:
        raise ValueError(f"D={D}: need a multiple of 32, at most {MAX_D}")
    ppc = chunk_plan(page)
    wc = window_plan(W, Hg)
    ints = [t.to(torch.int32).contiguous()
            for t in (base, page_table, page_modes)]
    ts = [t.contiguous() for t in (q, kn, vn, kp, vp, k_scale, v_scale)]
    if any(t.data_ptr() % 16 for t in ts[1:]):
        raise ValueError(f"{name}_cuda: arenas and scales must be 16-byte "
                         f"aligned (the kernel reads pages as 16-byte "
                         f"vectors)")
    if ts[0].data_ptr() % 16:          # q rows are read as 16-byte vectors
        ts[0] = ts[0].clone()
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    n_scratch = scratch_bytes(B, KV, W, Hg, D, page, maxP)
    if scratch is None:
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=q.device)
    elif scratch.numel() != n_scratch or scratch.dtype != torch.uint8:
        raise ValueError(f"{name}_cuda: scratch must be {n_scratch} bytes")
    decode = name == "paged_kv_attention"
    shape = (B, KV, Hg, D) if decode else (B, KV, W, Hg, D)
    err = getattr(library(), name)(
        *[t.data_ptr() for t in ts], *[t.data_ptr() for t in ints],
        out.data_ptr(), scratch.data_ptr(), *shape, page, maxP, kv_bits,
        ppc, *(() if decode else (wc,)),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, name)
    return out


def paged_kv_attention_cuda(q, kn, vn, kp, vp, k_scale, v_scale, lengths,
                            page_table, page_modes, *, kv_bits: int = 4):
    """Launch the CUDA kernel; same contract as `paged_kv_attention_plain`."""
    _on_card("paged_kv_attention_cuda", q, kn, vn, kp, vp, k_scale, v_scale,
             lengths, page_table, page_modes)
    out = _launch("paged_kv_attention", q[:, :, None], kn, vn, kp, vp,
                  k_scale, v_scale, lengths, page_table, page_modes, kv_bits)
    paged_kv_attention_cuda.launches += 1
    return out[:, :, 0]


def paged_kv_attention_window_cuda(q, kn, vn, kp, vp, k_scale, v_scale,
                                   starts, page_table, page_modes, *,
                                   kv_bits: int = 4):
    """Launch the window entry point; same contract as
    `paged_kv_attention_window_plain`."""
    _on_card("paged_kv_attention_window_cuda", q, kn, vn, kp, vp, k_scale,
             v_scale, starts, page_table, page_modes)
    out = _launch("paged_kv_attention_window", q, kn, vn, kp, vp, k_scale,
                  v_scale, starts, page_table, page_modes, kv_bits)
    paged_kv_attention_window_cuda.launches += 1
    return out


paged_kv_attention_cuda.launches = 0
paged_kv_attention_window_cuda.launches = 0
