"""The paged kernels' order in torch: a mirror of
`src/repro_torch/kernels/csrc/paged_kv_attention.cu` (chunks of
`chunk_plan(page)` whole pages, each chunk's partial (max, denominator,
accumulator) per (slot, head) row, a merge in chunk order) with a model
of the tensor core's add, and a reader of a launch's chunk partials.
Imports torch and the port only: the CPU tests hold the mirror against
the JAX oracles, the card tests hold the kernel against the mirror."""
import math

import torch

from repro_torch.kernels.paged_kv_attention import CHUNK, chunk_plan
from repro_torch.models.layers import NEG_INF, unpack_int4_pairs

MMA_ALIGN_BITS = 25     # bits the MMA's add keeps below its largest term


def _mma_chain(a, b):
    """a (R, K) @ b (K, N) in f32 as the kernel's m16n8k16 chain takes
    it: over K in increasing 16-deep steps, each step adding its 16
    products to the running sum in one multi-term add. A model of the
    tensor core's add: the products are exact, every term (the running
    sum included) is truncated to MMA_ALIGN_BITS fraction bits below the
    step's largest term, the truncated terms are summed exactly and the
    sum is rounded toward zero to f32. Elementwise ops only, so no row or
    column sees another."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros((a.shape[0], b.shape[1]), device=a.device)
    for k0 in range(0, a.shape[1], 16):
        prods = a64[:, k0:k0 + 16, None] * b64[None, k0:k0 + 16]
        terms = torch.cat([acc.double()[:, None], prods], dim=1)
        _, e = torch.frexp(terms.abs().amax(dim=1, keepdim=True))
        quantum = torch.ldexp(torch.ones_like(terms[:, :1]),
                              e - 1 - MMA_ALIGN_BITS)
        exact = (torch.trunc(terms / quantum) * quantum).sum(dim=1)
        near = exact.float()
        acc = torch.where(near.double().abs() > exact.abs(),
                          torch.nextafter(near, torch.zeros_like(near)), near)
    return acc


def paged_split_merge_parts(q, kn, vn, kp, vp, k_scale, v_scale, base,
                            page_table, page_modes, *, kv_bits: int = 4,
                            window: bool = False):
    """The chunk kernel's partials in torch: q (B, KV, Hg, D) at lengths
    `base`, or with `window` q (B, KV, W, Hg, D) at starts `base` (slot w
    sees the tokens < starts + w + 1). Each chunk of `chunk_plan(page)`
    pages up to a row's last slot gives, per (slot, head) row, scores as
    the MMA chain over D (`_mma_chain`) times k_scale * D^-1/2, -1e30 past
    the slot's horizon, the chunk max m, p = e^(s - m), the denominator l
    summed in the kernel's order (a lane's 4 tokens, two shuffles, the 4
    warps) and acc = bf16(p * v_scale) @ v as the MMA chain over the
    tokens. Returns m, l (B, KV, NC, W * Hg), acc (B, KV, NC, W * Hg, D)
    (NaN where no CTA works) and the chunks each row's merge takes
    (B, W * Hg): those that start before the slot's last page."""
    dev = q.device
    qw = q if window else q[:, :, None]
    B, KV, W, Hg, D = qw.shape
    page, maxP = kn.shape[2], page_table.shape[1]
    ppc, cap, add = chunk_plan(page), maxP * page, int(window)
    NC, RT = -(-maxP // ppc), W * Hg
    inv_sqrt_d = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32,
                              device=dev)
    neg = torch.tensor(NEG_INF, device=dev)
    m = torch.full((B, KV, NC, RT), math.nan, device=dev)
    l = torch.full((B, KV, NC, RT), math.nan, device=dev)
    acc = torch.full((B, KV, NC, RT, D), math.nan, device=dev)
    slot = torch.arange(RT) // Hg
    hz = (base.cpu().long()[:, None] + add + slot).clamp(0, cap)  # (B, RT)
    pages_to = torch.clamp(-(-hz // page), min=1)
    for b in range(B):
        hzb = hz[b].to(dev)
        for h in range(KV):
            qr = qw[b, h].reshape(RT, D).float()
            for c, p0 in enumerate(range(0, int(pages_to[b, -1]), ppc)):
                ks, vs, kl, vl = [], [], [], []
                for lp in range(p0, min(p0 + ppc, int(pages_to[b, -1]))):
                    phys, aug = int(page_table[b, lp]), int(page_modes[b, lp])
                    if aug:
                        kk, vv = kp[phys, h], vp[phys, h]
                        if kv_bits == 4:
                            kk = unpack_int4_pairs(kk)
                            vv = unpack_int4_pairs(vv)
                        ks.append(k_scale[phys, h].float())
                        vs.append(v_scale[phys, h].float())
                    else:
                        kk, vv = kn[phys, h], vn[phys, h]
                        ks.append(torch.ones(page, device=dev))
                        vs.append(torch.ones(page, device=dev))
                    kl.append(kk.float())
                    vl.append(vv.float())
                k, v = torch.cat(kl), torch.cat(vl)
                n = k.shape[0]
                s = _mma_chain(qr, k.T) * (torch.cat(ks) * inv_sqrt_d)
                tok = p0 * page + torch.arange(n, device=dev)
                s = torch.where(tok[None, :] < hzb[:, None], s, neg)
                m[b, h, c] = s.max(dim=1).values
                p = torch.exp(s - m[b, h, c, :, None])
                lanes = torch.nn.functional.pad(p, (0, CHUNK - n)).reshape(
                    RT, 4, 2, 4, 2)                         # warp, j, t, e
                lane = ((lanes[:, :, 0, :, 0] + lanes[:, :, 0, :, 1])
                        + lanes[:, :, 1, :, 0]) + lanes[:, :, 1, :, 1]
                quad = (lane[..., 0] + lane[..., 1]) \
                    + (lane[..., 2] + lane[..., 3])
                l[b, h, c] = ((quad[:, 0] + quad[:, 1]) + quad[:, 2]) \
                    + quad[:, 3]
                pv = (p * torch.cat(vs)).to(torch.bfloat16).float()
                acc[b, h, c] = _mma_chain(pv, v)
    return m, l, acc, -(-pages_to // ppc)


def paged_split_merge_mirror(q, kn, vn, kp, vp, k_scale, v_scale, base,
                             page_table, page_modes, *, kv_bits: int = 4,
                             window: bool = False):
    """The CUDA kernel's order in torch, on the arguments of
    `paged_split_merge_parts`: its partials merged as the merge kernel
    does, in chunk order over the chunks each row takes: m = max m_i,
    l and acc by fmaf with weights e^(m_i - m), out = bf16(acc / l)."""
    m, l, acc, nch = paged_split_merge_parts(
        q, kn, vn, kp, vp, k_scale, v_scale, base, page_table, page_modes,
        kv_bits=kv_bits, window=window)
    B, KV, _, RT, D = acc.shape
    out = torch.empty((B, KV, RT, D), dtype=torch.bfloat16, device=q.device)
    for b in range(B):
        for h in range(KV):
            for r in range(RT):
                n = int(nch[b, r])
                mr = m[b, h, :n, r].max()
                lr = torch.zeros((), dtype=torch.float64, device=q.device)
                ar = torch.zeros(D, dtype=torch.float64, device=q.device)
                for c in range(n):            # fmaf, in chunk order
                    wgt = torch.exp(m[b, h, c, r] - mr).double()
                    lr = (l[b, h, c, r].double() * wgt + lr).float().double()
                    ar = (acc[b, h, c, r].double() * wgt + ar).float().double()
                out[b, h, r] = (ar.float() / lr.float()).to(torch.bfloat16)
    return out.reshape(q.shape)


def chunk_partials(scratch, B: int, KV: int, W: int, Hg: int, D: int,
                   page: int, maxP: int):
    """The chunk kernel's partials in a launch's scratch: m, l
    (B, KV, NC, W * Hg) and acc (B, KV, NC, W * Hg, D), as laid out in
    `csrc/flash_decode.cuh` (`Parts`): every chunk's accumulators, then
    every chunk's (max, denominator) pairs."""
    NC, RT = -(-maxP // chunk_plan(page)), W * Hg
    n = B * KV * NC * RT
    f = scratch.view(torch.float32)
    acc = f[:n * D].view(B, KV, NC, RT, D)
    ml = f[n * D:n * D + 2 * n].view(B, KV, NC, RT, 2)
    return ml[..., 0], ml[..., 1], acc
