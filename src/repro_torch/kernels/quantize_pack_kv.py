"""Fused quantize-and-pack of KV rows (how the Augmented plane is
written): unmasked, masked, with fused integrity words, and the paged KV
write that takes in the scatter around it.

Replaces `repro/kernels/quantize_pack_kv.py:quantize_pack_kv_pallas`:
the plain body `_qpack_kernel`, the masked body `_qpack_masked_kernel`
(the speculative store-back: rows with valid == 0 are written as zero
bytes and a scale of exactly 1.0) and the integrity body
`_qpack_integrity_kernel` (`with_integrity=True`: the pack plus each
row's word sum_j (j + 1) * byte_j mod 2**32). CUDA source:
`csrc/quantize_pack_kv.cu`, one row routine behind four C entry points,
counted apart as `quantize_pack_kv`, `quantize_pack_kv_masked`,
`quantize_pack_kv_integrity` and `paged_kv_write`.

`paged_kv_write` is one layer's KV write into the paged pool: K and V of
every (b, t, KV head) row, the page lookup, the write and commit masks,
the pack (int4, or int8 at qmax 127 with no nibble pack) and the stores
into the layer's arena views, in place, in one launch. The JAX package
packs through the Pallas call and leaves the scatter around it to XLA,
which fuses it into the jitted step (`repro/models/transformer.py:
_paged_scatter`); in eager PyTorch each of those ops is a launch, so the
port's kernel takes them in. Its plain version `paged_kv_write_plain` is
that scatter's body. The speculative store-back goes through it, so no
serving path launches the masked entry (the copy-on-write page op, once
ported, will); like the JAX package, none calls the integrity entry.

What bounds them on an H100: bytes, and at a decode step's 128 rows the
launch. Each row is read once into registers (16-byte loads, 8 lanes a
row at D = 64), its amax reduced by shuffles, and the packed bytes leave
as 32- or 64-bit stores. Bit-exact with the JAX package: both roundings
to bf16 of its bf16 arithmetic are explicit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import meta
from repro_torch.kernels.build import check, library
from repro_torch.models.layers import pack_kv_int4, pack_kv_int8


def _pack_plain(kv: torch.Tensor, valid, aug_bits: int):
    """kv (..., D) -> (levels (..., D//2 | D), scale (..., 1) bf16), the
    pool's packed layout; rows where `valid` (broadcastable to
    kv.shape[:-1]) is False give zero bytes and a unit scale."""
    packed, scale = pack_kv_int4(kv) if aug_bits == 4 else pack_kv_int8(kv)
    if valid is not None:
        keep = torch.broadcast_to(valid, kv.shape[:-1])[..., None]
        packed = torch.where(keep, packed, torch.zeros_like(packed))
        scale = torch.where(keep, scale, torch.ones_like(scale))
    return packed, scale


def quantize_pack_kv_plain(kv: torch.Tensor,
                           valid: Optional[torch.Tensor] = None):
    """kv (N, D) bf16 -> (packed (N, D//2) uint8, scale (N, 1) f32) — the
    oracle `repro.kernels.ref.quantize_pack_kv_ref` computes; with
    `valid` (N,) rows where valid == 0 give zero bytes and scale 1.0."""
    packed, scale = _pack_plain(
        kv, None if valid is None else valid.reshape(-1) != 0, 4)
    return packed, scale.float()


def integrity_words_plain(packed: torch.Tensor) -> torch.Tensor:
    """Per-row integrity word of packed rows (N, Dp) uint8: sum_j (j + 1)
    * byte_j mod 2**32, as (N, 1) int64 (the oracle
    `repro.kernels.ref.integrity_words_ref`, and
    `repro.core.faults.integrity_word` of each row)."""
    lanes = torch.arange(1, packed.shape[-1] + 1, dtype=torch.int64,
                         device=packed.device)
    word = (packed.to(torch.int64) * lanes).sum(dim=-1, keepdim=True)
    return word & 0xFFFFFFFF


def quantize_pack_kv_integrity_plain(kv: torch.Tensor):
    """kv (N, D) bf16 -> (packed, scale, words): the plain pack and the
    integrity word of each packed row."""
    packed, scale = quantize_pack_kv_plain(kv)
    return packed, scale, integrity_words_plain(packed)


def _launch(kv: torch.Tensor, valid: Optional[torch.Tensor],
            words: Optional[torch.Tensor] = None):
    if not kv.is_cuda or (valid is not None and not valid.is_cuda):
        raise ValueError("quantize_pack_kv_cuda takes CUDA tensors")
    if kv.dtype != torch.bfloat16 or kv.ndim != 2 or kv.shape[1] % 2:
        raise ValueError(f"want (N, D) bf16 with D even, got "
                         f"{tuple(kv.shape)} {kv.dtype}")
    N, D = kv.shape
    if valid is not None and valid.numel() != N:
        raise ValueError(f"valid has {valid.numel()} rows, kv {N}")
    kv = kv.contiguous()
    packed = torch.empty((N, D // 2), dtype=torch.uint8, device=kv.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=kv.device)
    if N == 0:
        return packed, scale, False
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    if words is not None:
        err = library().quantize_pack_kv_integrity(
            kv.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            words.data_ptr(), N, D, stream)
        check(err, "quantize_pack_kv_integrity")
    elif valid is None:
        err = library().quantize_pack_kv(
            kv.data_ptr(), packed.data_ptr(), scale.data_ptr(), N, D, stream)
        check(err, "quantize_pack_kv")
    else:
        valid = valid.reshape(-1).to(torch.int32).contiguous()
        err = library().quantize_pack_kv_masked(
            kv.data_ptr(), valid.data_ptr(), packed.data_ptr(),
            scale.data_ptr(), N, D, stream)
        check(err, "quantize_pack_kv_masked")
    return packed, scale, True


def quantize_pack_kv_cuda(kv: torch.Tensor):
    """Launch the CUDA kernel; same contract as `quantize_pack_kv_plain`
    without a mask."""
    packed, scale, launched = _launch(kv, None)
    quantize_pack_kv_cuda.launches += launched
    return packed, scale


def quantize_pack_kv_masked_cuda(kv: torch.Tensor, valid: torch.Tensor):
    """Launch the masked entry point; same contract as
    `quantize_pack_kv_plain(kv, valid)`."""
    packed, scale, launched = _launch(kv, valid)
    quantize_pack_kv_masked_cuda.launches += launched
    return packed, scale


def quantize_pack_kv_integrity_cuda(kv: torch.Tensor):
    """Launch the integrity entry point; same contract as
    `quantize_pack_kv_integrity_plain`."""
    if not kv.is_cuda:
        raise ValueError("quantize_pack_kv_integrity_cuda takes CUDA tensors")
    words = torch.empty((kv.shape[0], 1), dtype=torch.int64,
                        device=kv.device)
    packed, scale, launched = _launch(kv, None, words)
    quantize_pack_kv_integrity_cuda.launches += launched
    return packed, scale, words


quantize_pack_kv_cuda.launches = 0
quantize_pack_kv_masked_cuda.launches = 0
quantize_pack_kv_integrity_cuda.launches = 0


def paged_kv_write_plain(kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write,
                         commit, page_table, page_modes, *, page_size: int,
                         policy: str, aug_bits: int) -> None:
    """Scatter per-token KV rows (B, T, KV, hd) at absolute positions pos
    (B, T) into the plane each token's page is in, IN PLACE: one layer's
    arena views kn/vn (Nn, KV, page, hd) bf16, kp/vp (Np, KV, page,
    hd//2 | hd), ks/vs (Np, KV, page) bf16. Tokens with write == False
    are redirected to physical page 0, the write-dump page, so the other
    rows' pages stay bit-identical. `commit` (B, T) bool, optional: the
    speculative accept mask; tokens with commit == False are WRITTEN at
    their slot as zeros (zero bf16 rows in the Normal plane, zero bytes
    and a unit scale in the Augmented plane). `policy` pins the planes
    written: "always-augmented" skips the Normal plane, "normal-only"
    the Augmented one."""
    # rows outside the write mask may sit past the table (stale positions
    # of idle rows, padded prefill tails): clamp the lookup, the write is
    # redirected to the dump page anyway
    lp = (pos // page_size).clamp(max=page_table.shape[1] - 1).long()
    slot = (pos % page_size).long()
    phys = torch.gather(page_table, 1, lp).long()
    mode = torch.gather(page_modes, 1, lp)
    if commit is not None:
        keep = commit[:, :, None, None]
        k_new = torch.where(keep, k_new, torch.zeros_like(k_new))
        v_new = torch.where(keep, v_new, torch.zeros_like(v_new))
    if policy != "always-augmented":
        pn = torch.where(write & (mode == 0), phys, 0)
        kn[pn, :, slot] = k_new.to(torch.bfloat16)
        vn[pn, :, slot] = v_new.to(torch.bfloat16)
    if policy != "normal-only":
        pp = torch.where(write & (mode == 1), phys, 0)
        valid = None if commit is None else commit[:, :, None]
        kq, k_scale = _pack_plain(k_new, valid, aug_bits)
        vq, v_scale = _pack_plain(v_new, valid, aug_bits)
        kp[pp, :, slot] = kq
        vp[pp, :, slot] = vq
        ks[pp, :, slot] = k_scale[..., 0].to(torch.bfloat16)
        vs[pp, :, slot] = v_scale[..., 0].to(torch.bfloat16)


def _expect(t: torch.Tensor, name: str, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (an arena view)")


def _write_launch(kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write, commit,
                  page_table, page_modes, page_size: int, policy: str,
                  aug_bits: int) -> bool:
    """Check what the kernel takes and launch it; False where there is
    no row to write."""
    if aug_bits not in (4, 8):
        raise ValueError(f"aug_bits must be 4 or 8, got {aug_bits}")
    if k_new.ndim != 4 or k_new.dtype != torch.bfloat16 \
            or v_new.shape != k_new.shape or v_new.dtype != torch.bfloat16:
        raise ValueError(f"want k_new, v_new (B, T, KV, hd) bf16, got "
                         f"{tuple(k_new.shape)} {k_new.dtype}, "
                         f"{tuple(v_new.shape)} {v_new.dtype}")
    B, T, KV, D = k_new.shape
    if D % 2:
        raise ValueError(f"hd must be even, got {D}")
    # rows by stride; only a row that is not contiguous is copied
    k_new = k_new if k_new.stride(-1) == 1 else k_new.contiguous()
    v_new = v_new if v_new.stride(-1) == 1 else v_new.contiguous()
    Nn, Np = kn.shape[0], kp.shape[0]
    for name, t in (("kn", kn), ("vn", vn)):
        _expect(t, name, (Nn, KV, page_size, D), torch.bfloat16)
    packed_dt = torch.uint8 if aug_bits == 4 else torch.int8
    d_store = D // 2 if aug_bits == 4 else D
    for name, t in (("kp", kp), ("vp", vp)):
        _expect(t, name, (Np, KV, page_size, d_store), packed_dt)
    for name, t in (("ks", ks), ("vs", vs)):
        _expect(t, name, (Np, KV, page_size), torch.bfloat16)
    if page_table.ndim != 2 or page_table.shape[0] < B:
        raise ValueError(f"page_table {tuple(page_table.shape)} has fewer "
                         f"than B={B} rows")
    maxP = page_table.shape[1]
    _expect(page_table, "page_table", (page_table.shape[0], maxP),
            torch.int32)
    _expect(page_modes, "page_modes", page_table.shape, torch.int32)
    if tuple(pos.shape) != (B, T) or pos.dtype not in (torch.int32,
                                                         torch.int64):
        raise ValueError(f"pos: want ({B}, {T}) int32 or int64, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    masks = [("write", write)] + ([] if commit is None
                                  else [("commit", commit)])
    for name, t in masks:
        if tuple(t.shape) != (B, T) or t.dtype != torch.bool:
            raise ValueError(f"{name}: want ({B}, {T}) bool, got "
                             f"{tuple(t.shape)} {t.dtype}")
    pos, write = pos.contiguous(), write.contiguous()
    commit = None if commit is None else commit.contiguous()
    if B * T * KV == 0:
        return False
    planes = int(policy != "always-augmented") \
        | int(policy != "normal-only") << 1
    stream = torch.cuda.current_stream(k_new.device).cuda_stream
    err = library().paged_kv_write(
        k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(),
        write.data_ptr(), None if commit is None else commit.data_ptr(),
        page_table.data_ptr(), page_modes.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), B, T, KV, D, page_size, maxP, *k_new.stride()[:3],
        *v_new.stride()[:3], int(pos.dtype == torch.int64), planes,
        aug_bits, stream)
    check(err, "paged_kv_write")
    return True


def paged_kv_write_cuda(kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write,
                        commit, page_table, page_modes, *, page_size: int,
                        policy: str, aug_bits: int) -> None:
    """Launch the fused paged KV write; same contract as
    `paged_kv_write_plain`. Page >= 1 gets the plain version's bits; two
    masked-off rows that land on one dump slot leave it unspecified, as
    `index_put_` on the card does."""
    tensors = (kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write,
               page_table, page_modes) + (() if commit is None
                                          else (commit,))
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_kv_write_cuda takes CUDA tensors")
    paged_kv_write_cuda.launches += _write_launch(
        kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write, commit,
        page_table, page_modes, page_size, policy, aug_bits)


paged_kv_write_cuda.launches = 0


# ---------------------------------------------------------------------------
# Meta route (`kernels/meta.py`): shapes, launches, FLOPs and bytes
# ---------------------------------------------------------------------------

def _pack_meta(name, kv, valid=None):
    N, D = kv.shape
    packed = meta.empty((N, D // 2), torch.uint8)
    scale = meta.empty((N, 1), torch.float32)
    meta.launched(name, 0, meta.nbytes(kv, valid, packed, scale), N > 0)
    return packed, scale


def quantize_pack_kv_meta(kv: torch.Tensor):
    return _pack_meta("quantize_pack_kv", kv)


def quantize_pack_kv_masked_meta(kv: torch.Tensor, valid: torch.Tensor):
    return _pack_meta("quantize_pack_kv_masked", kv, valid)


def paged_kv_write_meta(kn, vn, kp, vp, ks, vs, k_new, v_new, pos, write,
                        commit, page_table, page_modes, *, page_size: int,
                        policy: str, aug_bits: int) -> None:
    """Reads the new rows, masks and table rows; writes each token's K
    and V row into the planes `policy` names."""
    B, T, KV, D = k_new.shape
    rows = 2 * B * T * KV
    written = 0
    if policy != "always-augmented":
        written += rows * D * 2
    if policy != "normal-only":
        written += rows * ((D // 2 if aug_bits == 4 else D) + 2)
    meta.launched("paged_kv_write", 0,
                  meta.nbytes(k_new, v_new, pos, write, commit)
                  + 2 * B * page_table.shape[1] * page_table.element_size()
                  + written,
                  B * T * KV > 0)
