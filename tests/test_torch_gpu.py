"""On the card: each CUDA kernel against its plain PyTorch version, and
the model's first prefill chunk / decode step through the kernels against
the plain route, at the reduced config. Imports torch and the port only,
so it runs where jax is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Every test skips (inside the test) where there is no CUDA device.
Tolerances: packed bytes, scales and integrity words exact; rel_err <
0.01 (kernel 1), < 0.03 (attention, as tests/test_kernels.py holds the
Pallas kernels), < 0.05 (logits), as the CPU parity tests use; each
window slot bit-identical to the decode kernel at its horizon; the IMC
kernels and their quantize pass bit-identical to their plain versions
(int8 weights past K = 1040, where the plain float32 shift-add rounds:
rel_err <= 1e-6); the port's bf16 GEMM against torch.matmul within
2^-7 of the output's largest magnitude (two f32 sums, each rounded to
bf16, may land one bf16 ulp apart); every row of the fixed-order GEMMs
and of the RMS norm the same bits at every row count, and a verify
window the same bits as the decode steps it replaces.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels.dual_plane_matmul import (dual_plane_matmul_cuda,
                                                   dual_plane_matmul_plain)
from repro_torch.kernels.imc_dot import (imc_dot_cuda, imc_dot_levels,
                                         imc_dot_plain, imc_dual_dot_cuda,
                                         imc_dual_dot_levels,
                                         imc_dual_dot_plain, qmax_for,
                                         quantize_activations,
                                         quantize_activations_cuda)
from repro_torch.kernels.packed_kv_attention import (
    packed_kv_attention_cuda, packed_kv_attention_plain)
from repro_torch.kernels.paged_kv_attention import (
    paged_kv_attention_cuda, paged_kv_attention_plain,
    paged_kv_attention_window_cuda, paged_kv_attention_window_plain)
from repro_torch.kernels.quantize_pack_kv import (
    integrity_words_plain, paged_kv_write_cuda, paged_kv_write_plain,
    quantize_pack_kv_cuda, quantize_pack_kv_integrity_cuda,
    quantize_pack_kv_integrity_plain, quantize_pack_kv_masked_cuda,
    quantize_pack_kv_plain)
from repro_torch.kernels.ternary_matmul import (dense_matmul_cuda,
                                                dense_matmul_plain,
                                                ternary_matmul_cuda,
                                                ternary_matmul_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("M,K,N", [(1, 1024, 1024), (4, 1024, 2816),
                                   (8, 2816, 1024), (9, 256, 128),
                                   (128, 2816, 1024), (40, 128, 64),
                                   (16, 1024, 2816), (128, 1024, 1024)])
def test_ternary_matmul_cuda_vs_plain(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    digits = torch.randint(0, 3, (K // 4, N, 4), generator=g, device=cuda,
                           dtype=torch.uint8)
    w = digits[..., 0] | (digits[..., 1] << 2) | (digits[..., 2] << 4) \
        | (digits[..., 3] << 6)
    scale = torch.rand((1, N), generator=g, device=cuda) * 0.1
    assert rel_err(ternary_matmul_cuda(x, w, scale),
                   ternary_matmul_plain(x, w, scale)) < 0.01


@pytest.mark.parametrize("n,d", [(1, 64), (64, 64), (2048, 64), (37, 32)])
def test_quantize_pack_kv_cuda_bit_exact(cuda, n, d):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n, d), generator=g, device=cuda) \
        * torch.rand((n, 1), generator=g, device=cuda) * 30
    x[: n // 4] = torch.round(x[: n // 4] * 2) / 2      # exact half steps
    x[0] = 0.0                                          # amax == 0
    x = x.to(torch.bfloat16)
    p, s = quantize_pack_kv_cuda(x)
    pw, sw = quantize_pack_kv_plain(x)
    assert torch.equal(p, pw) and torch.equal(s, sw)


def random_pool(cuda, g, B, KV, D, page, maxP, kv_bits):
    """A two-plane pool with random contents, random page modes and
    disjoint physical pages per row."""
    Nn = Np = B * maxP + 1
    d_store = D // 2 if kv_bits == 4 else D
    kn = torch.randn((Nn, KV, page, D), generator=g, device=cuda
                     ).to(torch.bfloat16)
    vn = torch.randn((Nn, KV, page, D), generator=g, device=cuda
                     ).to(torch.bfloat16)
    lo, hi, dt = (0, 256, torch.uint8) if kv_bits == 4 \
        else (-127, 128, torch.int8)
    kp = torch.randint(lo, hi, (Np, KV, page, d_store), generator=g,
                       device=cuda, dtype=dt)
    vp = torch.randint(lo, hi, (Np, KV, page, d_store), generator=g,
                       device=cuda, dtype=dt)
    ks = (torch.rand((Np, KV, page), generator=g, device=cuda) * 0.05
          ).to(torch.bfloat16)
    vs = (torch.rand((Np, KV, page), generator=g, device=cuda) * 0.05
          ).to(torch.bfloat16)
    modes = torch.randint(0, 2, (B, maxP), generator=g, device=cuda,
                          dtype=torch.int32)
    perm = torch.randperm(Nn - 1, generator=g, device=cuda)[:B * maxP] + 1
    table = perm.view(B, maxP).to(torch.int32)
    return (kn, vn, kp, vp, ks, vs), (table, modes)


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("B,KV,Hg,D,page,maxP,lengths", [
    (3, 2, 1, 32, 8, 4, [1, 32, 13]),
    (2, 2, 4, 32, 16, 3, [48, 17]),
    (4, 16, 1, 64, 16, 32, [1, 512, 200, 77]),
    (2, 16, 4, 64, 16, 32, [600, 33]),
])
def test_paged_kv_attention_cuda_vs_plain(cuda, kv_bits, B, KV, Hg, D, page,
                                          maxP, lengths):
    g = torch.Generator(device=cuda).manual_seed(B * KV + Hg)
    planes, (table, modes) = random_pool(cuda, g, B, KV, D, page, maxP,
                                         kv_bits)
    q = torch.randn((B, KV, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    args = (q, *planes, lens, table, modes)
    assert rel_err(paged_kv_attention_cuda(*args, kv_bits=kv_bits),
                   paged_kv_attention_plain(*args, kv_bits=kv_bits)) < 0.03


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("B,KV,W,Hg,D,page,maxP,starts", [
    (2, 2, 4, 2, 32, 8, 4, [6, 3]),            # straddles a page
    (2, 2, 8, 2, 32, 8, 4, [8, 0]),            # window == page
    (4, 8, 4, 4, 64, 16, 32, [0, 17, 300, 508]),   # granite's verify read
    (2, 4, 8, 4, 64, 16, 8, [40, 120]),        # 32 rows: two MMA tiles
    (1, 2, 16, 4, 64, 16, 4, [55]),            # 64 rows, past the end
    (2, 2, 16, 4, 128, 16, 8, [40, 107]),      # minitron's Hg, D: one CTA
])
def test_window_kernel_slotwise_bit_identical(cuda, kv_bits, B, KV, W, Hg, D,
                                              page, maxP, starts):
    """Each window slot equals the decode kernel at starts + w + 1 bit for
    bit, and the window holds its plain version."""
    g = torch.Generator(device=cuda).manual_seed(W * 100 + B)
    planes, tables = random_pool(cuda, g, B, KV, D, page, maxP, kv_bits)
    q = torch.randn((B, KV, W, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    ow = paged_kv_attention_window_cuda(q, *planes, st, *tables,
                                        kv_bits=kv_bits)
    for w in range(W):
        o1 = paged_kv_attention_cuda(q[:, :, w], *planes, st + w + 1,
                                     *tables, kv_bits=kv_bits)
        assert torch.equal(ow[:, :, w].view(torch.int16),
                           o1.view(torch.int16)), f"slot {w}"
    assert rel_err(ow, paged_kv_attention_window_plain(
        q, *planes, st, *tables, kv_bits=kv_bits)) < 0.03


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("B,KV,Hg,D,page,maxP,lengths", [
    # 0, 1, the 64-token chunk's edges, maxP * page and past it
    (8, 2, 4, 64, 16, 12, [0, 1, 63, 64, 65, 128, 192, 500]),
    (6, 2, 2, 32, 8, 20, [8, 9, 63, 64, 65, 160]),      # 8 pages a chunk
    (4, 8, 4, 64, 16, 32, [1, 512, 200, 77]),           # granite's decode
])
def test_paged_kv_attention_cuda_chunk_edges(cuda, kv_bits, B, KV, Hg, D,
                                             page, maxP, lengths):
    """Lengths on the split chunks' and the pages' edges and past the
    table, over mixed planes; a row of length 0 gives the mean V of its
    first page (every score masked), as the TPU kernel does."""
    g = torch.Generator(device=cuda).manual_seed(B * page + kv_bits)
    planes, (table, modes) = random_pool(cuda, g, B, KV, D, page, maxP,
                                         kv_bits)
    q = torch.randn((B, KV, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    args = (q, *planes, lens, table, modes)
    got = paged_kv_attention_cuda(*args, kv_bits=kv_bits)
    want = paged_kv_attention_plain(*args, kv_bits=kv_bits)
    live = lens > 0
    assert rel_err(got[live], want[live]) < 0.03
    # the first page's mean V: the plain read of q = 0 at length page
    first = paged_kv_attention_plain(torch.zeros_like(q), *planes,
                                     torch.full_like(lens, page), table,
                                     modes, kv_bits=kv_bits)
    if not live.all():
        assert rel_err(got[~live], first[~live]) < 0.03


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("B,KV,W,Hg,D,page,maxP,starts", [
    (4, 2, 4, 4, 64, 16, 12, [60, 61, 62, 63]),    # slots cross chunk 0 -> 1
    (3, 2, 8, 2, 32, 8, 20, [57, 120, 150]),       # 8 pages a chunk
    (2, 2, 16, 4, 64, 16, 8, [50, 112]),           # 64 rows: four tiles
])
def test_window_kernel_chunk_edges_bit_identical(cuda, kv_bits, B, KV, W, Hg,
                                                 D, page, maxP, starts):
    """Windows whose slots straddle a chunk's edge and run past the
    table: each slot equals the decode kernel at starts + w + 1 bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(W * 7 + page)
    planes, tables = random_pool(cuda, g, B, KV, D, page, maxP, kv_bits)
    q = torch.randn((B, KV, W, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    ow = paged_kv_attention_window_cuda(q, *planes, st, *tables,
                                        kv_bits=kv_bits)
    for w in range(W):
        o1 = paged_kv_attention_cuda(q[:, :, w], *planes, st + w + 1,
                                     *tables, kv_bits=kv_bits)
        assert torch.equal(ow[:, :, w].view(torch.int16),
                           o1.view(torch.int16)), f"slot {w}"
    assert rel_err(ow, paged_kv_attention_window_plain(
        q, *planes, st, *tables, kv_bits=kv_bits)) < 0.03


def test_paged_rows_independent_of_batch(cuda):
    """A row's output bits are the same under a shuffle of the rows and
    alone (B = 1) as among B = 4, for both entries."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, KV, W, Hg, D, page, maxP = 4, 8, 4, 4, 64, 16, 32
    planes, (table, modes) = random_pool(cuda, g, B, KV, D, page, maxP, 4)
    q = torch.randn((B, KV, W, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    st = torch.tensor([3, 500, 130, 64], dtype=torch.int32, device=cuda)
    perm = torch.tensor([2, 0, 3, 1], device=cuda)
    for window in (False, True):
        fn = paged_kv_attention_window_cuda if window \
            else paged_kv_attention_cuda
        qq = q if window else q[:, :, 0].contiguous()
        full = fn(qq, *planes, st, table, modes, kv_bits=4)
        shuf = fn(qq[perm], *planes, st[perm], table[perm], modes[perm],
                  kv_bits=4)
        assert torch.equal(shuf.view(torch.int16),
                           full[perm].view(torch.int16))
        for b in range(B):
            one = fn(qq[b:b + 1], *planes, st[b:b + 1], table[b:b + 1],
                     modes[b:b + 1], kv_bits=4)
            assert torch.equal(one[0].view(torch.int16),
                               full[b].view(torch.int16)), (window, b)


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("B,KV,W,Hg,D,page,maxP,starts", [
    (4, 2, 4, 4, 64, 16, 12, [0, 61, 100, 188]),   # granite's verify shape
    (2, 2, 16, 4, 128, 16, 6, [40, 70]),           # minitron's: four tiles
    (3, 2, 4, 1, 64, 8, 20, [5, 63, 150]),         # qwen's Hg, 8 pages a chunk
])
def test_paged_kernel_vs_split_merge_mirror(cuda, kv_bits, B, KV, W, Hg, D,
                                            page, maxP, starts):
    """Both entries against `paged_split_merge_mirror`, the kernel's order
    in torch with its model of the tensor core's add, on the same operands
    on the card: the chunk partials (max, denominator, accumulator) of
    every chunk a row's merge takes, and the outputs, rel_err <= 1e-6."""
    from repro_torch.kernels import paged_kv_attention as pka
    from torch_paged_mirror import (chunk_partials, paged_split_merge_mirror,
                                    paged_split_merge_parts)
    g = torch.Generator(device=cuda).manual_seed(kv_bits + D + page)
    planes, tables = random_pool(cuda, g, B, KV, D, page, maxP, kv_bits)
    q = torch.randn((B, KV, W, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    for window in (True, False):
        qq, w = (q, W) if window else (q[:, :, :1], 1)
        base = st if window else st + 1
        scratch = torch.empty(pka.scratch_bytes(B, KV, w, Hg, D, page, maxP),
                              dtype=torch.uint8, device=cuda)
        name = "paged_kv_attention_window" if window else "paged_kv_attention"
        out = pka._launch(name, qq, *planes, base, *tables, kv_bits,
                          scratch=scratch)
        mq = qq if window else qq[:, :, 0]
        m, l, acc, nch = paged_split_merge_parts(
            mq, *planes, base, *tables, kv_bits=kv_bits, window=window)
        takes = (torch.arange(m.shape[2])[None, :, None] < nch[:, None, :]
                 ).to(cuda)[:, None].expand_as(m)
        for got, want in zip(chunk_partials(scratch, B, KV, w, Hg, D, page,
                                            maxP), (m, l, acc)):
            assert rel_err(got[takes], want[takes]) <= 1e-6
        mirror = paged_split_merge_mirror(mq, *planes, base, *tables,
                                          kv_bits=kv_bits, window=window)
        assert rel_err(out.reshape(mirror.shape), mirror) <= 1e-6, window


@pytest.mark.parametrize("B,KV,W,Hg,D,page,maxP,base", [
    (4, 2, 1, 4, 64, 16, 12, [1, 63, 65, 192]),    # decode, at lengths
    (3, 2, 4, 2, 32, 8, 20, [57, 120, 158]),       # 8 pages a chunk
    (2, 2, 16, 8, 64, 16, 8, [56, 112]),           # two slot groups
])
def test_paged_chunks_written_tile_pages_and_fill_scratch(
        cuda, B, KV, W, Hg, D, page, maxP, base):
    """The chunk CTAs that write partials into a NaN-filled scratch are,
    for each (row, KV head) and slot group, chunks 0 .. n - 1 of
    `chunk_plan(page)` whole pages, in order: n is the fewest that hold
    the last page the group's last slot reads, and every later chunk
    stays unwritten. The scratch is `scratch_bytes` long exactly: a row
    at the table's end writes its last record, and the bytes past it are
    never written."""
    from repro_torch.kernels import paged_kv_attention as pka
    from torch_paged_mirror import chunk_partials
    g = torch.Generator(device=cuda).manual_seed(W + page)
    planes, tables = random_pool(cuda, g, B, KV, D, page, maxP, 4)
    q = torch.randn((B, KV, W, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    n = pka.scratch_bytes(B, KV, W, Hg, D, page, maxP)
    buf = torch.full((n + 64,), 255, dtype=torch.uint8, device=cuda)
    name = "paged_kv_attention" if W == 1 else "paged_kv_attention_window"
    pka._launch(name, q, *planes,
                torch.tensor(base, dtype=torch.int32, device=cuda), *tables,
                4, scratch=buf[:n])
    m, _, acc = chunk_partials(buf[:n], B, KV, W, Hg, D, page, maxP)
    written = ~torch.isnan(m)                         # (B, KV, NC, W * Hg)
    assert torch.equal(written, ~torch.isnan(acc).any(dim=-1))
    ppc, wc = pka.chunk_plan(page), pka.window_plan(W, Hg)
    for b in range(B):
        for w0 in range(0, W, wc):
            last = min(w0 + wc, W) - 1
            hz = min(base[b] + (W > 1) + last, maxP * page)
            pages = max(-(-hz // page), 1)
            n_ch = -(-pages // ppc)
            rows = slice(w0 * Hg, (last + 1) * Hg)
            assert bool(written[b, :, :n_ch, rows].all()), (b, w0)
            assert not bool(written[b, :, n_ch:, rows].any()), (b, w0)
    assert bool(written[-1, -1, -1, -1])              # the last record
    assert bool((buf[n:] == 255).all())               # nothing past it


@pytest.mark.parametrize("n,d", [(64, 64), (4 * 4 * 8, 64), (37, 32)])
def test_masked_pack_cuda_bit_exact(cuda, n, d):
    g = torch.Generator(device=cuda).manual_seed(n + d)
    x = (torch.randn((n, d), generator=g, device=cuda) * 4
         ).to(torch.bfloat16)
    x[1] = 0.0
    valid = torch.rand((n,), generator=g, device=cuda) < 0.5
    valid[1] = True
    p, s = quantize_pack_kv_masked_cuda(x, valid)
    pw, sw = quantize_pack_kv_plain(x, valid)
    assert torch.equal(p, pw) and torch.equal(s, sw)
    assert (s[~valid] == 1.0).all() and not p[~valid].any()


@pytest.mark.parametrize("M", [1, 4, 16, 17, 128])
@pytest.mark.parametrize("K,N", [(2048, 512), (128, 256), (256, 64),
                                 (2048, 8192)])
def test_dual_plane_matmul_cuda_vs_plain(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    buf = torch.randint(0, 256, (K, N), generator=g, device=cuda,
                        dtype=torch.uint8)
    hs = torch.rand((1, N), generator=g, device=cuda) * 0.1
    ls = torch.rand((1, N), generator=g, device=cuda) * 0.1
    got = dual_plane_matmul_cuda(x, buf, hs, ls)
    want = dual_plane_matmul_plain(x, buf, hs, ls)
    for a, b in zip(got, want):           # exact sums: equal bit for bit
        assert torch.equal(a, b), rel_err(a, b)


def test_dual_rows_do_not_depend_on_m(cuda):
    """Exact sums: a row's bits are the same on every route and at every
    M: decode-size calls (the GEMV, M <= 4), verify-size calls (16-row
    float64 tensor-core tiles, 4 < M <= 16) and prefill-size calls
    (128-row tiles, split in K where they do not fill the card), across
    each route boundary and the 128-row tile's edge."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for N in (512, 8192):
        x = torch.randn((160, 2048), generator=g, device=cuda
                        ).to(torch.bfloat16)
        buf = torch.randint(0, 256, (2048, N), generator=g, device=cuda,
                            dtype=torch.uint8)
        hs = torch.rand((1, N), generator=g, device=cuda)
        ls = torch.rand((1, N), generator=g, device=cuda)
        full = dual_plane_matmul_cuda(x, buf, hs, ls)
        for a, b in zip(full, dual_plane_matmul_plain(x, buf, hs, ls)):
            assert torch.equal(a, b)
        for m in (1, 4, 5, 8, 16, 17, 128, 129):
            part = dual_plane_matmul_cuda(x[:m].contiguous(), buf, hs, ls)
            for a, b in zip(part, full):
                assert torch.equal(a, b[:m]), (N, m)


@pytest.mark.parametrize("spread", [0, 20])
def test_dual_plane_matmul_cuda_wide_activations(cuda, spread):
    """Rows whose activations span 20 binades still sum exactly: every
    route equals the plain version bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(spread)
    x = torch.randn((128, 2048), generator=g, device=cuda) * torch.exp2(
        (torch.rand((128, 2048), generator=g, device=cuda) - 0.5) * spread)
    x = x.to(torch.bfloat16)
    buf = torch.randint(0, 256, (2048, 512), generator=g, device=cuda,
                        dtype=torch.uint8)
    hs = torch.rand((1, 512), generator=g, device=cuda)
    ls = torch.rand((1, 512), generator=g, device=cuda)
    for m in (4, 16, 128):
        got = dual_plane_matmul_cuda(x[:m].contiguous(), buf, hs, ls)
        want = dual_plane_matmul_plain(x[:m], buf, hs, ls)
        for a, b in zip(got, want):
            assert torch.equal(a, b), m


@pytest.mark.parametrize("kv_mode", ["int8", "int4"])
def test_model_steps_kernels_vs_plain_route(cuda, kv_mode):
    """The reduced model's first prefill chunk and decode step through
    the kernels (kv_impl="kernel", matmul_impl="packed") against the plain
    route (dequant / dense) on the same card and weights."""
    from repro_torch.configs import get_arch
    from repro_torch.models import augment
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.serve.cache_pool import PagedKVPool
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode=kv_mode))
    plain = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant", matmul_impl="dense"))
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    params = augment.augment_params(cfg, init_params(dense, seed=1,
                                                     device=cuda))
    B, C = 2, 16
    pool = PagedKVPool(cfg, max_batch=B, max_seq=64, device=cuda)
    for r in range(B):
        pool.admit_row(r, C + 1, step=0)
    arenas_k = pool.arenas
    arenas_p = {k: v.clone() for k, v in arenas_k.items()}
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {**pool.device_tables(),
             "tokens": torch.randint(0, cfg.vocab, (B, C), generator=g,
                                     device=cuda, dtype=torch.int32),
             "positions": torch.zeros(B, dtype=torch.int32, device=cuda),
             "write_mask": torch.ones(B, dtype=torch.bool, device=cuda)}
    V = cfg.vocab
    with torch.no_grad():
        lk, _ = M.paged_prefill_step(cfg, params, arenas_k, batch)
        lp, _ = M.paged_prefill_step(plain, params, arenas_p, batch)
        assert rel_err(lk[..., :V], lp[..., :V]) < 0.05
        batch.update(tokens=lp[:, -1, :V].argmax(-1).to(torch.int32)[:, None],
                     positions=torch.full((B,), C, dtype=torch.int32,
                                          device=cuda))
        dk, _ = M.paged_decode_step(cfg, params, arenas_k, batch)
        dp, _ = M.paged_decode_step(plain, params, arenas_p, batch)
        assert rel_err(dk[..., :V], dp[..., :V]) < 0.05


def test_granite_steps_kernels_vs_plain_route(cuda):
    """Reduced granite (dual weights, int4 KV, GQA variant) through the
    kernels against the plain route on the same card and weights: the
    first prefill chunk, a decode step and a verify window."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import augment
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.serve.cache_pool import PagedKVPool
    cfg = get_arch("granite-3-2b").reduced()
    cfg = dataclasses.replace(cfg, n_kv_heads=2)
    plain = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant", matmul_impl="dense"))
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    params = augment.augment_params(cfg, init_params(dense, seed=3,
                                                     device=cuda))
    B, C, W = 2, 16, 4
    pool = PagedKVPool(cfg, max_batch=B, max_seq=64, device=cuda)
    for r in range(B):
        pool.admit_row(r, C + 1 + W, step=0)
    arenas_k = pool.arenas
    arenas_p = {k: v.clone() for k, v in arenas_k.items()}
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {**pool.device_tables(),
             "tokens": torch.randint(0, cfg.vocab, (B, C), generator=g,
                                     device=cuda, dtype=torch.int32),
             "positions": torch.zeros(B, dtype=torch.int32, device=cuda),
             "write_mask": torch.ones(B, dtype=torch.bool, device=cuda)}
    V = cfg.vocab
    ops.reset_launch_counts()
    with torch.no_grad():
        lk, _ = M.paged_prefill_step(cfg, params, arenas_k, batch)
        lp, _ = M.paged_prefill_step(plain, params, arenas_p, batch)
        assert rel_err(lk[..., :V], lp[..., :V]) < 0.05
        nxt = lp[:, -1, :V].argmax(-1).to(torch.int32)
        batch.update(tokens=nxt[:, None], positions=torch.full(
            (B,), C, dtype=torch.int32, device=cuda))
        dk, _ = M.paged_decode_step(cfg, params, arenas_k, batch)
        dp, _ = M.paged_decode_step(plain, params, arenas_p, batch)
        assert rel_err(dk[..., :V], dp[..., :V]) < 0.05
        win = torch.randint(0, cfg.vocab, (B, W), generator=g, device=cuda,
                            dtype=torch.int32)
        win[:, 0] = dp[:, -1, :V].argmax(-1)
        batch.update(tokens=win, positions=torch.full(
            (B,), C + 1, dtype=torch.int32, device=cuda),
            write_mask=torch.ones((B, W), dtype=torch.bool, device=cuda))
        vk, _ = M.paged_verify_step(cfg, params, arenas_k, batch)
        vp, _ = M.paged_verify_step(plain, params, arenas_p, batch)
        assert rel_err(vk[..., :V], vp[..., :V]) < 0.05
    counts = ops.launch_counts()
    for k in ("dual_plane_matmul", "paged_kv_attention",
              "paged_kv_attention_window", "paged_kv_write"):
        assert counts[k] > 0, counts


def imc_weights(g, cuda, fmt, K, N):
    rows = {"ternary": K // 4, "int4": K // 2, "int8": K, "dual": K}[fmt]
    if fmt == "int8":
        w = torch.randint(-127, 128, (rows, N), generator=g, device=cuda,
                          dtype=torch.int8)
    else:
        w = torch.randint(0, 256, (rows, N), generator=g, device=cuda,
                          dtype=torch.uint8)
    return w, torch.rand((1, N), generator=g, device=cuda) * 0.05


@pytest.mark.parametrize("abits", [1, 4, 8])
def test_imc_quantize_cuda_bit_exact(cuda, abits):
    g = torch.Generator(device=cuda).manual_seed(abits)
    x = torch.randn((64, 1024), generator=g, device=cuda) \
        * torch.rand((64, 1), generator=g, device=cuda) * 20
    x[0] = 0.0
    x[1] = torch.round(x[1] * 2) / 2
    x[2] = 1.0
    x[2, 5] = 2.0                           # x / xs lands on .5 ties
    x = x.to(torch.bfloat16)
    q, s = quantize_activations_cuda(x, abits)
    qw, sw = quantize_activations(x, abits)
    assert torch.equal(q, qw) and torch.equal(s, sw)


# (M, abits, K, N): the first six as before (K = 1024, N = 256); then
# every M of the one-launch decode route at the K where its split changes
# (one 64-deep unit a CTA at N = 512: S = 1, 3, 5; several at 2816) and
# N = 64 and 512 (16 columns a CTA); the levels and scales the call used
# held to `quantize_activations` too
IMC_DECODE_KN = [(64, 64), (192, 512), (320, 512), (512, 64), (2816, 64),
                 (2816, 512)]
IMC_CASES = [(1, 8, 1024, 256), (4, 8, 1024, 256), (4, 1, 1024, 256),
             (16, 4, 1024, 256), (40, 8, 1024, 256), (128, 4, 1024, 256)]
IMC_CASES += [(M, (8, 4, 1)[M % 3], K, N) for M in range(1, 17)
              for K, N in IMC_DECODE_KN]


def assert_imc_equal(got, want, fmt, K):
    """Bit for bit, but int8 weights past K = 1040 (the plain float32
    shift-add may round there): rel_err <= 1e-6."""
    if fmt == "int8" and K > 1040:
        assert rel_err(got, want) <= 1e-6
    else:
        assert torch.equal(got, want), rel_err(got, want)


@pytest.mark.parametrize("fmt", ["ternary", "int4", "int8"])
@pytest.mark.parametrize("M,abits,K,N", IMC_CASES)
def test_imc_dot_cuda_bit_exact(cuda, fmt, M, abits, K, N):
    """The one-launch decode route (M <= 16) and the prepass + tiles
    (M > 16) equal the plain bit-serial version bit for bit, and quantize
    as `quantize_activations` does."""
    g = torch.Generator(device=cuda).manual_seed(M + abits + K + N)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    w, scale = imc_weights(g, cuda, fmt, K, N)
    got, xq, xs = imc_dot_levels(x, w, scale, fmt=fmt, abits=abits)
    want = imc_dot_plain(x, w, scale, fmt=fmt, abits=abits)
    qw, sw = quantize_activations(x, abits)
    assert torch.equal(xq, qw) and torch.equal(xs, sw)
    assert_imc_equal(got, want, fmt, K)


def test_imc_dot_int8_past_exact_k(cuda):
    """int8 weights at K = 2816: the kernel's int32 sum is exact, the
    plain float32 shift-add may round."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for M in (4, 128):
        x = torch.randn((M, 2816), generator=g, device=cuda
                        ).to(torch.bfloat16)
        w, scale = imc_weights(g, cuda, "int8", 2816, 1024)
        assert rel_err(imc_dot_cuda(x, w, scale, fmt="int8", abits=8),
                       imc_dot_plain(x, w, scale, fmt="int8",
                                     abits=8)) <= 1e-6


# (M, K, N): the first three as before (K = 2048, N = 512); then every M
# of the decode route at the K where its split changes, N = 64 and 512
IMC_DUAL_CASES = [(4, 2048, 512), (9, 2048, 512), (128, 2048, 512)]
IMC_DUAL_CASES += [(M, K, N) for M in range(1, 17) for K, N in IMC_DECODE_KN]


@pytest.mark.parametrize("M,K,N", IMC_DUAL_CASES)
@pytest.mark.parametrize("abits", [4, 8])
def test_imc_dual_dot_cuda_bit_exact(cuda, M, K, N, abits):
    g = torch.Generator(device=cuda).manual_seed(M * abits + K + N)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    buf, hs = imc_weights(g, cuda, "dual", K, N)
    ls = torch.rand((1, N), generator=g, device=cuda)
    got, xq, xs = imc_dual_dot_levels(x, buf, hs, ls, abits=abits)
    want = imc_dual_dot_plain(x, buf, hs, ls, abits=abits)
    qw, sw = quantize_activations(x, abits)
    assert torch.equal(xq, qw) and torch.equal(xs, sw)
    for a, b in zip(got, want):
        assert torch.equal(a, b), rel_err(a, b)


def imc_edge_rows(g, cuda, M, K):
    """Random rows of many scales, with row 0 all zeros (amax 0, so xs =
    1e-8 / qmax), row 1 on multiples of 0.5 and row 2 ones with one 2.0
    (x / xs lands on .5 ties), as `test_imc_quantize_cuda_bit_exact`."""
    x = torch.randn((M, K), generator=g, device=cuda) \
        * torch.rand((M, 1), generator=g, device=cuda) * 20
    x[0] = 0.0
    if M > 1:
        x[1] = torch.round(x[1] * 2) / 2
    if M > 2:
        x[2] = 1.0
        x[2, 5] = 2.0
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("fmt", ["ternary", "int4", "int8", "dual"])
@pytest.mark.parametrize("abits", [1, 4, 8])
@pytest.mark.parametrize("M", [1, 3, 16, 17])
def test_imc_zero_rows_and_ties_bit_exact(cuda, fmt, abits, M):
    """Zero rows and .5 ties through both routes: the same levels and
    scales as `quantize_activations`, the plain version's bits."""
    K, N = 1024, 512
    g = torch.Generator(device=cuda).manual_seed(abits * 100 + M)
    x = imc_edge_rows(g, cuda, M, K)
    w, scale = imc_weights(g, cuda, fmt, K, N)
    if fmt == "dual":
        ls = torch.rand((1, N), generator=g, device=cuda)
        got, xq, xs = imc_dual_dot_levels(x, w, scale, ls, abits=abits)
        want = imc_dual_dot_plain(x, w, scale, ls, abits=abits)
    else:
        y, xq, xs = imc_dot_levels(x, w, scale, fmt=fmt, abits=abits)
        got = (y,)
        want = (imc_dot_plain(x, w, scale, fmt=fmt, abits=abits),)
    qw, sw = quantize_activations(x, abits)
    assert torch.equal(xq, qw) and torch.equal(xs, sw)
    assert float(xs[0]) == float(torch.tensor(1e-8) / qmax_for(abits))
    for a, b in zip(got, want):
        assert torch.equal(a, b), rel_err(a, b)


@pytest.mark.parametrize("fmt", ["ternary", "int4", "int8", "dual"])
def test_imc_rows_do_not_depend_on_m(cuda, fmt):
    """A row's outputs have the same bits at every M from 1 to 16 (the
    decode route, whose K split and CTAs do not read M) and at M = 17 and
    40 (the prepass and tiles): int32 sums are exact in any order."""
    K, N = 2816 if fmt != "dual" else 2048, 512
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((40, K), generator=g, device=cuda).to(torch.bfloat16)
    w, scale = imc_weights(g, cuda, fmt, K, N)

    def call(rows):
        if fmt == "dual":
            return imc_dual_dot_cuda(rows, w, scale, scale, abits=8)
        return (imc_dot_cuda(rows, w, scale, fmt=fmt, abits=8),)

    full = call(x)
    for M in list(range(1, 18)) + [40]:
        for a, b in zip(call(x[:M]), full):
            assert torch.equal(a, b[:M]), (fmt, M)


def test_imc_decode_is_one_launch(cuda):
    """At M <= 16 a call puts exactly one kernel on the device; above it
    two (the quantize prepass, then the tiles)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(3)
    K, N = 1024, 2816
    w, scale = imc_weights(g, cuda, "ternary", K, N)
    buf, hs = imc_weights(g, cuda, "dual", 2048, 512)
    for M, want in ((1, 1), (4, 1), (16, 1), (17, 2)):
        x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
        xd = torch.randn((M, 2048), generator=g, device=cuda
                         ).to(torch.bfloat16)
        imc_dot_cuda(x, w, scale, fmt="ternary", abits=8)
        imc_dual_dot_cuda(xd, buf, hs, hs, abits=4)
        torch.cuda.synchronize()
        for fn in (lambda: imc_dot_cuda(x, w, scale, fmt="ternary", abits=8),
                   lambda: imc_dual_dot_cuda(xd, buf, hs, hs, abits=4)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            assert len(kernels) == want, (M, kernels)
            assert all("imc_" in k for k in kernels), kernels


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-2b"])
def test_imc_model_steps_vs_cpu_twin(cuda, arch):
    """The reduced model at matmul_impl="imc" (abits 8): the first
    prefill chunk and decode step on the card against the same steps on
    CPU copies of the params and pool (every op takes its plain version
    there). At 4-bit activations one bf16 ulp of difference in a row's
    amax moves whole quantization levels, so logits are compared at 8."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import augment
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.serve.cache_pool import PagedKVPool
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode="int4", matmul_impl="imc", imc_abits=8))
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    params = augment.augment_params(cfg, init_params(dense, seed=2,
                                                     device=cuda))

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.cpu()

    params_c = to_cpu(params)
    B, C = 2, 16
    pool = PagedKVPool(cfg, max_batch=B, max_seq=64, device=cuda)
    for r in range(B):
        pool.admit_row(r, C + 1, step=0)
    arenas_c = to_cpu(pool.arenas)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {**pool.device_tables(),
             "tokens": torch.randint(0, cfg.vocab, (B, C), generator=g,
                                     device=cuda, dtype=torch.int32),
             "positions": torch.zeros(B, dtype=torch.int32, device=cuda),
             "write_mask": torch.ones(B, dtype=torch.bool, device=cuda)}
    V = cfg.vocab
    ops.reset_launch_counts()
    with torch.no_grad():
        for step in (M.paged_prefill_step, M.paged_decode_step):
            lk, _ = step(cfg, params, pool.arenas, batch)
            lc, _ = step(cfg, params_c, arenas_c, to_cpu(batch))
            assert rel_err(lk[..., :V].cpu(), lc[..., :V]) < 0.05
            batch.update(
                tokens=lc[:, -1, :V].argmax(-1).to(torch.int32)[:, None]
                .to(cuda),
                positions=torch.full((B,), C, dtype=torch.int32,
                                     device=cuda))
    counts = ops.launch_counts()
    name = "imc_dual_dot" if arch == "granite-3-2b" else "imc_dot"
    assert counts[name] > 0 and counts["ternary_matmul"] == 0 \
        and counts["dual_plane_matmul"] == 0, counts


def packed_cache(g, cuda, B, KV, S, D, kv_bits):
    """Random packed K/V levels and per-token scales of a contiguous
    head-major cache."""
    ds = D // 2 if kv_bits == 4 else D
    if kv_bits == 4:
        k, v = (torch.randint(0, 256, (B, KV, S, ds), generator=g,
                              device=cuda, dtype=torch.uint8)
                for _ in range(2))
        smax = 1.0 / 7
    else:
        k, v = (torch.randint(-127, 128, (B, KV, S, ds), generator=g,
                              device=cuda, dtype=torch.int8)
                for _ in range(2))
        smax = 1.0 / 127
    ks, vs = ((torch.rand((B, KV, S), generator=g, device=cuda) * 2 * smax
               ).to(torch.bfloat16) for _ in range(2))
    return k, v, ks, vs


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("B,KV,Hg,D,S,bs,lengths", [
    (4, 1, 16, 256, 2048, 512, (1, 57, 2048, 3000)),   # recurrentgemma-9b
    (3, 4, 4, 64, 512, 128, (12, 300, 512)),           # GQA
    (2, 1, 4, 32, 16, 16, (5, 40)),                    # the reduced ring
])
def test_packed_kv_attention_cuda_vs_plain(cuda, kv_bits, B, KV, Hg, D, S,
                                           bs, lengths):
    """Kernel 6 against its plain version, lengths past S included (a
    ring's positions run past its capacity), and its visit counts."""
    g = torch.Generator(device=cuda).manual_seed(B * S + kv_bits)
    q = torch.randn((B, KV, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v, ks, vs = packed_cache(g, cuda, B, KV, S, D, kv_bits)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got, visits = packed_kv_attention_cuda(q, k, v, ks, vs, lens, bs=bs,
                                           kv_bits=kv_bits,
                                           debug_visits=True)
    want = packed_kv_attention_plain(q, k, v, ks, vs, lens, kv_bits=kv_bits)
    assert rel_err(got, want) < 0.03
    expect = [max(-(-min(n, S) // bs), 1) for n in lengths]
    assert visits.tolist() == [[e] * KV for e in expect]


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_packed_kv_attention_cuda_main_path_lengths(cuda, kv_bits):
    """recurrentgemma-9b's ring read at the main path's lengths (rings of
    <= 56 tokens: one 64-token chunk a row)."""
    g = torch.Generator(device=cuda).manual_seed(56 + kv_bits)
    B, KV, Hg, D, S, bs = 4, 1, 16, 256, 2048, 512
    q = torch.randn((B, KV, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v, ks, vs = packed_cache(g, cuda, B, KV, S, D, kv_bits)
    lens = torch.tensor([13, 27, 41, 56], dtype=torch.int32, device=cuda)
    got, visits = packed_kv_attention_cuda(q, k, v, ks, vs, lens, bs=bs,
                                           kv_bits=kv_bits,
                                           debug_visits=True)
    want = packed_kv_attention_plain(q, k, v, ks, vs, lens, kv_bits=kv_bits)
    assert rel_err(got, want) < 0.03
    assert visits.tolist() == [[1]] * B


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_packed_kv_attention_cuda_chunk_edges(cuda, kv_bits):
    """Lengths on the 64-token split chunk's edges, on a bs-block's edge,
    past S, and 0 (the mean V of the first bs-block, as the TPU kernel
    gives), with the visit counts taken on the device."""
    from repro_torch.models.layers import unpack_int4_pairs
    g = torch.Generator(device=cuda).manual_seed(64 + kv_bits)
    B, KV, Hg, D, S, bs = 8, 2, 16, 128, 1024, 256
    lengths = (0, 63, 64, 65, 255, 257, 1024, 5000)
    q = torch.randn((B, KV, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v, ks, vs = packed_cache(g, cuda, B, KV, S, D, kv_bits)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got, visits = packed_kv_attention_cuda(q, k, v, ks, vs, lens, bs=bs,
                                           kv_bits=kv_bits,
                                           debug_visits=True)
    want = packed_kv_attention_plain(q, k, v, ks, vs, lens, kv_bits=kv_bits)
    assert rel_err(got[1:], want[1:]) < 0.03
    v_int = (unpack_int4_pairs(v) if kv_bits == 4 else v).float()
    first = (vs[0, :, :bs].float()[..., None] * v_int[0, :, :bs]).mean(1)
    assert rel_err(got[0], first[:, None].expand(KV, Hg, D)) < 0.03
    expect = [max(-(-min(n, S) // bs), 1) for n in lengths]
    assert visits.tolist() == [[e] * KV for e in expect]


def test_packed_kv_attention_cuda_ignores_tokens_past_length(cuda):
    """Scrambling the cache past a row's length changes nothing, and a row
    of length 0 still writes finite output (the mean V of its first
    block, as the TPU kernel gives)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, KV, Hg, D, S = 2, 2, 2, 64, 256
    q = torch.randn((B, KV, Hg, D), generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v, ks, vs = packed_cache(g, cuda, B, KV, S, D, 4)
    lens = torch.tensor([100, 0], dtype=torch.int32, device=cuda)
    o1 = packed_kv_attention_cuda(q, k, v, ks, vs, lens, bs=64)
    k2, v2 = k.clone(), v.clone()
    k2[0, :, 100:] = 255
    v2[0, :, 100:] = 255
    o2 = packed_kv_attention_cuda(q, k2, v2, ks, vs, lens, bs=64)
    assert torch.equal(o1[0], o2[0])
    assert torch.isfinite(o1[1].float()).all()


@pytest.mark.parametrize("n,d", [(64, 64), (4 * 16, 256), (2048, 64),
                                 (37, 32)])
def test_integrity_pack_cuda_bit_exact(cuda, n, d):
    """Kernel 3c: packed bytes and scales bit-identical to the plain pack
    (and to kernel 3), words equal to their plain version."""
    g = torch.Generator(device=cuda).manual_seed(n + d)
    x = torch.randn((n, d), generator=g, device=cuda) \
        * torch.rand((n, 1), generator=g, device=cuda) * 30
    x[: n // 4] = torch.round(x[: n // 4] * 2) / 2      # exact half steps
    x[0] = 0.0                                          # amax == 0
    x = x.to(torch.bfloat16)
    p, s, w = quantize_pack_kv_integrity_cuda(x)
    pw, sw = quantize_pack_kv_plain(x)
    pk, sk = quantize_pack_kv_cuda(x)
    assert torch.equal(p, pw) and torch.equal(s, sw)
    assert torch.equal(p, pk) and torch.equal(s, sk)
    assert torch.equal(w, integrity_words_plain(pw))


# ---------------------------------------------------------------------------
# the fused paged KV write (kernels 3 / 3b with the scatter taken in)
# ---------------------------------------------------------------------------

WRITE_POLICIES = ("always-augmented", "normal-only", "augment-on-pressure")
ARENA_NAMES = ("kn", "vn", "kp", "vp", "ks", "vs")


def write_case(g, cuda, *, policy, bits, B, T, KV, D, commit, page=16,
               maxP=8):
    """One layer's arena views sized as the pool sizes them for `policy`
    (random contents; mixed page modes under augment-on-pressure), a
    table of distinct pages, and rows: row 1 write-masked, row 2 past the
    table (write-masked), row 3's last token write-masked; int64
    positions for T > 1 (the engine's windows and chunks)."""
    Nn = 1 + (0 if policy == "always-augmented" else B * maxP)
    Np = 1 + (0 if policy == "normal-only" else B * maxP)
    d_store = D // 2 if bits == 4 else D
    lo, hi, dt = (0, 256, torch.uint8) if bits == 4 \
        else (-127, 128, torch.int8)
    ar = {n: torch.randn((Nn, KV, page, D), generator=g, device=cuda
                         ).to(torch.bfloat16) for n in ("kn", "vn")}
    for n in ("kp", "vp"):
        ar[n] = torch.randint(lo, hi, (Np, KV, page, d_store), generator=g,
                              device=cuda, dtype=dt)
    for n in ("ks", "vs"):
        ar[n] = (torch.rand((Np, KV, page), generator=g, device=cuda) * 0.1
                 ).to(torch.bfloat16)
    if policy == "augment-on-pressure":
        modes = torch.randint(0, 2, (B, maxP), generator=g, device=cuda,
                              dtype=torch.int32)
        modes[0, :2] = torch.tensor([0, 1], device=cuda)
    else:
        modes = torch.full((B, maxP), int(policy == "always-augmented"),
                           dtype=torch.int32, device=cuda)
    perm_n = torch.randperm(max(Nn - 1, B * maxP), generator=g,
                            device=cuda)[:B * maxP] + 1
    perm_p = torch.randperm(max(Np - 1, B * maxP), generator=g,
                            device=cuda)[:B * maxP] + 1
    table = torch.where(modes == 1, perm_p.view(B, maxP),
                        perm_n.view(B, maxP)).to(torch.int32)
    rows = []
    for _ in range(2):
        x = torch.randn((B, T, KV, D), generator=g, device=cuda) \
            * torch.rand((B, T, KV, 1), generator=g, device=cuda) * 8
        x[:, :, 0] = torch.round(x[:, :, 0] * 2) / 2       # exact half steps
        x[0, 0, 1] = 0.0                                    # amax == 0
        rows.append(x.to(torch.bfloat16))
    starts = torch.randint(0, maxP * page - T + 1, (B,), generator=g,
                           device=cuda)
    starts[2] = maxP * page + 3
    pos = starts[:, None] + torch.arange(T, device=cuda)[None, :]
    pos = pos.to(torch.int32) if T == 1 else pos
    write = torch.ones((B, T), dtype=torch.bool, device=cuda)
    write[1] = False
    write[2] = False
    write[3, -1] = False
    keep = None
    if commit == "all":
        keep = torch.ones((B, T), dtype=torch.bool, device=cuda)
    elif commit == "mixed":
        acc = torch.randint(1, T + 1, (B,), generator=g, device=cuda)
        acc[0] = min(2, T)
        keep = torch.arange(T, device=cuda)[None, :] < acc[:, None]
    return ar, (rows[0], rows[1], pos, write, keep, table, modes)


def run_write(fn, ar, rows, *, policy, bits, page=16) -> dict:
    out = {n: t.clone() for n, t in ar.items()}
    fn(*(out[n] for n in ARENA_NAMES), *rows, page_size=page,
       policy=policy, aug_bits=bits)
    return out


def raw(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("policy", WRITE_POLICIES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T,commit", [(1, "none"), (32, "none"), (4, "none"),
                                      (4, "all"), (4, "mixed")])
@pytest.mark.parametrize("KV,D", [(16, 64), (8, 128), (4, 256), (4, 40)])
def test_paged_kv_write_cuda_vs_plain(cuda, policy, bits, T, commit, KV, D):
    """Every arena page >= 1 bit-identical to `paged_kv_write_plain` (hd
    64 / 128 / 256 on the vector path, 40 on the scalar one); a token the
    commit mask rejects leaves zero bytes and a scale of exactly 1.0, or a
    zero bf16 row, at its slot."""
    g = torch.Generator(device=cuda).manual_seed(T + D + bits)
    ar, rows = write_case(g, cuda, policy=policy, bits=bits, B=4, T=T,
                          KV=KV, D=D, commit=commit)
    got = run_write(paged_kv_write_cuda, ar, rows, policy=policy, bits=bits)
    want = run_write(paged_kv_write_plain, ar, rows, policy=policy,
                     bits=bits)
    torch.cuda.synchronize()
    for n in ARENA_NAMES:
        bad = (raw(got[n][1:]) != raw(want[n][1:])).nonzero()
        assert bad.numel() == 0, (n, bad[:4].tolist())
    k, v, pos, write, keep, table, modes = rows
    if keep is None:
        return
    rejected = (write & ~keep).nonzero().tolist()
    for b, t in rejected:
        lp, slot = divmod(int(pos[b, t]), 16)
        phys, mode = int(table[b, lp]), int(modes[b, lp])
        if mode == 1 and policy != "normal-only":
            for n, s in (("kp", "ks"), ("vp", "vs")):
                assert not got[n][phys, :, slot].any()
                assert bool((got[s][phys, :, slot] == 1.0).all())
        elif mode == 0 and policy != "always-augmented":
            for n in ("kn", "vn"):
                assert not raw(got[n][phys, :, slot]).any()
    assert commit == "all" or rejected


@pytest.mark.parametrize("bits", [4, 8])
def test_paged_kv_write_strided_rows(cuda, bits):
    """k_new as a head-strided view (read by stride, not copied) and v_new
    with strided elements (copied): the plain version's bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    policy = "augment-on-pressure"
    ar, rows = write_case(g, cuda, policy=policy, bits=bits, B=4, T=4,
                          KV=8, D=64, commit="mixed")
    k = rows[0].transpose(1, 2).contiguous().transpose(1, 2)
    v = torch.stack([rows[1], rows[1]], dim=-1)[..., 0]
    assert not k.is_contiguous() and v.stride(-1) == 2
    got = run_write(paged_kv_write_cuda, ar, (k, v) + rows[2:],
                    policy=policy, bits=bits)
    want = run_write(paged_kv_write_plain, ar, rows, policy=policy,
                     bits=bits)
    for n in ARENA_NAMES:
        assert torch.equal(raw(got[n][1:]), raw(want[n][1:])), n


def test_paged_kv_write_is_one_launch(cuda):
    """One call puts exactly one kernel on the device, whatever the
    policy, the width or the commit mask."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(6)
    for policy in WRITE_POLICIES:
        for bits in (4, 8):
            for T, commit in ((1, "none"), (4, "mixed"), (32, "none")):
                ar, rows = write_case(g, cuda, policy=policy, bits=bits,
                                      B=4, T=T, KV=16, D=64, commit=commit)
                run_write(paged_kv_write_cuda, ar, rows, policy=policy,
                          bits=bits)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    paged_kv_write_cuda(
                        *(ar[n] for n in ARENA_NAMES), *rows, page_size=16,
                        policy=policy, aug_bits=bits)
                    torch.cuda.synchronize()
                kernels = [e.name for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA]
                assert len(kernels) == 1, (policy, bits, T, kernels)
                assert "paged_write" in kernels[0], kernels


@pytest.mark.parametrize("d", [34, 40, 48, 96, 512, 1024, 1040])
def test_pack_entries_bit_exact_on_every_route(cuda, d):
    """The three standalone entries on the shared row routine: the vector
    path (d % 16 == 0: 1 to 4 vectors a lane), the scalar path (other
    even d, past d = 1024, and rows not 16-byte aligned) give the plain
    versions' bytes, scales and integrity words."""
    g = torch.Generator(device=cuda).manual_seed(d)
    n = 67
    x = torch.randn((n, d), generator=g, device=cuda) * 6
    x[: n // 4] = torch.round(x[: n // 4] * 2) / 2      # exact half steps
    x[0] = 0.0                                          # amax == 0
    x = x.to(torch.bfloat16)
    buf = torch.empty(n * d + 1, dtype=torch.bfloat16, device=cuda)
    buf[1:] = x.reshape(-1)
    unaligned = buf[1:].view(n, d)                      # rows 2 bytes off
    assert unaligned.data_ptr() % 16 != 0
    valid = torch.rand((n,), generator=g, device=cuda) < 0.5
    valid[0] = True
    for rows in (x, unaligned):
        for got, want in (
                (quantize_pack_kv_cuda(rows), quantize_pack_kv_plain(rows)),
                (quantize_pack_kv_masked_cuda(rows, valid),
                 quantize_pack_kv_plain(rows, valid)),
                (quantize_pack_kv_integrity_cuda(rows),
                 quantize_pack_kv_integrity_plain(rows))):
            for a, b in zip(got, want):
                assert torch.equal(a, b), (d, rows.data_ptr() % 16)


def test_hybrid_engine_on_card_matches_cpu(cuda):
    """The reduced hybrid engine (int4 ring KV, window 16) on the card
    through kernel 6 against the same engine on the CPU, with prompts
    longer than the window so the ring wraps and lengths pass S; the
    first steps' logits within 0.05, and the tokens."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import Request, ServeEngine
    cfg = get_arch("recurrentgemma-9b").reduced()
    params = init_params(cfg, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (21, 30, 17)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, device=dev, params=params, max_batch=2,
                          max_seq=64)
        ops.reset_launch_counts()
        outs[dev] = eng.generate([Request(prompt=p, max_new_tokens=8, id=i)
                                  for i, p in enumerate(prompts)])
        if dev == "cuda":
            assert ops.launch_counts()["packed_kv_attention"] \
                == eng.dispatch_count
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# a row's bits independent of M: kernel 1, the port's bf16 GEMM, the norm
# ---------------------------------------------------------------------------

def _packed_trits(g, cuda, K, N):
    d = torch.randint(0, 3, (K // 4, N, 4), generator=g, device=cuda,
                      dtype=torch.uint8)
    return d[..., 0] | (d[..., 1] << 2) | (d[..., 2] << 4) | (d[..., 3] << 6)


def _gemm_case(g, cuda, kind, K, N):
    """(fn, plain) of one fixed-order GEMM over random weights: ternary
    (K/4, N) trits and scales, bf16 (K, N), or the head's bf16 (N, K)."""
    if kind == "ternary":
        w = _packed_trits(g, cuda, K, N)
        scale = torch.rand((1, N), generator=g, device=cuda) * 0.1
        return (lambda x: ternary_matmul_cuda(x, w, scale),
                lambda x: ternary_matmul_plain(x, w, scale))
    shape = (K, N) if kind == "kn" else (N, K)
    w = (torch.randn(shape, generator=g, device=cuda) / K ** 0.5
         ).to(torch.bfloat16)
    return (lambda x: dense_matmul_cuda(x, w, kind),
            lambda x: dense_matmul_plain(x, w, kind))


# qwen's and granite's shapes, the heads (V_pad, d) and a ragged small one
GEMM_SHAPES = [("ternary", 1024, 2816), ("ternary", 2816, 1024),
               ("ternary", 1024, 1024), ("ternary", 128, 64),
               ("kn", 2048, 2048), ("kn", 8192, 2048), ("kn", 128, 128),
               ("nk", 2048, 49408), ("nk", 1024, 151936), ("nk", 128, 512)]


@pytest.mark.parametrize("kind,K,N", GEMM_SHAPES)
def test_fixed_order_gemm_rows_do_not_depend_on_m(cuda, kind, K, N):
    """Every row of an M-row call equals the same row of one M=160 call
    bit for bit, at M = 1, 4, 5, 8, 9, 16, 17, 128, 129 (the row tiles'
    edges), and a row's bits do not depend on its position either: the
    rows of a shuffled call are the shuffled rows."""
    g = torch.Generator(device=cuda).manual_seed(K + N)
    fn, _ = _gemm_case(g, cuda, kind, K, N)
    x = torch.randn((160, K), generator=g, device=cuda).to(torch.bfloat16)
    full = fn(x)
    for m in (1, 4, 5, 8, 9, 16, 17, 128, 129):
        assert torch.equal(fn(x[:m].contiguous()), full[:m]), m
    perm = torch.randperm(160, generator=g, device=cuda)
    assert torch.equal(fn(x[perm].contiguous()), full[perm])


@pytest.mark.parametrize("kind,K,N", [c for c in GEMM_SHAPES
                                      if c[0] != "ternary"])
@pytest.mark.parametrize("M", [4, 16, 128])
def test_dense_matmul_cuda_vs_plain(cuda, kind, K, N, M):
    """The bf16 GEMM (both layouts, the heads' included) within 2^-7 of
    torch.matmul: both sum in f32 and round once to bf16 (kernel 1 is
    held to its plain version by test_ternary_matmul_cuda_vs_plain)."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    fn, plain = _gemm_case(g, cuda, kind, K, N)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    assert rel_err(fn(x), plain(x)) < 2 ** -7


@pytest.mark.parametrize("d", [128, 1024, 2048, 4096])
def test_rms_norm_rows_do_not_depend_on_m(cuda, d):
    """The eager RMS norm (torch's CUDA mean) gives a row the same bits at
    1, 4, 16 and 128 rows as in one 160-row call, at every width the
    models use: the verify window's norms rely on it, as on the GEMMs'
    fixed order."""
    from repro_torch.models.layers import rms_norm
    g = torch.Generator(device=cuda).manual_seed(d)
    x = (torch.randn((160, d), generator=g, device=cuda) * 3
         ).to(torch.bfloat16)
    w = (torch.randn((d,), generator=g, device=cuda) * 0.1
         ).to(torch.bfloat16)
    full = rms_norm(x, w)
    for m in (1, 4, 16, 128):
        assert torch.equal(rms_norm(x[:m], w), full[:m]), m
    assert torch.equal(rms_norm(x.view(10, 16, d), w), full.view(10, 16, d))


def _reduced_depth(arch: str, n_layers: int):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), n_layers=n_layers)


def _augmented_params(cuda, cfg, seed: int):
    from repro_torch.models import augment
    from repro_torch.models.params import init_params
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    return augment.augment_params(cfg, init_params(dense, seed=seed,
                                                   device=cuda))


class SubOps:
    """While active, records the output of every sub-op of a step (each
    norm's input and output, every projection, the attention read, the
    head) as (name, (B, S, features)), S the step's tokens a row."""

    OPS = ("dense_matmul", "ternary_matmul", "dual_plane_matmul",
           "paged_kv_attention", "paged_kv_attention_window")

    def __init__(self, B: int):
        self.B, self.log = B, []

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import layers
        self.saved = [(ops, n, getattr(ops, n)) for n in self.OPS]
        self.saved.append((layers, "rms_norm", layers.rms_norm))
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _rows(self, t):
        return t.reshape(self.B, -1, t.shape[-1])

    def _wrap(self, name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name == "rms_norm":
                self.log.append(("residual", self._rows(args[0])))
            if name == "paged_kv_attention":           # (B, KV, Hg, D)
                rec = [("attention", out.reshape(self.B, 1, -1))]
            elif name == "paged_kv_attention_window":  # (B, KV, W, Hg, D)
                rec = [("attention", out.transpose(1, 2).reshape(
                    self.B, out.shape[2], -1))]
            else:
                rec = [(name, self._rows(o)) for o in
                       (out if isinstance(out, tuple) else (out,))]
            self.log.extend(rec)
            return out
        return call


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen1.5-0.5b"])
def test_verify_window_bits_equal_decode_steps(cuda, arch):
    """Full width, 2 layers: one verify window of 4 tokens a row (16 rows
    through every projection) against the 4 decode steps (4 rows each)
    that emit those tokens, from the same pool after a 16-token prefill.
    Every sub-op's output (norm inputs and outputs, q/k/v, attention, wo,
    gate/up, w_down, the head) is compared slot by slot, bit for bit, so
    a failure names the first op whose bits depend on M."""
    from repro_torch.models import model as M
    from repro_torch.serve.cache_pool import PagedKVPool
    cfg = _reduced_depth(arch, 2)
    params = _augmented_params(cuda, cfg, seed=11)
    B, C, W, V = 4, 16, 4, cfg.vocab
    pool = PagedKVPool(cfg, max_batch=B, max_seq=64, device=cuda)
    for r in range(B):
        pool.admit_row(r, C + W + 1, step=0)
    tables = pool.device_tables()
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.no_grad():
        lp, _ = M.paged_prefill_step(cfg, params, pool.arenas, {
            **tables, "tokens": torch.randint(0, V, (B, C), generator=g,
                                              device=cuda, dtype=torch.int32),
            "positions": torch.zeros(B, dtype=torch.int32, device=cuda),
            "write_mask": torch.ones(B, dtype=torch.bool, device=cuda)})
        arenas_v = {k: v.clone() for k, v in pool.arenas.items()}
        tok = lp[:, -1, :V].argmax(-1).to(torch.int32)
        steps, window = [], [tok]
        for w in range(W):
            with SubOps(B) as rec:
                ld, _ = M.paged_decode_step(cfg, params, pool.arenas, {
                    **tables, "tokens": window[-1][:, None],
                    "positions": torch.full((B,), C + w, dtype=torch.int32,
                                            device=cuda),
                    "write_mask": torch.ones(B, dtype=torch.bool,
                                             device=cuda)})
            steps.append(rec.log)
            window.append(ld[:, -1, :V].argmax(-1).to(torch.int32))
        with SubOps(B) as rec:
            M.paged_verify_step(cfg, params, arenas_v, {
                **tables, "tokens": torch.stack(window[:W], dim=1),
                "positions": torch.full((B,), C, dtype=torch.int32,
                                        device=cuda),
                "write_mask": torch.ones((B, W), dtype=torch.bool,
                                         device=cuda)})
    verify = rec.log
    for w, step in enumerate(steps):
        assert [n for n, _ in step] == [n for n, _ in verify]
        for i, ((name, a), (_, b)) in enumerate(zip(step, verify)):
            assert torch.equal(a[:, 0], b[:, w]), (
                f"slot {w}: sub-op {i} ({name}) differs between the decode "
                f"step and the verify window")


@pytest.mark.parametrize("arch,drafts", [
    ("granite-3-2b", ("dequant", "imc4", "imc1")),
    ("qwen1.5-0.5b", ("dequant",))])
def test_spec_tokens_equal_stepwise_on_card(cuda, arch, drafts):
    """Full width, 4 layers, 8 requests: speculative decode (spec_k=4)
    emits exactly the stepwise (spec_k=1) tokens on every request, with
    each draft."""
    import numpy as np
    from repro_torch.serve import Request, ServeEngine
    cfg = _reduced_depth(arch, 4)
    params = _augmented_params(cuda, cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(20, 61, size=8)]

    def serve(**kw):
        eng = ServeEngine(cfg, device=cuda, max_batch=4, max_seq=128,
                          prefill_chunk=32, params=params, **kw)
        return eng.generate([Request(prompt=p, max_new_tokens=16, id=i)
                             for i, p in enumerate(prompts)])

    stepwise = serve(spec_k=1)
    for draft in drafts:
        spec = serve(spec_k=4, spec_draft_impl=draft)
        same = [spec[i] == stepwise[i] for i in range(8)]
        assert all(same), (draft, same)
