"""The port's kernels: each plain PyTorch version against its
`repro.kernels.ref` oracle on the same numpy inputs (CPU), and the device
dispatch of `kernels.ops`. The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_gpu.py.

Tolerances: packed bytes and scales exact; rel_err (max abs error over
max |oracle|, `repro.kernels.ref.rel_err`) < 0.02 for the matmul and
< 0.03 for attention, as tests/test_kernels.py holds the Pallas kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.dual_plane_matmul import (dual_plane_matmul_cuda,
                                                   dual_plane_matmul_plain,
                                                   k_split)
from repro_torch.kernels.imc_dot import (imc_dot_cuda, imc_dual_dot_cuda,
                                         quantize_activations_cuda)
from repro_torch.kernels.packed_kv_attention import (
    CHUNK, SHARED_LIMIT, packed_kv_attention_cuda, packed_kv_attention_plain,
    scratch_bytes, shared_bytes)
from repro_torch.kernels import paged_kv_attention as pka
from repro_torch.kernels.paged_kv_attention import (
    paged_kv_attention_cuda, paged_kv_attention_plain, window_plan)
from repro_torch.kernels.quantize_pack_kv import (
    integrity_words_plain, quantize_pack_kv_cuda,
    quantize_pack_kv_integrity_cuda, quantize_pack_kv_integrity_plain,
    quantize_pack_kv_plain)
from repro_torch.kernels import ternary_matmul as tmm
from repro_torch.kernels.ternary_matmul import (dense_matmul_plain,
                                                split_plan,
                                                ternary_matmul_cuda,
                                                ternary_matmul_plain)
from repro_torch.models.params import from_numpy_tree
from torch_paged_mirror import paged_split_merge_mirror

CPU = torch.device("cpu")


def tt(a, device=CPU) -> torch.Tensor:
    return from_numpy_tree(np.asarray(a), device)


def bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def packed_trits(rng, k, n) -> np.ndarray:
    d = rng.integers(0, 3, size=(k // 4, n, 4)).astype(np.uint8)
    return d[..., 0] | (d[..., 1] << 2) | (d[..., 2] << 4) | (d[..., 3] << 6)


def ternary_case(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = bf16(rng.standard_normal((M, K)))
    w = packed_trits(rng, K, N)
    scale = rng.uniform(0.01, 0.1, size=(1, N)).astype(np.float32)
    return x, w, scale


def kv_rows(seed, n, d) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * rng.uniform(0.01, 30, (n, 1))
    x[0] = 0.0                                  # amax == 0
    x[1:n // 4] = np.round(x[1:n // 4] * 2) / 2  # exact half steps
    return bf16(x)


def paged_case(seed, *, B, KV, Hg, D, page, maxP, kv_bits, modes_kind,
               lengths):
    """A random two-plane pool with disjoint physical pages per row."""
    rng = np.random.default_rng(seed)
    Nn = Np = B * maxP + 1
    d_store = D // 2 if kv_bits == 4 else D
    kn = bf16(rng.standard_normal((Nn, KV, page, D)))
    vn = bf16(rng.standard_normal((Nn, KV, page, D)))
    if kv_bits == 4:
        kp = rng.integers(0, 256, (Np, KV, page, d_store)).astype(np.uint8)
        vp = rng.integers(0, 256, (Np, KV, page, d_store)).astype(np.uint8)
        smax = 1 / 7
    else:
        kp = rng.integers(-127, 128, (Np, KV, page, d_store)).astype(np.int8)
        vp = rng.integers(-127, 128, (Np, KV, page, d_store)).astype(np.int8)
        smax = 1 / 127
    ks = bf16(rng.uniform(0.2, 2.0, (Np, KV, page)) * smax)
    vs = bf16(rng.uniform(0.2, 2.0, (Np, KV, page)) * smax)
    modes = {"normal": np.zeros((B, maxP)), "aug": np.ones((B, maxP)),
             "mixed": rng.integers(0, 2, (B, maxP))}[modes_kind]
    modes = modes.astype(np.int32)
    perm_n = rng.permutation(np.arange(1, Nn))[:B * maxP].reshape(B, maxP)
    perm_p = rng.permutation(np.arange(1, Np))[:B * maxP].reshape(B, maxP)
    table = np.where(modes == 1, perm_p, perm_n).astype(np.int32)
    q = bf16(rng.standard_normal((B, KV, Hg, D)))
    return (q, kn, vn, kp, vp, ks, vs, np.asarray(lengths, np.int32), table,
            modes)


# ---------------------------------------------------------------------------
# plain versions vs the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(1, 128, 64), (4, 256, 128),
                                   (64, 128, 256), (37, 512, 64)])
def test_ternary_matmul_plain_vs_ref(M, K, N):
    x, w, scale = ternary_case(M + K + N, M, K, N)
    want = ref.ternary_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(scale))
    got = ternary_matmul_plain(tt(x), tt(w), tt(scale))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    assert ref.rel_err(got.float().numpy(), want) < 0.02


@pytest.mark.parametrize("n,d", [(1, 32), (37, 32), (256, 64), (96, 128)])
def test_quantize_pack_kv_plain_bit_exact(n, d):
    """Bytes and scales equal the eager oracle AND the jitted JAX wrapper
    (the form the JAX engine runs), with all-zero rows and exact ties."""
    x = kv_rows(n * d, n, d)
    p, s = quantize_pack_kv_plain(tt(x))
    jp, js = ref.quantize_pack_kv_ref(jnp.asarray(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jp2, js2 = jops.quantize_pack_kv(jnp.asarray(x), use_ref=True)
    p2, s2 = ops.quantize_pack_kv(tt(x))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(jp2))
    np.testing.assert_array_equal(
        s2.float().numpy(), np.asarray(js2.astype(jnp.float32)))


# one compile per geometry instead of one per eager op and shape
PAGED_REF = jax.jit(ref.paged_kv_attention_ref, static_argnames="kv_bits")

GEOMS = [  # (B, KV, Hg, D, page, maxP, lengths)
    (3, 2, 1, 32, 8, 4, [1, 32, 13]),          # 1 and maxP*page
    (2, 2, 4, 32, 16, 3, [48, 17]),            # GQA Hg=4, page boundary
    (4, 1, 2, 64, 8, 5, [9, 40, 8, 100]),      # 100 > maxP*page: clamped
]


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("modes_kind", ["normal", "aug", "mixed"])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_kv_attention_plain_vs_ref(kv_bits, modes_kind, geom):
    B, KV, Hg, D, page, maxP, lengths = geom
    case = paged_case(kv_bits + len(modes_kind) + B, B=B, KV=KV, Hg=Hg, D=D,
                      page=page, maxP=maxP, kv_bits=kv_bits,
                      modes_kind=modes_kind, lengths=lengths)
    want = PAGED_REF(*map(jnp.asarray, case), kv_bits=kv_bits)
    got = paged_kv_attention_plain(*map(tt, case), kv_bits=kv_bits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, KV, Hg, D)
    assert ref.rel_err(got.float().numpy(), want) < 0.03


def test_paged_gather_matches_ref():
    from repro_torch.kernels.paged_kv_attention import paged_gather_kv
    case = paged_case(5, B=2, KV=2, Hg=1, D=32, page=8, maxP=3, kv_bits=4,
                      modes_kind="mixed", lengths=[5, 24])
    jk, jv = ref.paged_gather_kv_ref(*map(jnp.asarray, case[1:7]),
                                     jnp.asarray(case[8]),
                                     jnp.asarray(case[9]), kv_bits=4)
    k, v = paged_gather_kv(*map(tt, case[1:7]), tt(case[8]), tt(case[9]),
                           kv_bits=4)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def packed_case(seed, *, B, KV, Hg, D, S, kv_bits, lengths):
    """A random contiguous head-major packed cache and queries."""
    rng = np.random.default_rng(seed)
    ds = D // 2 if kv_bits == 4 else D
    if kv_bits == 4:
        k, v = (rng.integers(0, 256, (B, KV, S, ds)).astype(np.uint8)
                for _ in range(2))
        smax = 1 / 7
    else:
        k, v = (rng.integers(-127, 128, (B, KV, S, ds)).astype(np.int8)
                for _ in range(2))
        smax = 1 / 127
    ks, vs = (bf16(rng.uniform(0.2, 2.0, (B, KV, S)) * smax)
              for _ in range(2))
    q = bf16(rng.standard_normal((B, KV, Hg, D)))
    return q, k, v, ks, vs, np.asarray(lengths, np.int32)


PACKED_REF = jax.jit(ref.packed_kv_attention_ref, static_argnames="kv_bits")


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("geom", [
    # (B, KV, Hg, D, S, lengths): 0, < bs (bs = 16), = S and > S
    (4, 1, 4, 32, 64, [0, 7, 64, 100]),
    (3, 2, 2, 64, 32, [1, 32, 45]),
])
def test_packed_kv_attention_plain_vs_ref(kv_bits, geom):
    """Kernel 6's plain version against `packed_kv_attention_ref`: a row
    of length 0 attends uniformly to every slot, lengths past S clamp."""
    B, KV, Hg, D, S, lengths = geom
    case = packed_case(kv_bits + S, B=B, KV=KV, Hg=Hg, D=D, S=S,
                       kv_bits=kv_bits, lengths=lengths)
    want = PACKED_REF(*map(jnp.asarray, case), kv_bits=kv_bits)
    got = packed_kv_attention_plain(*map(tt, case), kv_bits=kv_bits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, KV, Hg, D)
    assert ref.rel_err(got.float().numpy(), want) < 0.03


# ---------------------------------------------------------------------------
# kernel 6's split-sequence design, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _hybrid_attention_shapes():
    """(B, KV, Hg, D, S) of the hybrid configs' ring reads (the engines
    run B = max_batch <= 4 rows)."""
    from repro_torch.configs import get_arch
    out = []
    for cfg in (get_arch("recurrentgemma-9b"),
                get_arch("recurrentgemma-9b").reduced()):
        out.append((4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                    cfg.head_dim, cfg.hybrid.window))
    return out


# the card tests' and chip_smoke's shapes, then the hybrid configs'
PACKED_CARD_SHAPES = [(4, 1, 16, 256, 2048), (3, 4, 4, 64, 512),
                      (2, 1, 4, 32, 16), (2, 2, 2, 64, 256),
                      (4, 4, 4, 64, 1024), (6, 1, 16, 256, 2048)]


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_packed_split_plan_fits_and_covers(kv_bits):
    """The chunk kernel's shared memory fits one CTA at every shape the
    card tests and the hybrid configs use, its chunks tile [0, S) in
    order, and the scratch holds one partial record per chunk."""
    for B, KV, Hg, D, S in PACKED_CARD_SHAPES + _hybrid_attention_shapes():
        assert 1 <= Hg <= 16 and D % 32 == 0 and D <= 256, (Hg, D)
        assert shared_bytes(D, kv_bits) <= SHARED_LIMIT
        # the chunk kernel's grid is (B * KV, cdiv(S, CHUNK))
        chunks = [(c0, min(c0 + CHUNK, S)) for c0 in range(0, S, CHUNK)]
        starts, ends = zip(*chunks)
        assert starts[0] == 0 and ends[-1] == S
        assert list(starts[1:]) == list(ends[:-1])
        assert all(0 < e - s0 <= CHUNK for s0, e in chunks)
        assert scratch_bytes(B, KV, Hg, D, S) == (B * KV * len(chunks)
                                                  * (Hg * D * 4 + Hg * 8 + 8))
    # recurrentgemma-9b: 32 chunks a row where one CTA walked them all
    assert -(-2048 // CHUNK) == 32


def split_merge_mirror(q, k, v, ks, vs, lengths, *, bs, kv_bits,
                       chunk=64):
    """The CUDA kernel's arithmetic in torch: each `chunk` of a row's
    read tokens (its valid ones; for length 0 its first bs-block) gives
    an f32 score (the bf16 x level MMA's f32 sum) times k_scale * D^-1/2,
    -1e30 past the length, its own max m_i, denominator l_i and
    acc_i = bf16(p * v_scale) @ levels; the merge rescales by
    e^(m_i - m) and rounds acc / l to bf16."""
    from repro_torch.models.layers import unpack_int4_pairs
    B, KV, Hg, D = q.shape
    S = k.shape[2]
    k_int = (unpack_int4_pairs(k) if kv_bits == 4 else k).float()
    v_int = (unpack_int4_pairs(v) if kv_bits == 4 else v).float()
    inv_sqrt_d = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    for b in range(B):
        n = max(min(int(lengths[b]), S), 0)
        end = n if n > 0 else bs
        for h in range(KV):
            parts = []
            for c0 in range(0, end, chunk):
                tok = slice(c0, min(end, c0 + chunk))
                n_valid = min(max(n - c0, 0), chunk)
                s = q[b, h].float() @ k_int[b, h, tok].T
                s = s * (ks[b, h, tok].float() * inv_sqrt_d)
                s[:, n_valid:] = -1e30
                m = s.max(dim=-1).values
                p = torch.exp(s - m[:, None])
                pv = (p * vs[b, h, tok].float()).to(torch.bfloat16).float()
                parts.append((m, p.sum(dim=-1), pv @ v_int[b, h, tok]))
            m = torch.stack([mi for mi, _, _ in parts]).max(dim=0).values
            w = [torch.exp(mi - m) for mi, _, _ in parts]
            l = sum(li * wi for (_, li, _), wi in zip(parts, w))
            acc = sum(ai * wi[:, None] for (_, _, ai), wi in zip(parts, w))
            out[b, h] = (acc / l[:, None]).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("geom", [
    # (B, KV, Hg, D, S, bs, lengths): 1, the 64-token chunk's edges, a
    # bs-block's edge, S and past S
    (6, 1, 16, 64, 256, 128, [1, 63, 64, 65, 256, 400]),
    (4, 2, 4, 32, 192, 64, [127, 128, 129, 191]),
])
def test_split_merge_mirror_vs_plain_and_ref(kv_bits, geom):
    """Splitting a row into 64-token chunks, with p * v_scale rounded to
    bf16 against each chunk's own max, and merging them stays within the
    kernel's 0.03 of the plain version and of the JAX oracle."""
    B, KV, Hg, D, S, bs, lengths = geom
    case = packed_case(kv_bits + S + Hg, B=B, KV=KV, Hg=Hg, D=D, S=S,
                       kv_bits=kv_bits, lengths=lengths)
    got = split_merge_mirror(*map(tt, case), bs=bs, kv_bits=kv_bits)
    want = PACKED_REF(*map(jnp.asarray, case), kv_bits=kv_bits)
    plain = packed_kv_attention_plain(*map(tt, case), kv_bits=kv_bits)
    assert ref.rel_err(got.float().numpy(), want) < 0.03
    assert float((got.float() - plain.float()).abs().max()
                 / plain.float().abs().max()) < 0.03


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_split_merge_mirror_length_zero(kv_bits):
    """A row of length 0: the mirror gives the mean V of its first
    bs-block (every p is 1 there), as the TPU kernel does, while the plain
    version averages all S slots, as the oracle does. The other rows agree
    with the oracle within 0.03."""
    from repro_torch.models.layers import unpack_int4_pairs
    B, KV, Hg, D, S, bs = 3, 1, 4, 32, 256, 128
    case = packed_case(11 + kv_bits, B=B, KV=KV, Hg=Hg, D=D, S=S,
                       kv_bits=kv_bits, lengths=[0, 65, 256])
    got = split_merge_mirror(*map(tt, case), bs=bs, kv_bits=kv_bits)
    want = np.asarray(PACKED_REF(*map(jnp.asarray, case), kv_bits=kv_bits))
    assert ref.rel_err(got[1:].float().numpy(), want[1:]) < 0.03
    _, k, v, ks, vs, _ = map(tt, case)
    v_int = (unpack_int4_pairs(v) if kv_bits == 4 else v).float()
    pv = vs[0, 0].float().to(torch.bfloat16).float()[:, None] * v_int[0, 0]
    first = pv[:bs].mean(0).expand(Hg, D)
    torch.testing.assert_close(got[0, 0].float(),
                               first.to(torch.bfloat16).float(),
                               rtol=1e-2, atol=1e-3)
    plain = packed_kv_attention_plain(*map(tt, case), kv_bits=kv_bits)
    every = pv.mean(0).expand(Hg, D)
    torch.testing.assert_close(plain[0, 0].float(),
                               every.to(torch.bfloat16).float(),
                               rtol=1e-2, atol=1e-3)
    assert not torch.allclose(first, every, rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# kernel 4's exact sums, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_dual_tile_plan_routes_and_covers_k():
    """Decode takes the GEMV, verify the 16-row tiles, prefill the
    128-row tiles; a K split covers every staged slice once and fills
    the card only where the output tiles do not."""
    for M in (1, 4):                              # the GEMV splits nothing
        assert k_split(M, 2048, 8192) == (1, 0)
    assert k_split(128, 2048, 8192) == (1, 0)     # 128 tiles already
    for M in (5, 16, 17, 128, 129):
        bm = 16 if M <= 16 else 128                # verify / prefill tiles
        for K, N in ((2048, 512), (2048, 8192), (128, 256), (256, 64),
                     (130, 64)):
            z, n_scratch = k_split(M, K, N)
            slices = -(-K // (128 if bm == 16 else 64))
            per = -(-slices // z)                  # as the source splits
            assert z >= 1 and (z - 1) * per < slices <= z * per
            tiles = (N // 64) * -(-M // bm)
            assert tiles * z <= max(tiles, 132)
            assert n_scratch == (16 * z * M * N if z > 1 else 0)
    assert k_split(16, 2048, 512)[0] > 1          # wkv's 8 tiles split K


@pytest.mark.parametrize("spread", [0, 20])
def test_dual_exact_sums_do_not_depend_on_order(spread):
    """Float64 sums of granite-like bf16 x int4 rows taken in 16-wide K
    fragments (one DMMA's depth), added in shuffled order, equal the plain
    version bit for bit: each product has at most 12 significant bits, so
    the sums are exact, also for rows whose activations span `spread`
    binades."""
    from repro_torch.core.quant import unpack_int4_hi, unpack_int4_lo
    rng = np.random.default_rng(spread)
    M, K, N = 6, 2048, 64
    x = rng.standard_normal((M, K)) * 2.0 ** rng.uniform(-spread / 2,
                                                         spread / 2, (M, K))
    x = tt(bf16(x))
    buf = tt(rng.integers(0, 256, (K, N)).astype(np.uint8))
    hs = tt(rng.uniform(0.01, 0.05, (1, N)).astype(np.float32))
    ls = tt(rng.uniform(0.01, 0.05, (1, N)).astype(np.float32))
    want = dual_plane_matmul_plain(x, buf, hs, ls)
    xd = x.double()
    for levels, scale, w in ((unpack_int4_hi(buf), hs, want[0]),
                             (unpack_int4_lo(buf), ls, want[1])):
        wd = levels.double()
        frags = [xd[:, f:f + 16] @ wd[f:f + 16] for f in range(0, K, 16)]
        acc = torch.zeros((M, N), dtype=torch.float64)
        for f in rng.permutation(len(frags)):
            acc = acc + frags[f]
        got = (acc.float() * scale.float()).to(torch.bfloat16)
        assert torch.equal(got, w)


@pytest.mark.parametrize("n,d", [(64, 32), (37, 64), (16, 256)])
def test_integrity_pack_plain_vs_ref(n, d):
    """Kernel 3c's plain version: the plain pack bit for bit, and words
    equal to `integrity_words_ref` and to `core.faults.integrity_word` of
    each packed row."""
    from repro.core import faults as F
    x = kv_rows(n + d, n, d)
    p, s, w = quantize_pack_kv_integrity_plain(tt(x))
    pw, sw = quantize_pack_kv_plain(tt(x))
    assert torch.equal(p, pw) and torch.equal(s, sw)
    jw = np.asarray(ref.integrity_words_ref(jnp.asarray(p.numpy())))
    np.testing.assert_array_equal(w.numpy(), jw.astype(np.int64))
    for i in range(n):
        assert int(w[i, 0]) == F.integrity_word(p[i].numpy())
    # the mod 2**32 wrap: rows long enough to overflow 32 bits
    big = torch.full((2, 1 << 13), 255, dtype=torch.uint8)
    want = [F.integrity_word(r.numpy()) for r in big]
    assert integrity_words_plain(big)[:, 0].tolist() == want


# ---------------------------------------------------------------------------
# kernel 1 and the port's bf16 GEMM: one fixed order at every M
# ---------------------------------------------------------------------------

# qwen's and granite's projections and heads, and the reduced configs'
GEMM_KN = [(1024, 2816), (2816, 1024), (1024, 1024), (1024, 3072),
           (2048, 2048), (8192, 2048), (1024, 151936), (2048, 49408),
           (128, 128), (256, 128), (128, 512)]


class _FakeLibrary:
    """Stands in for the kernel library: records each entry's (M, K, N,
    S) instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            m, k, n, s = args[-6:-2] if name == "dense_matmul" \
                else args[-5:-1]
            self.calls.append((name, m, k, n, s))
            return 0
        return entry


def test_gemm_split_reads_k_and_n_only(monkeypatch):
    """The split count the wrappers hand both entries comes from (K, N)
    alone: the same at M = 1, 4, 16, 128, 129; each split covers at
    least one 64-deep stage, the splits tile K in order, a tile's splits
    fit one cluster (<= 8), and the column tiles times the splits fill
    about 132 CTAs where one split does not."""
    fake = _FakeLibrary()
    monkeypatch.setattr(tmm, "library", lambda: fake)
    monkeypatch.setattr(tmm.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    for K, N in GEMM_KN:
        for M in (1, 4, 16, 128, 129):
            x = torch.zeros((M, K), dtype=torch.bfloat16)
            tmm._launch("ternary_matmul", x, torch.zeros(1), N, pre=(0,))
            tmm._launch("dense_matmul", x, torch.zeros(1), N, post=(1,))
        S = split_plan(K, N)
        assert {c[1:] for c in fake.calls} == {
            (M, K, N, S) for M in (1, 4, 16, 128, 129)}
        fake.calls.clear()
        stages = K // tmm.BK
        bounds = [s * stages // S for s in range(S + 1)]   # as the source
        assert bounds[0] == 0 and bounds[-1] == stages
        assert all(b1 - b0 >= 1 for b0, b1 in zip(bounds, bounds[1:]))
        ctas = (N // tmm.BN) * S
        assert 1 <= S <= tmm.MAX_SPLITS
        assert ctas >= min(tmm.SM_TARGET, (N // tmm.BN)
                           * min(stages, tmm.MAX_SPLITS))
        assert S == 1 or ctas < tmm.SM_TARGET + N // tmm.BN
    assert split_plan(2816, 1024) == 8 and split_plan(1024, 2816) == 3
    assert split_plan(1024, 151936) == 1     # the head fills the card


def fixed_order_mirror(x, w):
    """The kernels' order in torch: per K split of `split_plan`, one f32
    chain over 16-deep steps in increasing k (each step's 16 products
    summed, then added to the chain: the m16n8k16 MMA's f32 accumulate),
    the splits' partials added in split order. Elementwise ops only, so
    no row can see another."""
    M, K = x.shape
    S, stages = split_plan(K, w.shape[1]), K // tmm.BK
    xf, wf = x.float(), w.float()
    total = None
    for s in range(S):
        acc = torch.zeros((M, w.shape[1]), dtype=torch.float32)
        for k0 in range(s * stages // S * tmm.BK,
                        (s + 1) * stages // S * tmm.BK, 16):
            step = xf[:, k0, None] * wf[k0]
            for k in range(k0 + 1, k0 + 16):
                step = step + xf[:, k, None] * wf[k]
            acc = acc + step
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("K,N", [(256, 128), (512, 64), (128, 256)])
def test_fixed_order_mirror_vs_ref_and_rows_do_not_depend_on_m(K, N):
    """Kernel 1's order (split from (K, N), 16-deep chains, partials in
    split order) stays within the matmul tolerance of the JAX oracle,
    and every row of an M=4 call equals its row of an M=16 call bit for
    bit."""
    x, w, scale = ternary_case(K + N, 16, K, N)
    trits = tmm.unpack_ternary_2bit(tt(w), K)
    y16 = (fixed_order_mirror(tt(x), trits) * tt(scale)).to(torch.bfloat16)
    want = ref.ternary_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(scale))
    assert ref.rel_err(y16.float().numpy(), want) < 0.02
    y4 = (fixed_order_mirror(tt(x)[4:8], trits) * tt(scale)
          ).to(torch.bfloat16)
    assert torch.equal(y4, y16[4:8])


def test_dense_matmul_plain_is_torch_matmul():
    """The plain version is the product the port computed before it owned
    the GEMM, bit for bit: x @ w, and x @ embed.T for the tied head;
    `ops.dense_matmul` keeps x's leading dims."""
    rng = np.random.default_rng(3)
    x = tt(bf16(rng.standard_normal((2, 3, 128))))
    w = tt(bf16(rng.standard_normal((128, 64)) / 8))
    emb = tt(bf16(rng.standard_normal((512, 128)) / 8))
    assert torch.equal(dense_matmul_plain(x, w), x @ w)
    assert torch.equal(dense_matmul_plain(x, emb, "nk"), x @ emb.T)
    assert torch.equal(ops.dense_matmul(x, emb, layout="nk"), x @ emb.T)
    assert torch.equal(ops.dense_matmul(x, w, plain=True), x @ w)


# ---------------------------------------------------------------------------
# kernels 2 and 5: one split-page design, rehearsed on the CPU
# ---------------------------------------------------------------------------

H100_SHARED_LIMIT = 227 * 1024   # dynamic shared memory a CTA may opt into


def paged_cta_shared_bytes(rows: int, D: int) -> int:
    """Dynamic shared memory of one paged chunk CTA of `rows` (slot, head)
    rows, in the layout of `csrc/paged_kv_attention.cu` (`shared_bytes`,
    constants in `csrc/flash_decode.cuh`): the rows padded to 1, 2 or 4
    MMA tiles of 16 (the kernel's MT); q as padded bf16 rows of D + 8;
    the chunk's 64 K and V rows of 2 * D + 16 bytes, whatever their plane;
    their bf16 scales; bf16 p * v_scale rows of 64 + 8; and the four
    warps' (max, denominator) per row."""
    tiles = -(-rows // 16)
    rp = 16 * (1 if tiles <= 1 else 2 if tiles <= 2 else 4)
    return 2 * rp * (D + 8) + 2 * 64 * (2 * D + 16) + 2 * 2 * 64 \
        + 2 * rp * (64 + 8) + 2 * 4 * 4 * rp


def test_window_plan_takes_minitron_and_fits_a_cta():
    """Every window width up to 16 at granite's (Hg=4, D=64), minitron's
    (Hg=4, D=128) and wider head groups is cut into slot groups of at
    most 64 (slot, head) rows that each fit one CTA's shared memory and
    together cover the window; minitron at spec_k=16 (64 rows) takes one
    CTA, Hg=8 at W=16 two."""
    for Hg, D in ((4, 64), (4, 128), (8, 128), (1, 64), (16, 64)):
        for W in range(1, 17):
            wc = window_plan(W, Hg)
            groups = -(-W // wc)
            assert 1 <= wc <= W and (groups - 1) * wc < W <= groups * wc
            assert wc * Hg <= pka.MAX_ROWS
            assert paged_cta_shared_bytes(wc * Hg, D) <= H100_SHARED_LIMIT
    assert window_plan(16, 4) == 16               # minitron: one CTA
    assert window_plan(16, 8) == 8
    assert window_plan(4, 4) == 4                 # granite: one tile
    with pytest.raises(ValueError, match="exceeds one CTA"):
        window_plan(1, 65)


# (W, Hg, D, page, maxP): qwen's and granite's decode and verify reads,
# minitron's W=16 Hg=4 D=128, the card tests' shapes, pages of 8 and 16
PAGED_CARD_SHAPES = [(1, 1, 64, 16, 32), (4, 1, 64, 16, 32),
                     (1, 4, 64, 16, 32), (4, 4, 64, 16, 32),
                     (16, 4, 128, 16, 32), (8, 2, 32, 8, 20),
                     (16, 4, 64, 16, 8), (1, 2, 32, 8, 20)]


def _paged_config_shapes():
    """(Hg, D, page) of the paged configs' reads, full width and reduced."""
    from repro_torch.configs import get_arch
    out = []
    for name in ("qwen1.5-0.5b", "granite-3-2b"):
        for cfg in (get_arch(name), get_arch(name).reduced()):
            out.append((cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                        cfg.amc.page_size))
    return out


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry's integer
    arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args[12:-1]))
            return 0
        return entry


@pytest.mark.parametrize("page", [8, 16])
def test_paged_chunk_plan_tiles_pages_and_reads_no_lengths(page,
                                                           monkeypatch):
    """The chunk plan reads the page size alone, and both entries hand the
    kernel the same pages a chunk (whole pages, at most 64 tokens) at
    every length, start and W, and the window its `window_plan` slots a
    CTA; a chunk CTA's shared memory fits at every shape the card tests
    and the paged configs use. (That the chunks a launch writes tile a
    row's pages in order, and that the scratch is as long as they need,
    is read from the scratch on the card:
    `test_paged_chunks_written_tile_pages_and_fill_scratch`.)"""
    import inspect
    assert list(inspect.signature(pka.chunk_plan).parameters) == ["page"]
    fake = _RecordingLibrary()
    monkeypatch.setattr(pka, "library", lambda: fake)
    monkeypatch.setattr(pka.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    ppc = pka.chunk_plan(page)
    assert ppc * page <= pka.CHUNK and (ppc + 1) * page > pka.CHUNK
    for W, Hg, D, _, maxP in PAGED_CARD_SHAPES:
        for base in ([1, 0], [maxP * page, 5 * page + 3]):
            case = paged_case(W, B=2, KV=1, Hg=Hg, D=D, page=page, maxP=maxP,
                              kv_bits=4, modes_kind="mixed", lengths=base)
            args = list(map(tt, case))
            args[0] = tt(bf16(np.ones((2, 1, W, Hg, D))))
            name = "paged_kv_attention" if W == 1 \
                else "paged_kv_attention_window"
            pka._launch(name, *args, 4)
            plan = fake.calls.pop()[1]
            want = (ppc,) if W == 1 else (ppc, window_plan(W, Hg))
            assert plan[-len(want):] == want, (name, plan)
        wc = window_plan(W, Hg)
        assert paged_cta_shared_bytes(wc * Hg, D) <= H100_SHARED_LIMIT
    for Hg, D, pg in _paged_config_shapes():
        assert pg % 8 == 0 and 8 <= pg <= pka.CHUNK and D % 32 == 0
        for W in (1, 4, 16):
            wc = window_plan(W, Hg)
            assert paged_cta_shared_bytes(wc * Hg, D) <= H100_SHARED_LIMIT
    for bad in (12, 4, 72):
        with pytest.raises(ValueError, match="multiple of 8"):
            pka.chunk_plan(bad)


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("geom", [
    # (B, KV, Hg, D, page, maxP, lengths): 1, a page's and the 64-token
    # chunk's edges, maxP * page and past it; mixed planes in a chunk
    (6, 2, 4, 64, 16, 10, [1, 16, 17, 64, 65, 300]),
    (5, 1, 2, 32, 8, 12, [8, 63, 64, 96, 97]),
])
def test_paged_split_merge_mirror_vs_ref(kv_bits, geom):
    """The split-page order (chunks of whole pages, p * v_scale rounded to
    bf16 against each chunk's own max, l in the kernel's order, the merge
    in chunk order) stays within the kernel's 0.03 of the JAX oracle and
    of the plain version."""
    B, KV, Hg, D, page, maxP, lengths = geom
    case = paged_case(kv_bits + page, B=B, KV=KV, Hg=Hg, D=D, page=page,
                      maxP=maxP, kv_bits=kv_bits, modes_kind="mixed",
                      lengths=lengths)
    assert 0 < case[9].sum() < case[9].size          # both planes
    got = paged_split_merge_mirror(*map(tt, case), kv_bits=kv_bits)
    want = PAGED_REF(*map(jnp.asarray, case), kv_bits=kv_bits)
    plain = paged_kv_attention_plain(*map(tt, case), kv_bits=kv_bits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, KV, Hg, D)
    assert ref.rel_err(got.float().numpy(), want) < 0.03
    assert float((got.float() - plain.float()).abs().max()
                 / plain.float().abs().max()) < 0.03


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_ops_take_the_plain_versions_on_cpu_tensors():
    ops.reset_launch_counts()
    x, w, scale = ternary_case(0, 4, 128, 64)
    y = ops.ternary_matmul(tt(x), tt(w), tt(scale))
    torch.testing.assert_close(y, ternary_matmul_plain(tt(x), tt(w),
                                                       tt(scale)),
                               rtol=0, atol=0)
    p, s = ops.quantize_pack_kv(tt(kv_rows(1, 12, 32)).reshape(3, 4, 32))
    assert tuple(p.shape) == (3, 4, 16) and tuple(s.shape) == (3, 4, 1)
    assert s.dtype == torch.bfloat16
    case = paged_case(2, B=2, KV=1, Hg=1, D=32, page=8, maxP=2, kv_bits=8,
                      modes_kind="mixed", lengths=[3, 16])
    ops.paged_kv_attention(*map(tt, case), kv_bits=8)
    q, k, v, ks, vs, lens = packed_case(3, B=2, KV=1, Hg=2, D=32, S=16,
                                        kv_bits=4, lengths=[3, 20])
    ops.packed_kv_attention(*map(tt, (q, k, v, ks, vs, lens)), bs=16)
    y = ops.dense_matmul(tt(x), torch.ones((64, 128), dtype=torch.bfloat16),
                         layout="nk")
    assert tuple(y.shape) == (4, 64)
    assert ops.launch_counts() == {"ternary_matmul": 0,
                                   "dense_matmul": 0,
                                   "expert_matmul": 0,
                                   "dual_plane_matmul": 0,
                                   "paged_kv_attention": 0,
                                   "paged_kv_attention_window": 0,
                                   "quantize_pack_kv": 0,
                                   "quantize_pack_kv_masked": 0,
                                   "quantize_pack_kv_integrity": 0,
                                   "paged_kv_write": 0,
                                   "packed_kv_attention": 0,
                                   "imc_dot": 0,
                                   "imc_dual_dot": 0}


def test_cuda_wrappers_refuse_cpu_tensors_without_launching():
    x, w, scale = ternary_case(0, 4, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ternary_matmul_cuda(tt(x), tt(w), tt(scale))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_pack_kv_cuda(tt(kv_rows(0, 4, 32)))
    case = paged_case(0, B=1, KV=1, Hg=1, D=32, page=8, maxP=1, kv_bits=4,
                      modes_kind="aug", lengths=[3])
    with pytest.raises(ValueError, match="CUDA"):
        paged_kv_attention_cuda(*map(tt, case), kv_bits=4)
    buf = tt(np.zeros((128, 64), np.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        dual_plane_matmul_cuda(tt(x), buf, tt(scale), tt(scale))
    with pytest.raises(ValueError, match="CUDA"):
        imc_dot_cuda(tt(x), tt(w), tt(scale), fmt="ternary", abits=8)
    with pytest.raises(ValueError, match="CUDA"):
        imc_dual_dot_cuda(tt(x), buf, tt(scale), tt(scale), abits=4)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_activations_cuda(tt(x), 8)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_pack_kv_integrity_cuda(tt(kv_rows(0, 4, 32)))
    pc = packed_case(0, B=1, KV=1, Hg=1, D=32, S=16, kv_bits=4, lengths=[3])
    with pytest.raises(ValueError, match="CUDA"):
        packed_kv_attention_cuda(*map(tt, pc), bs=16)
    with pytest.raises(ValueError, match="kernel-path"):
        ops.packed_kv_attention(*map(tt, pc), bs=16, debug_visits=True)
    assert quantize_pack_kv_integrity_cuda.launches == 0
    assert packed_kv_attention_cuda.launches == 0
    assert ternary_matmul_cuda.launches == 0
    assert quantize_pack_kv_cuda.launches == 0
    assert paged_kv_attention_cuda.launches == 0
    assert dual_plane_matmul_cuda.launches == 0
    assert imc_dot_cuda.launches == imc_dual_dot_cuda.launches == 0


def test_kernel_library_name_follows_the_sources(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    before = build.library_path()
    assert before.parent == build.BUILD_DIR and before.suffix == ".so"
    assert {p.name for p in build.sources()} == {
        "ternary_matmul.cu", "quantize_pack_kv.cu", "paged_kv_attention.cu",
        "dual_plane_matmul.cu", "imc_dot.cu", "packed_kv_attention.cu"}
    headers = sorted(build.CSRC.glob("*.cuh"))
    assert {p.name for p in headers} == {"flash_decode.cuh",
                                         "device_common.cuh"}
    for src in build.sources() + headers:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path() == before
    (tmp_path / "flash_decode.cuh").write_text("// edited\n")
    edited_header = build.library_path()
    assert edited_header != before
    (tmp_path / "device_common.cuh").write_text("// edited\n")
    edited_common = build.library_path()
    assert edited_common not in (before, edited_header)
    (tmp_path / "ternary_matmul.cu").write_text("// edited\n")
    assert build.library_path() not in (before, edited_header, edited_common)
