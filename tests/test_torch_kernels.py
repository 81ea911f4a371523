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
from repro_torch.kernels.dual_plane_matmul import dual_plane_matmul_cuda
from repro_torch.kernels.imc_dot import (imc_dot_cuda, imc_dual_dot_cuda,
                                         quantize_activations_cuda)
from repro_torch.kernels.packed_kv_attention import (
    packed_kv_attention_cuda, packed_kv_attention_plain)
from repro_torch.kernels.paged_kv_attention import (
    paged_kv_attention_cuda, paged_kv_attention_plain)
from repro_torch.kernels.quantize_pack_kv import (
    integrity_words_plain, quantize_pack_kv_cuda,
    quantize_pack_kv_integrity_cuda, quantize_pack_kv_integrity_plain,
    quantize_pack_kv_plain)
from repro_torch.kernels.ternary_matmul import (ternary_matmul_cuda,
                                                ternary_matmul_plain)
from repro_torch.models.params import from_numpy_tree

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
    assert ops.launch_counts() == {"ternary_matmul": 0,
                                   "dual_plane_matmul": 0,
                                   "paged_kv_attention": 0,
                                   "paged_kv_attention_window": 0,
                                   "quantize_pack_kv": 0,
                                   "quantize_pack_kv_masked": 0,
                                   "quantize_pack_kv_integrity": 0,
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
    for src in build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path() == before
    (tmp_path / "ternary_matmul.cu").write_text("// edited\n")
    assert build.library_path() != before
