"""The dual-plane (8T) weight mode of the port held against the JAX
package: the pack of two weights into one uint8 buffer, the dual matmul's
plain version, the packed tree's round trip, and granite-3-2b's reduced
model over the paged pool (MHA as `reduced()` makes it, and a GQA variant
built identically on both sides).

Tolerances: buffers and scales exact; the plain matmul within one bf16
ulp of the oracle (two float32 sums in another order, rounded once);
logits rel_err < 0.05, as tests/test_torch_model.py holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref
from repro.launch.mesh import mesh_context
from repro.models import augment as jaug
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro.serve import cache_pool as jpool_mod
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.dual_plane_matmul import (dual_plane_matmul_cuda,
                                                   dual_plane_matmul_plain)
from repro_torch.models import augment as taug
from repro_torch.models import model as tm
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import cache_pool as tpool_mod

CPU = torch.device("cpu")
ARCH = "granite-3-2b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced model's tensors are tiny: torch's intra-op threads only
    contend with XLA's thread pool in this process (10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a) -> torch.Tensor:
    return from_numpy_tree(np.asarray(a), CPU)


def bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def ulps_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 ulps between two float32 arrays of bf16 values."""
    def ordered(x):
        bits = np.asarray(x, np.float32).view(np.int32) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits).astype(np.int64)
    return np.abs(ordered(a) - ordered(b))


def dual_case(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = bf16(rng.standard_normal((M, K)))
    buf = rng.integers(0, 256, size=(K, N)).astype(np.uint8)
    hs = rng.uniform(0.01, 0.1, size=(1, N)).astype(np.float32)
    ls = rng.uniform(0.01, 0.1, size=(1, N)).astype(np.float32)
    return x, buf, hs, ls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 64), (1, 64, 256), (3, 32, 40)])
def test_dual_pack_bit_exact(dtype, shape):
    """buf and both scales equal `repro.models.augment._dual_pack`, with a
    zero column (amax == 0) in each weight."""
    rng = np.random.default_rng(len(shape) + shape[1])
    w_hi = rng.standard_normal(shape) * rng.uniform(0.01, 3, shape[:-1] + (1,))
    w_lo = rng.standard_normal(shape) * 0.02
    w_hi[:, :, 0] = 0.0
    w_lo[:, :, -1] = 0.0
    w_hi, w_lo = (jnp.asarray(w, jnp.float32).astype(dtype)
                  for w in (w_hi, w_lo))
    jb, jhs, jls = jaug._dual_pack(w_hi, w_lo)
    b, hs, ls = taug._dual_pack(tt(w_hi), tt(w_lo))
    assert b.dtype == torch.uint8 and hs.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(jhs))
    np.testing.assert_array_equal(ls.numpy(), np.asarray(jls))


@pytest.mark.parametrize("M,K,N", [(1, 128, 64), (4, 256, 128),
                                   (16, 128, 192), (37, 512, 64)])
def test_dual_plane_matmul_plain_vs_ref(M, K, N):
    x, buf, hs, ls = dual_case(M + K + N, M, K, N)
    want = ref.dual_plane_matmul_ref(*map(jnp.asarray, (x, buf, hs, ls)))
    got = dual_plane_matmul_plain(*map(tt, (x, buf, hs, ls)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == (M, N)
        assert ulps_apart(g.float().numpy(),
                          np.asarray(w.astype(jnp.float32))).max() <= 1


def test_ops_dual_takes_the_plain_version_on_cpu():
    ops.reset_launch_counts()
    x, buf, hs, ls = map(tt, dual_case(0, 4, 128, 64))
    got = ops.dual_plane_matmul(x, buf, hs, ls)
    want = dual_plane_matmul_plain(x, buf, hs, ls)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts()["dual_plane_matmul"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        dual_plane_matmul_cuda(x, buf, hs, ls)
    assert dual_plane_matmul_cuda.launches == 0


@pytest.fixture(scope="module")
def dual_trees():
    """granite-reduced dense weights and the JAX package's dual pack of
    them, as numpy."""
    cfg = jax_get_arch(ARCH).reduced()
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    dense = jax_init_params(jm.abstract_params(dense_cfg),
                            jax.random.PRNGKey(2))
    packed = jaug.augment_params(cfg, dense)
    return (jax.tree.map(np.asarray, dense), jax.tree.map(np.asarray, packed))


def test_augment_and_dequant_params_match_jax(dual_trees):
    dense, packed = dual_trees
    cfg = get_arch(ARCH).reduced()
    tp = taug.augment_params(cfg, from_numpy_tree(dense, CPU))
    assert taug.is_augmented(tp)
    for g in ("attn", "mlp"):
        assert sorted(tp["layers"][g]) == sorted(packed["layers"][g])
        for k, v in packed["layers"][g].items():
            t = tp["layers"][g][k]
            got = t.float().numpy() if t.dtype == torch.bfloat16 \
                else t.numpy()
            np.testing.assert_array_equal(
                got, v.astype(np.float32) if v.dtype.name == "bfloat16"
                else v, err_msg=f"{g}/{k}")
    assert tp["layers"]["attn"]["wkv_buf"].dtype == torch.uint8
    assert tp["layers"]["mlp"]["w_up_scale"].dtype == torch.float32
    jcfg = jax_get_arch(ARCH).reduced()
    jd = jaug.dequant_params(jcfg, jax.tree.map(jnp.asarray, packed))
    td = taug.dequant_params(cfg, from_numpy_tree(packed, CPU))
    for g in ("attn", "mlp"):
        for k, v in jd["layers"][g].items():
            np.testing.assert_array_equal(
                td["layers"][g][k].float().numpy(),
                np.asarray(v.astype(jnp.float32)), err_msg=f"{g}/{k}")


def test_granite_config_matches_jax():
    for full in (True, False):
        j, t = jax_get_arch(ARCH), get_arch(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "hd", "vocab_padded",
                  "qkv_bias", "rope_theta", "norm_eps", "tie_embeddings",
                  "act", "source"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("weight_mode", "kv_mode", "aug_bits", "spec_k",
                  "spec_draft_impl", "resolved_pool_mode"):
            assert getattr(t.amc, f) == getattr(j.amc, f), f


B, C, MAX_SEQ = 2, 8, 48


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_granite_dual_logits_match_jax(mesh, n_kv_heads):
    """One chunked-prefill dispatch and one decode step of the dual-weight
    model on both sides (JAX on its reference paths), at kv int8 so the
    JAX pool runs in this process; n_kv_heads=2 is the GQA variant."""
    def shape(c, **amc):
        c = dataclasses.replace(c, n_kv_heads=n_kv_heads)
        return dataclasses.replace(c, amc=dataclasses.replace(
            c.amc, kv_mode="int8", **amc))

    jcfg = shape(jax_get_arch(ARCH).reduced(), kv_impl="dequant",
                 matmul_impl="dense")
    tcfg = shape(get_arch(ARCH).reduced())
    dense_cfg = dataclasses.replace(jcfg, amc=dataclasses.replace(
        jcfg.amc, weight_mode="normal"))
    dense = jax_init_params(jm.abstract_params(dense_cfg),
                            jax.random.PRNGKey(5))
    jparams = jaug.augment_params(jcfg, dense)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), CPU)
    jp = jpool_mod.PagedKVPool(jcfg, max_batch=B, max_seq=MAX_SEQ)
    tp = tpool_mod.PagedKVPool(tcfg, max_batch=B, max_seq=MAX_SEQ,
                               device=CPU)
    for p in (jp, tp):
        assert p.admit_row(0, C + 1, step=0) and p.admit_row(1, C, step=0)
    rng = np.random.default_rng(n_kv_heads)
    V = jcfg.vocab
    pre = {"tokens": rng.integers(0, V, size=(B, C)).astype(np.int32),
           "positions": np.zeros(B, np.int32), "write_mask": np.ones(B, bool)}

    def run(jfn, tfn, extra):
        jb = {**jp.device_tables(),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
        tb = {**tp.device_tables(),
              **{k: torch.from_numpy(v) for k, v in extra.items()}}
        with mesh_context(mesh):
            jl, jp.arenas = jax.jit(lambda p, s, b: jfn(jcfg, p, s, b))(
                jparams, jp.arenas, jb)
        tl, _ = tfn(tcfg, tparams, tp.arenas, tb)
        jl = np.asarray(jl)[..., :V]
        assert ref.rel_err(tl.numpy()[..., :V], jl) < 0.05
        return jl

    jl = run(jm.paged_prefill_step, tm.paged_prefill_step, pre)
    run(jm.paged_decode_step, tm.paged_decode_step,
        {"tokens": jl[:, -1].argmax(-1).astype(np.int32)[:, None],
         "positions": np.full(B, C, np.int32),
         "write_mask": np.ones(B, bool)})
