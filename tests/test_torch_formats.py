"""Storage formats of the PyTorch port held bit for bit against the JAX
package: int4/int8 quantization, int4 nibble pairs, TWN ternarization and
2-bit trit packing, the paged KV packs, the numpy parameter bridge, and
the configs / retention semantics they hang off."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import quant as jq
from repro.core import ternary as jt
from repro.core.retention import RefreshPolicy as JaxRefreshPolicy
from repro.models import augment as jaug
from repro.models import layers as jl
from repro_torch.configs import get_arch
from repro_torch.configs.base import AMCConfig
from repro_torch.core import quant as tq
from repro_torch.core import ternary as tt
from repro_torch.core.retention import RefreshPolicy
from repro_torch.models import augment as taug
from repro_torch.models import layers as tl
from repro_torch.models.params import from_numpy_tree

CPU = torch.device("cpu")


def to_torch(a) -> torch.Tensor:
    return from_numpy_tree(np.asarray(a), CPU)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def jnp_f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def kv_rows(seed: int, shape) -> np.ndarray:
    """bf16-representable rows with the awkward cases: an all-zero row,
    rows of exact half-steps (rounding ties) and a wide dynamic range."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.01, 20, shape[:-1] + (1,))
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1:4] = np.round(flat[1:4] * 2) / 2
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(64, 32), (3, 5, 64), (1, 2)])
def test_quantize_rows_bit_exact(bits, shape):
    x = kv_rows(bits + len(shape), shape)
    jfn = jq.quantize_int4 if bits == 4 else jq.quantize_int8
    tfn = tq.quantize_int4 if bits == 4 else tq.quantize_int8
    jqv, js = jfn(jnp.asarray(x), axis=-1)
    q, s = tfn(to_torch(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(to_np(s), jnp_f32(js))


def test_int4_pair_pack_and_unpack_every_byte():
    rng = np.random.default_rng(0)
    hi = rng.integers(-8, 8, size=(97,)).astype(np.int8)
    lo = rng.integers(-8, 8, size=(97,)).astype(np.int8)
    packed = tq.pack_int4_pair(torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jq.pack_int4_pair(hi, lo)))
    every = np.arange(256, dtype=np.uint8)
    te = torch.from_numpy(every)
    np.testing.assert_array_equal(tq.unpack_int4_hi(te).numpy(),
                                  np.asarray(jq.unpack_int4_hi(every)))
    np.testing.assert_array_equal(tq.unpack_int4_lo(te).numpy(),
                                  np.asarray(jq.unpack_int4_lo(every)))


@pytest.mark.parametrize("shape", [(128, 96), (256, 8)])
def test_ternarize_matches_jax(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jtv, js = jt.ternarize(jnp.asarray(w), axis=0)
    t, s = tt.ternarize(torch.from_numpy(w), dim=0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jtv))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


def test_ternary_2bit_pack_unpack_bit_exact():
    rng = np.random.default_rng(2)
    trits = rng.integers(-1, 2, size=(64, 40)).astype(np.int8)
    packed = tt.pack_ternary_2bit(torch.from_numpy(trits))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jt.pack_ternary_2bit(jnp.asarray(trits))))
    np.testing.assert_array_equal(
        tt.unpack_ternary_2bit(packed, 64).numpy(), trits)
    with pytest.raises(ValueError, match="multiple of 4"):
        tt.pack_ternary_2bit(torch.zeros((6, 2), dtype=torch.int8))


def test_stacked_ternary_pack_matches_jax_augment():
    """The engine's weight pack: per-layer (K, N) slabs of a stacked
    (n, K, N) weight, trits bit-exact and scales within 1e-6."""
    w = np.random.default_rng(3).standard_normal((2, 128, 64)
                                                  ).astype(np.float32)
    jp, js = jaug._ternary_pack(jnp.asarray(w))
    p, s = taug._ternary_pack(torch.from_numpy(w))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_kv_bit_exact_and_unpack(bits):
    x = kv_rows(10 + bits, (2, 5, 4, 32))
    jpack = jl.pack_kv_int4 if bits == 4 else jl.pack_kv_int8
    junpack = jl.unpack_kv_int4 if bits == 4 else jl.unpack_kv_int8
    tpack = tl.pack_kv_int4 if bits == 4 else tl.pack_kv_int8
    tunpack = tl.unpack_kv_int4 if bits == 4 else tl.unpack_kv_int8
    jp, js = jpack(jnp.asarray(x))
    p, s = tpack(to_torch(x))
    assert p.dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to_np(s), jnp_f32(js))
    np.testing.assert_array_equal(to_np(tunpack(p, s)),
                                  jnp_f32(junpack(jp, js)))


def test_from_numpy_tree_carries_dense_and_packed_trees():
    cfg = jax_get_arch("qwen1.5-0.5b").reduced()
    from repro.models import model as jm
    from repro.models.params import init_params
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    dense = init_params(jm.abstract_params(dense_cfg), jax.random.PRNGKey(0))
    packed = jaug.augment_params(cfg, dense)
    for tree in (dense, packed):
        np_tree = jax.tree.map(np.asarray, tree)
        tt_tree = from_numpy_tree(np_tree, CPU)
        flat_j = jax.tree_util.tree_flatten_with_path(np_tree)[0]
        for path, a in flat_j:
            t = tt_tree
            for k in path:
                t = t[k.key]
            want_dt = {"bfloat16": torch.bfloat16, "uint8": torch.uint8,
                       "float32": torch.float32}[a.dtype.name]
            assert t.dtype == want_dt and tuple(t.shape) == a.shape, path
            np.testing.assert_array_equal(
                to_np(t), a.astype(np.float32) if want_dt == torch.bfloat16
                else a)
    # bf16 may also cross as plain uint16 words
    words = np.asarray(dense["embed"]).view(np.uint16)
    np.testing.assert_array_equal(
        to_np(from_numpy_tree(words, CPU)),
        np.asarray(dense["embed"]).astype(np.float32))


def test_dequant_params_matches_jax():
    cfg = jax_get_arch("qwen1.5-0.5b").reduced()
    from repro.models import model as jm
    from repro.models.params import init_params
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    packed = jaug.augment_params(cfg, init_params(
        jm.abstract_params(dense_cfg), jax.random.PRNGKey(1)))
    jd = jaug.dequant_params(cfg, packed)
    td = taug.dequant_params(get_arch("qwen1.5-0.5b").reduced(),
                             from_numpy_tree(jax.tree.map(np.asarray,
                                                          packed), CPU))
    for g in ("attn", "mlp"):
        for k, v in jd["layers"][g].items():
            np.testing.assert_array_equal(to_np(td["layers"][g][k]),
                                          jnp_f32(v), err_msg=f"{g}/{k}")


def test_config_matches_jax_and_unported_archs_raise():
    """(Name kept from when minitron-8b was not ported.) The port serves
    every arch of the JAX registry; only an unknown name raises."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs.registry import ARCHS, NOT_YET_PORTED
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and NOT_YET_PORTED == ()
    for arch in ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "grok-1-314b",
                 "minicpm-2b", "minitron-8b"):
        for full in (True, False):
            j, t = jax_get_arch(arch), get_arch(arch)
            if not full:
                j, t = j.reduced(), t.reduced()
            for f in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "hd", "vocab_padded",
                      "qkv_bias", "rope_theta", "norm_eps",
                      "tie_embeddings", "act"):
                assert getattr(t, f) == getattr(j, f), (arch, f)
            for f in ("weight_mode", "kv_mode", "page_size", "pool_mode",
                      "retention_steps", "aug_bits", "resolved_pool_mode"):
                assert getattr(t.amc, f) == getattr(j.amc, f), (arch, f)
            if j.moe is None:
                assert t.moe is None
            else:
                for f in ("n_experts", "top_k", "capacity_factor",
                          "sharding", "shared_expert"):
                    assert getattr(t.moe, f) == getattr(j.moe, f), (arch, f)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("kv_mode,pool_mode", [
    ("normal", "auto"), ("int4", "auto"), ("int8", "auto"),
    ("int8", "augment-on-pressure"), ("normal", "always-augmented")])
def test_amc_pool_policy_matches_jax(kv_mode, pool_mode):
    from repro.configs.base import AMCConfig as JaxAMC
    j = JaxAMC(kv_mode=kv_mode, pool_mode=pool_mode)
    t = AMCConfig(kv_mode=kv_mode, pool_mode=pool_mode)
    assert (t.aug_bits, t.resolved_pool_mode) == \
        (j.aug_bits, j.resolved_pool_mode)


def test_refresh_policy_matches_jax():
    t, j = RefreshPolicy(retention_steps=3), JaxRefreshPolicy(
        retention_steps=3)
    seen = []
    for step in range(12):
        if step in (2, 7):
            t.stamp(step)
            j.stamp(step)
        seen.append((t.valid(step), t.age(step), t.needs_refresh(step),
                     t.expires_at()) ==
                    (j.valid(step), j.age(step), j.needs_refresh(step),
                     j.expires_at()))
    assert all(seen)
