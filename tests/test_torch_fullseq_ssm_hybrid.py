"""The full-sequence halves of the ssm (mamba2-130m reduced) and hybrid
(recurrentgemma-9b reduced) families held against the JAX package: the
SSD scan and the RG-LRU block alone, the ring hand-off, the forward, loss
and gradients, each block on the JAX residual, `forward(return_cache=
True)` and the first decode step after it, one AdamW train step and the
mamba2 `Trainer`; in the port alone, teacher-forced decode against the
forward and the four remat policies.

Every JAX run happens in ONE child process (`torch_fullseq_oracle`, with
`XLA_FLAGS=--xla_allow_excess_precision=false`); the port takes the JAX
weights through `from_numpy_tree` and runs its kernel routes' plain
versions (kernel 6 in the hybrid's decode step).

Tolerances (`ref.rel_err`: max |a - b| / max |b|):
- `ssd_chunked` with an initial state over 4 chunks: float32 inputs
  < 1e-4 (y and the final state), bf16 inputs < 2e-2;
- `rec_block` with h0 (float32 params and input): y and h < 1e-4 (the
  doubling scan and `associative_scan` add in different orders), the
  conv tail too (a float32 product); `_ring_from_full` bit for bit;
- forward / loss / every gradient leaf: float32 params (1e-2, 1e-3,
  1e-2), bf16 params (0.05, 2e-2, 0.05), as tests/test_torch_train.py;
  each block of a float32 tree on the JAX residual (cast to float32, so
  that no bf16 rounding of the block's output is compared) < 1e-3; the
  float32 tree is float32 in every leaf (XLA sums the gradient of a bf16
  scalar broadcast over a tensor in bf16);
- the forward's cache: float leaves < 1e-2; the port's int4 pack of
  JAX's bf16 ring equal to JAX's packed ring bit for bit; the first
  decode step on it < 0.05 against JAX's decode step on JAX's cache;
- teacher-forced decode from an empty cache against the forward's last
  position < 0.15 (tests/test_arch_smoke.py:112); remat policies bit for
  bit;
- one AdamW step (bf16): loss |d| < 2e-2, every entry within 2.5 lr of
  JAX's and >= 99% of the entries bit for bit (tests/test_torch_train.py);
  the Trainer's 12 losses within 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rel_err
from repro.models import hybrid as jhybrid
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import hybrid as th
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_fullseq_oracle import leaves, run_child, tree_of

CPU = torch.device("cpu")
ARCHS = ("mamba2-130m", "recurrentgemma-9b")
DTYPES = ("f32", "bf16")
SHAPES = {"B": 2, "S": 64, "T": 4, "q_chunk": 16, "lr": 1e-3, "step_B": 4,
          "step_archs": ["mamba2-130m"], "trainer_archs": ["mamba2-130m"],
          "trainer": {"steps": 12, "seq": 64, "batch": 4, "lr": 5e-3,
                      "warmup": 2},
          "ssd": {"B": 2, "S": 64, "H": 4, "P": 8, "N": 16, "chunk": 16},
          "lru": {"B": 2, "S": 24}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' tensors are tiny: torch's intra-op threads only
    contend with the JAX child's and the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_child(tmp_path_factory.mktemp("fullseq_ssm_hybrid"),
                     list(ARCHS), SHAPES)


def bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def tensor(a: np.ndarray) -> torch.Tensor:
    return bf16(a) if a.dtype == np.uint16 else torch.from_numpy(a.copy())


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return bf16(a).float().numpy() if a.dtype == np.uint16 \
        else a.astype(np.float32)


def cfg_of(arch: str, **amc):
    c = get_arch(arch).reduced()
    return dataclasses.replace(c, amc=dataclasses.replace(
        c.amc, weight_mode="normal", **amc))


def batch_of(want: dict, prefix: str) -> dict:
    return {k: tensor(want[f"{prefix}/batch/{k}"])
            for k in ("tokens", "targets")}


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_jax(oracle, dtype):
    sh = SHAPES["ssd"]
    ins = {k: tensor(oracle[f"ssd/{dtype}/in/{k}"])
           for k in ("x", "a", "b", "c", "h0")}
    with torch.no_grad():
        y, h = tssm.ssd_chunked(ins["x"], ins["a"], ins["b"], ins["c"],
                                sh["chunk"], ins["h0"])
    assert sh["S"] // sh["chunk"] >= 2
    assert y.dtype == ins["x"].dtype and h.dtype == torch.float32
    tol = 1e-4 if dtype == "f32" else 2e-2
    assert rel_err(f32(y), f32(oracle[f"ssd/{dtype}/y"])) < tol
    assert rel_err(f32(h), f32(oracle[f"ssd/{dtype}/h"])) < tol


def test_rec_block_matches_jax(oracle):
    cfg = cfg_of("recurrentgemma-9b")
    lp = from_numpy_tree(tree_of(oracle, "lru/params"), CPU)
    with torch.no_grad():
        y, h, conv = th.rec_block(cfg, lp, tensor(oracle["lru/x"]),
                                  h0=tensor(oracle["lru/h0"]),
                                  return_state=True)
    assert h.dtype == torch.float32
    assert rel_err(f32(y), f32(oracle["lru/y"])) < 1e-4
    assert rel_err(f32(h), f32(oracle["lru/h"])) < 1e-4
    assert rel_err(f32(conv), f32(oracle["lru/conv"])) < 1e-4


@pytest.mark.parametrize("S", [9, 16, 37])
def test_ring_from_full_bit_equal(S):
    W = 16
    k = np.random.default_rng(S).standard_normal((2, S, 1, 8)).astype(
        np.float32)
    want = np.asarray(jhybrid._ring_from_full(jnp.asarray(k, jnp.bfloat16),
                                              W)).view(np.uint16)
    got = th._ring_from_full(torch.from_numpy(k).bfloat16(), W)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_match_jax(oracle, arch, dtype):
    tag = f"{arch}/{dtype}"
    cfg = cfg_of(arch)
    params = from_numpy_tree(tree_of(oracle, f"{tag}/params"), CPU)
    batch = batch_of(oracle, tag)
    tol = {"f32": (1e-2, 1e-3, 1e-2), "bf16": (0.05, 2e-2, 0.05)}[dtype]
    with torch.no_grad():
        logits = tm.forward(cfg, params, batch, q_chunk=SHAPES["q_chunk"])
    assert logits.dtype == torch.float32
    assert rel_err(logits.numpy()[..., :cfg.vocab],
                   oracle[f"{tag}/logits"]) < tol[0]
    loss, grads = step_lib.value_and_grad(
        lambda p, b: tm.loss_fn(cfg, p, b, remat_policy="nothing",
                                q_chunk=SHAPES["q_chunk"]), params, batch)
    assert abs(float(loss) - float(oracle[f"{tag}/loss"])) < tol[1]
    want = dict(leaves(tree_of(oracle, f"{tag}/grads")))
    got = dict(leaves(grads))
    assert set(got) == set(want)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        assert g.dtype == params_dtype(params, name), name
        assert rel_err(f32(g), f32(want[name])) < tol[2], name


def params_dtype(params: dict, name: str) -> torch.dtype:
    node = params
    for k in name.split("/"):
        node = node[k]
    return node.dtype


def port_blocks(cfg, params) -> list:
    """The port's blocks in the oracle's order, each a function of the
    JAX block's inputs."""
    q = SHAPES["q_chunk"]
    mlp = lambda p: (lambda x: tt.mlp_block(cfg, p, x, fixed_order=False,
                                            norm_fixed=False))
    pos = torch.arange(SHAPES["S"])
    if cfg.family == "ssm":
        return [lambda x, lp=tt._layer(params["layers"], i):
                tssm.block(cfg, lp, x) for i in range(cfg.n_layers)]
    nb, tail = th._layout(cfg)
    out = []
    for i in range(nb):
        bp = tt._layer_groups(params["blocks"], i)
        for r in ("rec_a", "rec_b"):
            out += [lambda x, p=bp[r]: th.rec_block(cfg, p, x),
                    mlp(bp[r + "_mlp"])]
        out += [lambda x, p=bp["attn"]: tt.attn_block(
            cfg, p, x, pos, window=cfg.hybrid.window, q_chunk=q)[0],
            mlp(bp["attn_mlp"])]
    for i in range(tail):
        tp = tt._layer_groups(params["tail"], i)
        out += [lambda x, p=tp["rec"]: th.rec_block(cfg, p, x),
                mlp(tp["mlp"])]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_jax_f32(oracle, arch):
    tag = f"{arch}/f32"
    cfg = cfg_of(arch)
    params = from_numpy_tree(tree_of(oracle, f"{tag}/params"), CPU)
    fns = port_blocks(cfg, params)
    assert f"{tag}/blocks/{len(fns)}/out" not in oracle
    with torch.no_grad():
        for i, fn in enumerate(fns):
            name = str(oracle[f"{tag}/blocks/{i}/name"])
            got = fn(tensor(oracle[f"{tag}/blocks/{i}/in0"]).float())
            assert rel_err(f32(got), f32(oracle[f"{tag}/blocks/{i}/out"])) \
                < 1e-3, name


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_cache_and_handoff_match_jax(oracle, arch):
    """forward(return_cache=True) at the config's kv mode (hybrid: the
    int4 ring) and its first decode step; the port's pack of JAX's bf16
    ring (kv "normal") equals JAX's packed ring byte for byte."""
    cfg = cfg_of(arch)
    kv = cfg.amc.kv_mode
    params = from_numpy_tree(tree_of(oracle, f"{arch}/bf16/params"), CPU)
    batch = batch_of(oracle, f"{arch}/bf16")
    with torch.no_grad():
        _, cache = tm.forward(cfg, params, batch, return_cache=True,
                              remat_policy="none", q_chunk=SHAPES["q_chunk"])
        want = tree_of(oracle, f"{arch}/cache/{kv}/tree")
        got = dict(_flat(cache))
        assert set(got) == set(dict(leaves(want)))
        for name, w in leaves(want):
            g = got[name]
            assert tuple(g.shape) == w.shape, name
            if g.dtype in (torch.uint8, torch.int8):
                continue            # the packed ring: held below
            assert rel_err(f32(g), f32(w)) < 1e-2, name
        if kv != "normal":
            normal = dict(leaves(tree_of(oracle, f"{arch}/cache/normal/tree")))
            packed = dict(leaves(want))
            pack = tl.pack_kv_int4 if kv == "int4" else tl.pack_kv_int8
            for k in ("k", "v"):
                q, s = pack(tl.to_kvmajor(tensor(normal[f"blocks/{k}"])))
                np.testing.assert_array_equal(_bits(q), packed[f"blocks/{k}"])
                np.testing.assert_array_equal(_bits(s),
                                              packed[f"blocks/{k}_scale"])
        B, S = batch["tokens"].shape
        lg, new = tm.decode_step(cfg, params, cache, {
            "tokens": tensor(oracle[f"{arch}/cache/next"]),
            "positions": torch.full((B,), S, dtype=torch.int32)})
    assert jax.tree_util.tree_structure(new) == \
        jax.tree_util.tree_structure(cache)
    assert rel_err(lg.numpy()[..., :cfg.vocab],
                   oracle[f"{arch}/cache/{kv}/decode"]) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode from an empty cache reproduces the forward's
    last logits at kv "normal" (tests/test_arch_smoke.py:110-131; the
    hybrid's 16-slot ring wraps at S = 32)."""
    from repro_torch.models.params import init_params
    cfg = cfg_of(arch, kv_mode="normal")
    params = init_params(cfg, seed=0, device=CPU)
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        full = tm.forward(cfg, params, {"tokens": toks}, q_chunk=16)
        cache = jax.tree_util.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype),
            tm.abstract_cache(cfg, B, S))
        for t in range(S):
            lg, cache = tm.decode_step(cfg, params, cache, {
                "tokens": toks[:, t:t + 1],
                "positions": torch.full((B,), t, dtype=torch.int32)})
    err = float((lg[:, 0] - full[:, -1])[..., :cfg.vocab].abs().max())
    assert err < 0.15, err


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_bit_equal(oracle, arch):
    cfg = cfg_of(arch)
    params = from_numpy_tree(tree_of(oracle, f"{arch}/bf16/params"), CPU)
    batch = batch_of(oracle, f"{arch}/bf16")
    ref = None
    for policy in ("none", "everything", "nothing", "dots"):
        loss, grads = step_lib.value_and_grad(
            lambda p, b: tm.loss_fn(cfg, p, b, remat_policy=policy,
                                    q_chunk=SHAPES["q_chunk"]), params, batch)
        got = (loss, dict(_flat(grads)))
        if ref is None:
            ref = got
            continue
        assert torch.equal(got[0], ref[0]), policy
        for name, g in got[1].items():
            assert torch.equal(g, ref[1][name]), (policy, name)


def test_train_step_matches_jax(oracle):
    arch = "mamba2-130m"
    cfg = cfg_of(arch)
    params = from_numpy_tree(tree_of(oracle, f"{arch}/bf16/params"), CPU)
    settings = step_lib.TrainSettings(lr=SHAPES["lr"],
                                      q_chunk=SHAPES["q_chunk"])
    state = step_lib.TrainState(params, adamw.adamw_init(params),
                                torch.zeros((), dtype=torch.int32))
    new, loss = step_lib.make_train_step(cfg, settings)(
        state, batch_of(oracle, f"{arch}/step"))
    assert abs(float(loss) - float(oracle[f"{arch}/step/loss"])) < 2e-2
    want = dict(leaves(tree_of(oracle, f"{arch}/step/params")))
    same = total = 0
    for name, p in _flat(new.params):
        w = bf16(want[name])
        assert (p.float() - w.float()).abs().max() < 2.5 * SHAPES["lr"], name
        same += int((p.view(torch.int16) == w.view(torch.int16)).sum())
        total += p.numel()
    assert same >= 0.99 * total, (same, total)


def test_trainer_matches_jax(oracle, tmp_path):
    arch = "mamba2-130m"
    tr_ = SHAPES["trainer"]
    cfg = get_arch(arch).reduced()
    params = from_numpy_tree(tree_of(oracle, f"{arch}/trainer/init"), CPU)
    tcfg = TrainerConfig(total_steps=tr_["steps"], ckpt_every=tr_["steps"],
                         ckpt_dir=str(tmp_path), warmup=tr_["warmup"],
                         seed=0)
    tr = Trainer(cfg, ShapeConfig("t", tr_["seq"], tr_["batch"], "train"),
                 step_lib.TrainSettings(lr=tr_["lr"],
                                        q_chunk=SHAPES["q_chunk"]),
                 tcfg, device=CPU, params=params)
    losses = tr.train()
    tr.close()
    want = oracle[f"{arch}/trainer/losses"]
    assert len(losses) == len(want) == tr_["steps"]
    np.testing.assert_allclose(losses, want, rtol=0, atol=2e-2)
