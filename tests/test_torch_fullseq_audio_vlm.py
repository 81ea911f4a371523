"""The full-sequence halves of the static-plane families, audio
(whisper-tiny reduced: 2 + 2 layers, 16 frames of 128) and vlm
(llama-3.2-vision-11b reduced: one macro-block of 4 self + 1 gated cross
layer, 16 patches of 128), held against the JAX package: the forward,
loss and gradients, each block on the JAX residual (the encoder's layers
too), `forward(return_cache=True)` and the first contiguous decode step
after it, one AdamW train step of whisper; in the port alone,
teacher-forced decode against the forward, the four remat policies and
the `Trainer`'s refusal of a stream without frames / patches.

Every JAX run happens in ONE child process (`torch_fullseq_oracle`, with
`XLA_FLAGS=--xla_allow_excess_precision=false`, ROADMAP condition (f));
the vlm cross gates are 0.5 in both packages (zero at init, the cross
layers would not count). The port runs its kernel routes' plain versions
(kernel 6 in the decode steps); JAX runs kv_impl="dequant".

The hand-off into a decode horizon: the self KV of the S prompt tokens
is copied into the first S slots of a zeroed `abstract_cache(cfg, B,
S + T)` tree (seq axis 2 at kv "normal", 3 when packed head-major); the
cross / patch KV is taken as it is.

Tolerances (`ref.rel_err`) as tests/test_torch_fullseq_ssm_hybrid.py's:
forward / loss / gradients float32 (1e-2, 1e-3, 1e-2) and bf16 (0.05,
2e-2, 0.05), the float32 tree float32 in every leaf (a vlm gate is a
bf16 scalar broadcast over the residual, whose gradient XLA sums in
bf16: 2.5% off the exact sum on 8192 terms, where torch's float
accumulation rounds it exactly); each block of a float32 tree on the JAX
residual cast to float32 < 1e-3; the vlm gates' gradients < 0.15 (each
is a sum over the (B, S, d) residual whose terms JAX adds in bf16, with
cancellation: 12.8% apart measured on gate_ffn of the float32 tree,
`test_gate_gradient_sum_is_rounded_in_bf16_by_jax`); the cache's bf16
leaves < 1e-2 and the port's pack of JAX's bf16 K / V equal to JAX's
packed bytes; the first decode step < 0.05; decode against forward
< 0.15; one AdamW step: loss |d| < 2e-2, every entry within 2.5 lr,
>= 99% bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.kernels.ref import rel_err
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models import vision as tv
from repro_torch.models.params import from_numpy_tree, init_params
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import Trainer, TrainerConfig
from torch_fullseq_oracle import GATE, leaves, run_child, tree_of

CPU = torch.device("cpu")
ARCHS = ("whisper-tiny", "llama-3.2-vision-11b")
DTYPES = ("f32", "bf16")
SHAPES = {"B": 2, "S": 32, "T": 4, "q_chunk": 16, "lr": 1e-3, "step_B": 4,
          "step_archs": ["whisper-tiny"], "trainer_archs": []}
EXTRA = {"audio": "frames", "vlm": "patches"}
GATE_TOL = 0.15     # the vlm gates' gradients (JAX sums them in bf16)


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
    return run_child(tmp_path_factory.mktemp("fullseq_audio_vlm"),
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


def batch_of(want: dict, prefix: str, cfg) -> dict:
    """tokens, targets and the family's frames / patches (bf16, as the
    JAX child passed them)."""
    b = {k: tensor(want[f"{prefix}/batch/{k}"])
         for k in ("tokens", "targets")}
    key = EXTRA[cfg.family]
    b[key] = torch.from_numpy(want[f"{prefix}/batch/{key}"]).bfloat16()
    return b


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_match_jax(oracle, arch, dtype):
    tag = f"{arch}/{dtype}"
    cfg = cfg_of(arch)
    params = from_numpy_tree(tree_of(oracle, f"{tag}/params"), CPU)
    batch = batch_of(oracle, tag, cfg)
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
    got = dict(_flat(grads))
    assert set(got) == set(want)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        assert g.dtype == params_dtype(params, name), name
        # a vlm gate multiplies a bf16 tensor as a bf16 scalar: XLA sums
        # its gradient's terms in bf16 (test_gate_gradient_sum below)
        t = GATE_TOL if name.startswith("blocks/cross/gate_") else tol[2]
        assert rel_err(f32(g), f32(want[name])) < t, name


def params_dtype(params: dict, name: str) -> torch.dtype:
    node = params
    for k in name.split("/"):
        node = node[k]
    return node.dtype


def port_blocks(cfg, params) -> list:
    """The port's blocks in the oracle's order, each a function of the
    JAX block's inputs (the residual; the cross blocks also the encoder
    states / the projected patches)."""
    q = SHAPES["q_chunk"]
    mlp = lambda p: (lambda x: tt.mlp_block(cfg, p, x, fixed_order=False,
                                            norm_fixed=False))
    pos = torch.arange(SHAPES["S"])
    out = []
    if cfg.family == "audio":
        F = cfg.encdec.n_frames
        fpos = torch.arange(F)
        for i in range(cfg.encdec.n_encoder_layers):
            lp = tt._layer_groups(params["encoder"], i)
            out += [lambda x, p=lp["attn"]: tt.attn_block(
                cfg, p, x, fpos, causal=False, q_chunk=F)[0], mlp(lp["mlp"])]
        out.append(lambda x: tl.rms_norm(x, params["enc_final_norm"],
                                         cfg.norm_eps, fixed_order=False))
        for i in range(cfg.n_layers):
            lp = tt._layer_groups(params["layers"], i)
            out += [lambda x, p=lp["attn"]: tt.attn_block(
                        cfg, p, x, pos, q_chunk=q)[0],
                    lambda x, enc, p=lp["cross"]: te.cross_block(
                        cfg, p, x, *te._enc_kv(cfg, p, enc)),
                    mlp(lp["mlp"])]
        return out
    for b in range(tv._n_blocks(cfg)):
        bp = tt._layer_groups(params["blocks"], b)
        for j in range(tv.N_SELF_PER_BLOCK):
            out += [lambda x, p=tt._layer(bp["self_attn"], j): tt.attn_block(
                        cfg, p, x, pos, q_chunk=q)[0],
                    mlp(tt._layer(bp["self_mlp"], j))]
        out += [lambda x, px, p=bp["cross"]: tv._cross_attn(
                    cfg, p, x, *tv._patch_kv(cfg, p, px), norm_fixed=False),
                mlp(bp["cross_mlp"])]
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
            ins = [tensor(oracle[f"{tag}/blocks/{i}/in{j}"]).float()
                   for j in range(2) if f"{tag}/blocks/{i}/in{j}" in oracle]
            got = fn(*ins)
            assert rel_err(f32(got), f32(oracle[f"{tag}/blocks/{i}/out"])) \
                < 1e-3, name


def into_horizon(cfg, cache: dict, B: int, S: int, T: int) -> dict:
    """The forward's cache with its self KV in the first S slots of a
    zeroed S + T decode cache."""
    full = {k: torch.zeros(s.shape, dtype=s.dtype)
            for k, s in tm.abstract_cache(cfg, B, S + T).items()}
    ax = 2 if cfg.amc.kv_mode == "normal" else 3
    for k, v in cache.items():
        if k.startswith(("cross", "patch")):
            full[k] = v
        else:
            full[k].narrow(ax, 0, S).copy_(v)
    return full


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_cache_and_handoff_match_jax(oracle, arch):
    """forward(return_cache=True) at the config's kv mode (whisper int8,
    vlm int4) and its first decode step over an S + T horizon; the port's
    pack of JAX's bf16 K / V (kv "normal") equals JAX's packed bytes."""
    cfg = cfg_of(arch)
    kv = cfg.amc.kv_mode
    params = from_numpy_tree(tree_of(oracle, f"{arch}/bf16/params"), CPU)
    batch = batch_of(oracle, f"{arch}/bf16", cfg)
    B, S = batch["tokens"].shape
    with torch.no_grad():
        _, cache = tm.forward(cfg, params, batch, return_cache=True,
                              remat_policy="none", q_chunk=SHAPES["q_chunk"])
        want = dict(leaves(tree_of(oracle, f"{arch}/cache/{kv}/tree")))
        assert set(cache) == set(want)
        for name, w in want.items():
            g = cache[name]
            assert tuple(g.shape) == w.shape, name
            if g.dtype in (torch.uint8, torch.int8):
                continue            # the packed self KV: held below
            assert rel_err(f32(g), f32(w)) < 1e-2, name
        normal = dict(leaves(tree_of(oracle, f"{arch}/cache/normal/tree")))
        pack = tl.pack_kv_int4 if kv == "int4" else tl.pack_kv_int8
        for k in ("k", "v"):
            q, s = pack(tl.to_kvmajor(tensor(normal[k])))
            np.testing.assert_array_equal(_bits(q), want[k])
            np.testing.assert_array_equal(_bits(s), want[f"{k}_scale"])
        full = into_horizon(cfg, cache, B, S, SHAPES["T"])
        lg, new = tm.decode_step(cfg, params, full, {
            "tokens": tensor(oracle[f"{arch}/cache/next"]),
            "positions": torch.full((B,), S, dtype=torch.int32)})
    assert set(new) == set(full)
    for k, v in new.items():
        assert v.shape == full[k].shape and v.dtype == full[k].dtype, k
    assert rel_err(lg.numpy()[..., :cfg.vocab],
                   oracle[f"{arch}/cache/{kv}/decode"]) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode from an empty self KV (the cross / patch KV
    of the forward) reproduces the forward's last logits at kv "normal"
    (tests/test_arch_smoke.py:110-131)."""
    cfg = cfg_of(arch, kv_mode="normal")
    params = init_params(cfg, seed=0, device=CPU)
    if cfg.family == "vlm":
        for g in ("gate_attn", "gate_ffn"):
            params["blocks"]["cross"][g].fill_(GATE)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32))}
    n, dim = ((cfg.encdec.n_frames, cfg.encdec.frame_dim) if cfg.encdec
              else (cfg.vision.n_patches, cfg.vision.vision_dim))
    batch[EXTRA[cfg.family]] = torch.from_numpy(rng.standard_normal(
        (B, n, dim)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        full, fc = tm.forward(cfg, params, batch, return_cache=True,
                              q_chunk=16)
        cache = {k: (v if k.startswith(("cross", "patch"))
                     else torch.zeros_like(v)) for k, v in fc.items()}
        for t in range(S):
            lg, cache = tm.decode_step(cfg, params, cache, {
                "tokens": batch["tokens"][:, t:t + 1],
                "positions": torch.full((B,), t, dtype=torch.int32)})
    err = float((lg[:, 0] - full[:, -1])[..., :cfg.vocab].abs().max())
    assert err < 0.15, err


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_bit_equal(oracle, arch):
    cfg = cfg_of(arch)
    params = from_numpy_tree(tree_of(oracle, f"{arch}/bf16/params"), CPU)
    batch = batch_of(oracle, f"{arch}/bf16", cfg)
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
    arch = "whisper-tiny"
    cfg = cfg_of(arch)
    params = from_numpy_tree(tree_of(oracle, f"{arch}/bf16/params"), CPU)
    settings = step_lib.TrainSettings(lr=SHAPES["lr"],
                                      q_chunk=SHAPES["q_chunk"])
    state = step_lib.TrainState(params, adamw.adamw_init(params),
                                torch.zeros((), dtype=torch.int32))
    new, loss = step_lib.make_train_step(cfg, settings)(
        state, batch_of(oracle, f"{arch}/step", cfg))
    assert abs(float(loss) - float(oracle[f"{arch}/step/loss"])) < 2e-2
    want = dict(leaves(tree_of(oracle, f"{arch}/step/params")))
    same = total = 0
    for name, p in _flat(new.params):
        w = bf16(want[name])
        assert (p.float() - w.float()).abs().max() < 2.5 * SHAPES["lr"], name
        same += int((p.view(torch.int16) == w.view(torch.int16)).sum())
        total += p.numel()
    assert same >= 0.99 * total, (same, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_refuses_stream_without_inputs(arch, tmp_path):
    """The Trainer's SyntheticLM stream carries no frames / patches (as
    the JAX Trainer's): it raises, naming the key."""
    cfg = get_arch(arch).reduced()
    key = EXTRA[cfg.family]
    with pytest.raises(ValueError, match=repr(key)):
        Trainer(cfg, ShapeConfig("t", 16, 2, "train"),
                step_lib.TrainSettings(q_chunk=16),
                TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path)),
                device=CPU)


def test_gate_gradient_sum_is_rounded_in_bf16_by_jax():
    """Why the gates' gradients get their own tolerance: the gradient of a
    bf16 scalar broadcast over a bf16 tensor, the vlm gate's form, is a
    sum of 8192 products that XLA adds in bf16 (flag or not), where
    torch's float accumulation gives the exact sum rounded once."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    m, w = (rng.standard_normal((2, 32, 128)) for _ in range(2))
    exact = float(np.sum(m.astype(np.float64) * w))
    jm_, jw = (jnp.asarray(a, jnp.bfloat16) for a in (m, w))
    exact_bf16 = float(np.sum(np.asarray(jm_, np.float64)
                              * np.asarray(jw, np.float64)))
    f = lambda g: jnp.sum((g * jm_).astype(jnp.float32)
                          * jw.astype(jnp.float32))
    got_jax = float(jax.jit(jax.grad(f))(jnp.asarray(0.5, jnp.bfloat16)))
    g = torch.tensor(0.5, dtype=torch.bfloat16, requires_grad=True)
    tm_, tw = (torch.from_numpy(a).bfloat16() for a in (m, w))
    ((g * tm_).float() * tw.float()).sum().backward()
    got = float(g.grad)
    assert got == float(torch.tensor(exact_bf16).bfloat16())
    assert abs(got_jax - exact_bf16) > 4 * abs(got - exact_bf16), (
        got_jax, got, exact_bf16, exact)


def test_train_step_splits_frames_into_microbatches():
    """`make_train_step` at grad_accum 2 carries the frames with their
    rows: its loss is the mean of the two half-batch losses, bit for
    bit."""
    cfg = get_arch("whisper-tiny").reduced()
    params = init_params(cfg, seed=1, device=CPU)
    e = cfg.encdec
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                                     dtype=torch.int32),
             "targets": torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                                      dtype=torch.int32),
             "frames": torch.randn((4, e.n_frames, e.frame_dim),
                                   generator=gen).bfloat16()}
    loss = lambda p, b: tm.loss_fn(cfg, p, b, remat_policy="nothing",
                                   q_chunk=16)
    halves = [step_lib.value_and_grad(loss, params, {
        k: t[i:i + 2] for k, t in batch.items()})[0] for i in (0, 2)]
    settings = step_lib.TrainSettings(lr=1e-3, q_chunk=16, grad_accum=2)
    state = step_lib.TrainState(params, adamw.adamw_init(params),
                                torch.zeros((), dtype=torch.int32))
    _, got = step_lib.make_train_step(cfg, settings)(state, batch)
    assert torch.equal(got, (halves[0] + halves[1]) / 2)
