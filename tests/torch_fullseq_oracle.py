"""The JAX side of tests/test_torch_fullseq_*.py, run in ONE child process
per test file (`run_child`), with `XLA_FLAGS=--xla_allow_excess_precision=
false` (so XLA's CPU compiler keeps the bf16 roundings the JAX source
writes, as the port does) and the TPUCompilerParams alias (no route used
here reaches a Pallas call: the JAX models run kv_impl="dequant").

`oracle(out_path, archs, shapes)` writes one .npz with, per reduced arch
(weight_mode "normal", kv_impl "dequant", the vlm gates set to 0.5 so the
cross layers count; a float32 tree is float32 in every leaf):
- `{arch}/{f32|bf16}/...`: the params, a batch, the forward's logits, the
  loss (remat "nothing") and every gradient leaf; at f32 also each
  block's input (the bf16 JAX residual) and its output on that input
  cast to float32 (`blocks/<i>/...`);
- `{arch}/cache/...`: `forward(return_cache=True)` at the config's kv
  mode and at kv "normal" (bf16 params), the logits of the first decode
  step after it (the audio / vlm self KV copied into the first S slots
  of a zeroed S + T cache, as the tests do for the port);
- `{arch}/step/...`: one AdamW `make_train_step` step (bf16 params);
- `{arch}/trainer/...`: the JAX `Trainer`'s losses on an Auto mesh (the
  families its stream serves);
- `ssd/...` and `lru/...`: `ssd_chunked` and `rec_block` alone with an
  initial state.
Leaves cross as numpy; bf16 as uint16.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GATE = 0.5          # the vlm cross gates (at their init, 0, a layer adds 0)


def oracle(out_path: str, archs: list, shapes: dict, tmp: str) -> None:
    import dataclasses
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import encdec, hybrid, ssm, vision
    from repro.models import layers as L
    from repro.models import model as M
    from repro.models import transformer as T
    from repro.models.params import init_params
    from repro.optim import adamw
    from repro.train import step as step_lib
    from repro.train.trainer import Trainer, TrainerConfig

    out = {}

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[f"{prefix}/{key}"] = bits(leaf)

    def cfg_of(arch, **amc):
        c = get_arch(arch).reduced()
        return dataclasses.replace(c, amc=dataclasses.replace(
            c.amc, weight_mode="normal", kv_impl="dequant", **amc))

    def params_of(cfg, dt=None, key=0):
        p = init_params(M.abstract_params(cfg), jax.random.PRNGKey(key),
                        dtype_override=dt)
        if dt is not None:
            # the zero-initialised leaves (norms, biases, gates) too: XLA
            # sums the gradient of a bf16 leaf broadcast over a tensor in
            # bf16 (a vlm gate's 8192 terms land 2.5% off the exact sum
            # where torch's float accumulation rounds it exactly)
            p = jax.tree.map(lambda a: a.astype(dt), p)
        if cfg.family == "vlm":
            cr = dict(p["blocks"]["cross"])
            for g in ("gate_attn", "gate_ffn"):
                cr[g] = jnp.full_like(cr[g], GATE)
            p = {**p, "blocks": {**p["blocks"], "cross": cr}}
        return p

    def batch_of(cfg, B, S, seed):
        rng = np.random.default_rng(seed)
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.encdec is not None:
            b["frames"] = rng.standard_normal(
                (B, cfg.encdec.n_frames, cfg.encdec.frame_dim)
            ).astype(np.float32)
        if cfg.vision is not None:
            b["patches"] = rng.standard_normal(
                (B, cfg.vision.n_patches, cfg.vision.vision_dim)
            ).astype(np.float32)
        return b

    def jbatch(b):
        return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
                else jnp.asarray(v) for k, v in b.items()}

    def blocks(cfg, p, b, prefix):
        """Each block's input and output on the JAX residual (f32 tree)."""
        S = b["tokens"].shape[1]
        qc = shapes["q_chunk"]
        pos = jnp.arange(S)
        x = jnp.take(p["embed"], b["tokens"], axis=0).astype(jnp.bfloat16)
        n = [0]

        jits = {}

        def rec(name, fn, lp, *xs):
            # the block on its inputs in float32: no bf16 rounding of its
            # own output (the residual it returns into stays bf16); one
            # compile a block function, its layer's params an argument
            run = jits.setdefault(fn, jax.jit(fn))
            y = run(lp, *(xi.astype(jnp.float32) for xi in xs))
            for j, xi in enumerate(xs):
                out[f"{prefix}/blocks/{n[0]}/in{j}"] = bits(xi)
            out[f"{prefix}/blocks/{n[0]}/out"] = bits(y)
            out[f"{prefix}/blocks/{n[0]}/name"] = np.array(name)
            n[0] += 1
            return y.astype(jnp.bfloat16)

        lay = lambda t, i: jax.tree.map(lambda a: a[i], t)
        mlp = lambda lp, x: T.mlp_block(cfg, lp, x)
        attn = lambda lp, x: T.attn_block(cfg, lp, x, pos, q_chunk=qc)[0]
        if cfg.family == "ssm":
            blk = lambda lp, x: ssm.block(cfg, lp, x)
            for i in range(cfg.n_layers):
                x = x + rec(f"ssm{i}", blk, lay(p["layers"], i), x)
        elif cfg.family == "hybrid":
            nb, tail = hybrid._layout(cfg)
            rblk = lambda lp, x: hybrid.rec_block(cfg, lp, x)
            wattn = lambda lp, x: T.attn_block(
                cfg, lp, x, pos, window=cfg.hybrid.window, q_chunk=qc)[0]
            for i in range(nb):
                bp = lay(p["blocks"], i)
                for r in ("rec_a", "rec_b"):
                    x = x + rec(f"{r}{i}", rblk, bp[r], x)
                    x = x + rec(f"{r}_mlp{i}", mlp, bp[r + "_mlp"], x)
                x = x + rec(f"attn{i}", wattn, bp["attn"], x)
                x = x + rec(f"attn_mlp{i}", mlp, bp["attn_mlp"], x)
            for i in range(tail):
                tp = lay(p["tail"], i)
                x = x + rec(f"tail{i}", rblk, tp["rec"], x)
                x = x + rec(f"tail_mlp{i}", mlp, tp["mlp"], x)
        elif cfg.family == "audio":
            fr = jnp.asarray(b["frames"], jnp.bfloat16)
            F = fr.shape[1]
            e = (fr @ p["frame_proj"]).astype(jnp.bfloat16)
            e = e + L.sinusoidal_positions(jnp.arange(F), cfg.d_model)[
                None].astype(e.dtype)
            fpos = jnp.arange(F)
            eattn = lambda lp, x: T.attn_block(cfg, lp, x, fpos,
                                               causal=False, q_chunk=F)[0]
            for i in range(cfg.encdec.n_encoder_layers):
                lp = lay(p["encoder"], i)
                e = e + rec(f"enc_attn{i}", eattn, lp["attn"], e)
                e = e + rec(f"enc_mlp{i}", mlp, lp["mlp"], e)
            enc = rec("enc_norm", lambda w, x: L.rms_norm(x, w, cfg.norm_eps),
                      p["enc_final_norm"], e)
            x = x + L.sinusoidal_positions(pos, cfg.d_model)[None].astype(
                x.dtype)
            cross = lambda lp, x, enc: encdec.cross_block(
                cfg, lp, x, *encdec._enc_kv(cfg, lp, enc))
            for i in range(cfg.n_layers):
                lp = lay(p["layers"], i)
                x = x + rec(f"attn{i}", attn, lp["attn"], x)
                x = x + rec(f"cross{i}", cross, lp["cross"], x, enc)
                x = x + rec(f"mlp{i}", mlp, lp["mlp"], x)
        else:   # vlm
            px = (jnp.asarray(b["patches"], jnp.bfloat16)
                  @ p["patch_proj"]).astype(jnp.bfloat16)
            cross = lambda lp, x, px: vision._cross_attn(
                cfg, lp, x, *vision._patch_kv(cfg, lp, px))
            for i in range(vision._n_blocks(cfg)):
                bp = lay(p["blocks"], i)
                for j in range(vision.N_SELF_PER_BLOCK):
                    x = x + rec(f"self{i}.{j}", attn,
                                lay(bp["self_attn"], j), x)
                    x = x + rec(f"self_mlp{i}.{j}", mlp,
                                lay(bp["self_mlp"], j), x)
                x = x + rec(f"cross{i}", cross, bp["cross"], x, px)
                g = jnp.tanh(bp["cross"]["gate_ffn"]).astype(x.dtype)
                x = x + g * rec(f"cross_mlp{i}", mlp, bp["cross_mlp"], x)

    B, S = shapes["B"], shapes["S"]
    for arch in archs:
        base = cfg_of(arch)
        b = batch_of(base, B, S, 1)
        jb = jbatch(b)
        for dt_name, dt in (("f32", jnp.float32), ("bf16", None)):
            tag = f"{arch}/{dt_name}"
            p = params_of(base, dt)
            put(f"{tag}/params", p)
            for k, v in b.items():
                out[f"{tag}/batch/{k}"] = v
            logits = jax.jit(lambda p, b: M.forward(
                base, p, b, q_chunk=shapes["q_chunk"]))(p, jb)
            out[f"{tag}/logits"] = np.asarray(logits)[..., :base.vocab]
            loss, grads = jax.jit(jax.value_and_grad(lambda p, b: M.loss_fn(
                base, p, b, remat_policy="nothing",
                q_chunk=shapes["q_chunk"])))(p, jb)
            out[f"{tag}/loss"] = np.asarray(loss)
            put(f"{tag}/grads", grads)
            if dt_name == "f32":
                blocks(base, p, b, tag)

        # the decode cache of the forward, at the config's kv mode and at
        # "normal", and the first decode step after it
        p = params_of(base)
        T_ = shapes["T"]
        nxt = jnp.asarray(np.random.default_rng(2).integers(
            0, base.vocab, (B, 1)).astype(np.int32))
        for kv in sorted({base.amc.kv_mode, "normal"}):
            cfg = cfg_of(arch, kv_mode=kv)
            lg, cache = jax.jit(lambda p, b: M.forward(
                cfg, p, b, return_cache=True, remat_policy="none",
                q_chunk=shapes["q_chunk"]))(p, jb)
            put(f"{arch}/cache/{kv}/tree", cache)
            if cfg.family in ("audio", "vlm"):
                full = jax.tree.map(
                    lambda l: jnp.zeros(l.shape, l.jdtype),
                    M.abstract_cache(cfg, ShapeConfig("d", S + T_, B,
                                                      "decode")),
                    is_leaf=lambda x: hasattr(x, "jdtype"))
                # seq axis: 2 seq-major (L, B, S, ...), 3 head-major
                ax = 2 if kv == "normal" else 3
                cache = {k: (v if k.startswith(("cross", "patch"))
                             else jax.lax.dynamic_update_slice_in_dim(
                                 full[k], v, 0, ax))
                         for k, v in cache.items()}
            lg1, _ = jax.jit(lambda p, c, b: M.decode_step(cfg, p, c, b))(
                p, cache, {"tokens": nxt,
                           "positions": jnp.full((B,), S, jnp.int32)})
            out[f"{arch}/cache/{kv}/decode"] = np.asarray(lg1)[..., :cfg.vocab]
        out[f"{arch}/cache/next"] = np.asarray(nxt)

        # one AdamW step
        if arch in shapes["step_archs"]:
            sb = batch_of(base, shapes["step_B"], S, 4)
            for k, v in sb.items():
                out[f"{arch}/step/batch/{k}"] = v
            settings = step_lib.TrainSettings(lr=shapes["lr"],
                                              q_chunk=shapes["q_chunk"])
            state = step_lib.TrainState(p, adamw.adamw_init(p),
                                        jnp.zeros((), jnp.int32))
            new, loss = jax.jit(step_lib.make_train_step(base, settings,
                                                         None))(state,
                                                                jbatch(sb))
            put(f"{arch}/step/params", new.params)
            out[f"{arch}/step/loss"] = np.asarray(loss)

        # the Trainer, on an Auto mesh
        if arch in shapes["trainer_archs"]:
            tr_ = shapes["trainer"]
            cfg = get_arch(arch).reduced()
            put(f"{arch}/trainer/init", init_params(
                M.abstract_params(cfg), jax.random.PRNGKey(0)))
            mesh = jax.make_mesh((1, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto, AxisType.Auto))
            tcfg = TrainerConfig(total_steps=tr_["steps"],
                                 ckpt_every=tr_["steps"],
                                 ckpt_dir=os.path.join(tmp, arch),
                                 warmup=tr_["warmup"], seed=0)
            tr = Trainer(cfg, ShapeConfig("t", tr_["seq"], tr_["batch"],
                                          "train"), mesh,
                         step_lib.TrainSettings(lr=tr_["lr"],
                                                q_chunk=shapes["q_chunk"]),
                         tcfg)
            out[f"{arch}/trainer/losses"] = np.asarray(tr.train(),
                                                       np.float64)
            tr.close()

    # the scans alone, from an initial state
    if "ssd" in shapes:
        sh = shapes["ssd"]
        rng = np.random.default_rng(5)
        Bs, Ss, H, P, N = sh["B"], sh["S"], sh["H"], sh["P"], sh["N"]
        ins = {"x": rng.standard_normal((Bs, Ss, H, P)),
               "a": -np.abs(rng.standard_normal((Bs, Ss, H))) * 0.3,
               "b": rng.standard_normal((Bs, Ss, H, N)),
               "c": rng.standard_normal((Bs, Ss, H, N)),
               "h0": rng.standard_normal((Bs, H, N, P))}
        for dt_name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            xs = {k: jnp.asarray(v, jnp.float32 if k in ("a", "h0") else dt)
                  for k, v in ins.items()}
            for k, v in xs.items():
                out[f"ssd/{dt_name}/in/{k}"] = bits(v)
            y, h = jax.jit(lambda x, a, b, c, h0: ssm.ssd_chunked(
                x, a, b, c, sh["chunk"], h0))(**xs)
            out[f"ssd/{dt_name}/y"] = bits(y)
            out[f"ssd/{dt_name}/h"] = bits(h)
    if "lru" in shapes:
        sh = shapes["lru"]
        cfg = cfg_of("recurrentgemma-9b")
        p = params_of(cfg, jnp.float32, key=7)
        lp = jax.tree.map(lambda a: a[0], p["blocks"]["rec_a"])
        rng = np.random.default_rng(6)
        x = jnp.asarray(rng.standard_normal((sh["B"], sh["S"], cfg.d_model)),
                        jnp.float32)
        h0 = jnp.asarray(rng.standard_normal((sh["B"],
                                              cfg.hybrid.lru_width)),
                         jnp.float32)
        y, h, conv = jax.jit(lambda x, h0: hybrid.rec_block(
            cfg, lp, x, h0=h0, return_state=True))(x, h0)
        put("lru/params", lp)
        out.update({"lru/x": bits(x), "lru/h0": bits(h0), "lru/y": bits(y),
                    "lru/h": bits(h), "lru/conv": bits(conv)})
    np.savez(out_path, **out)


CHILD = """
import json, sys
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
sys.path.insert(0, %r)
from torch_fullseq_oracle import oracle
oracle(**json.loads(sys.argv[1]))
"""


def run_child(tmp: Path, archs: list, shapes: dict) -> dict:
    """Runs `oracle` in a child process; returns the .npz as a dict."""
    args = {"out_path": str(tmp / "oracle.npz"), "archs": archs,
            "shapes": shapes, "tmp": str(tmp / "ckpt")}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-c", CHILD % str(Path(__file__).parent),
         json.dumps(args)], env=env, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(args["out_path"]))


def tree_of(want: dict, prefix: str) -> dict:
    """The numpy tree stored under `prefix/` (bf16 leaves as uint16)."""
    tree: dict = {}
    for key, a in want.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *parts, leaf = key[len(prefix) + 1:].split("/")
        for k in parts:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]
