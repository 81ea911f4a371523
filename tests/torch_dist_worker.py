"""The port's side of tests/test_torch_distributed.py: 4 ranks (gloo, on
the CPU) spawned from this script, one case a run.

    PYTHONPATH=src python tests/torch_dist_worker.py CASE OUT_DIR ORACLE.npz

CASE is one of
  train:NAME  the arch case NAME of CASES on a (2, 2) ("data", "model") mesh:
          the sharded loss and gradients against the port's unsharded
          ones, the AMC-Adam and AdamW updates of the sharded gradients
          against the unsharded updates of the same gradients, and 3
          steps of the sharded `Trainer` (the JAX oracle's initial
          parameters);
  ckpt    a 2x2 checkpoint restored by an unsharded Trainer, and an
          unsharded checkpoint restored by a 2x2 Trainer;
  steps   the sharded int4 chunked prefill -> decode steps against the
          unsharded ones (qwen; granite with one KV head, so its q heads
          shard while the KV replicates);
  coll    the compressed all-reduce over the pod axis of a (2, 2) ("pod",
          "data") mesh, on the oracle's per-pod gradients;
  pipe    `pipeline_forward` at 4, 2 and 1 stages on the oracle's inputs;
  card_train, card_steps  on one card, one NCCL rank (a 1-rank mesh):
          the sharded Trainer and the sharded contiguous int4 steps of
          reduced qwen against the unsharded ones (tests/test_torch_gpu.py).

Rank 0 writes OUT_DIR/result.pt (torch.save). The process group is
initialised through a file store in OUT_DIR; every rank is joined
within JOIN_TIMEOUT seconds or the run fails.
"""
import dataclasses
import os
import sys
import time
import traceback

import numpy as np

CASES = {   # name -> (arch, ModelConfig overrides of the reduced config)
    "qwen": ("qwen1.5-0.5b", {}),
    "qwen3moe": ("qwen3-moe-30b-a3b", {}),
    # one KV head: the q heads shard over "model", the KV replicates
    "granite": ("granite-3-2b", {"n_kv_heads": 1}),
    "mamba2": ("mamba2-130m", {}),
    "rgemma": ("recurrentgemma-9b", {}),
}
BATCH = {"B": 4, "S": 32, "q_chunk": 32, "seed": 1}
TRAINER = {"steps": 3, "lr": 5e-3, "warmup": 1}
COLL = {"seed": 3, "shape": (64, 256)}
PIPE = {"seed": 4, "n_micro": 3, "mb": 4, "d": 8}
STEPS = {"B": 4, "prompt": 16, "chunk": 8, "decode": 4, "seed": 5}
WORLD = 4
JOIN_TIMEOUT = 120


def batch_of(cfg) -> dict:
    rng = np.random.default_rng(BATCH["seed"])
    shape = (BATCH["B"], BATCH["S"])
    return {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, shape).astype(np.int32)}


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


# ---------------------------------------------------------------------------
# helpers of the ranks
# ---------------------------------------------------------------------------

def port_cfg(name: str):
    from repro_torch.configs import get_arch
    arch, kw = CASES[name]
    c = get_arch(arch).reduced()
    c = dataclasses.replace(c, amc=dataclasses.replace(
        c.amc, weight_mode="normal"))
    return dataclasses.replace(c, **kw)


def bf16_tree(tree, like):
    """numpy tree -> torch tree with `like`'s dtypes (bf16 leaves arrive
    as uint16 words)."""
    import torch
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = bf16_tree(v, like[k])
        elif like[k].dtype == torch.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy()).to(like[k].dtype)
    return out


def whole(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "device_mesh")
                    else t, tree)


def mesh22(names=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((2, 2), names, "cpu")


def rel_err(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_train(rank, out_dir, oracle, name):
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (Rules, dtensor_mode,
                                                  local_shard)
    from repro_torch.models import model as M
    from repro_torch.models.params import abstract_params, init_params
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten, tree_map
    mesh = mesh22()
    shape = ShapeConfig("t", BATCH["S"], BATCH["B"], "train")
    cfg = port_cfg(name)
    rules = Rules.make(mesh, cfg, shape)
    ap = abstract_params(cfg)
    like = init_params(cfg, seed=0, device="cpu")
    # the oracle's parameters, or (without one) the port's own draw
    params = (bf16_tree(tree_of(oracle, f"{name}/params"), like)
              if oracle else like)
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
    b_specs = step_lib.batch_pspecs(cfg, shape, rules)
    sb = {k: local_shard(v, mesh, b_specs[k]) for k, v in batch.items()}
    sp = step_lib.distribute(params, ap, rules)

    def loss(p, b, r):
        return M.loss_fn(cfg, p, b, rules=r, remat_policy="nothing",
                         q_chunk=BATCH["q_chunk"])
    with dtensor_mode(rules):
        s_loss, s_grads = step_lib.value_and_grad(
            lambda p, b: loss(p, b, rules), sp, sb)
    s_loss = float(s_loss.full_tensor())
    g_whole = whole(s_grads)
    u_loss, u_grads = step_lib.value_and_grad(
        lambda p, b: loss(p, b, None), params, batch)
    # the same on a float32 master tree (the residual stream stays
    # bf16): no gradient is rounded to bf16
    p32 = tree_map(lambda t: t.float(), params)
    with dtensor_mode(rules):
        s32_loss, s32 = step_lib.value_and_grad(
            lambda p, b: loss(p, b, rules),
            step_lib.distribute(p32, ap, rules), sb)
    u32_loss, u32 = step_lib.value_and_grad(
        lambda p, b: loss(p, b, None), p32, batch)
    # the optimizers on the sharded gradients vs the same gradients
    # whole: the moments byte for byte
    upd = {}
    for kind in ("adamw", "amc_adamw"):
        init, update = adamw.make_optimizer(kind)
        sp2 = step_lib.distribute(params, ap, rules)
        with dtensor_mode(rules):
            np_s, st_s = update(s_grads, init(sp2), sp2, lr=1e-3)
        p_u = tree_map(lambda t: t.clone(), params)
        np_u, st_u = update(g_whole, init(p_u), p_u, lr=1e-3)
        a = flatten(whole(st_s))[0] + flatten(whole(np_s))[0]
        b = flatten(st_u)[0] + flatten(np_u)[0]
        upd[kind] = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
    tr = Trainer(cfg, shape, step_lib.TrainSettings(
        lr=TRAINER["lr"], q_chunk=BATCH["q_chunk"]),
        TrainerConfig(total_steps=TRAINER["steps"], ckpt_every=100,
                      warmup=TRAINER["warmup"],
                      ckpt_dir=os.path.join(out_dir, f"ck_{name}")),
        device="cpu", params=params, mesh=mesh)
    t_losses = tr.train()
    tr.close()
    gl, _ = flatten(g_whole)
    ul, _ = flatten(u_grads)
    return {
        "loss_sharded": s_loss, "loss_unsharded": float(u_loss),
        "grad_err": [rel_err(a, b) for a, b in zip(gl, ul)],
        "grad_bit_equal": [bool(torch.equal(a, b))
                           for a, b in zip(gl, ul)],
        "f32_loss": (float(s32_loss.full_tensor()), float(u32_loss)),
        "f32_grad_err": [rel_err(a, b) for a, b in zip(
            flatten(whole(s32))[0], flatten(u32)[0])],
        "grads": g_whole, "updates_equal": upd,
        "trainer_losses": t_losses}


def case_ckpt(rank, out_dir, oracle):
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.step import TrainSettings
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import flatten
    cfg = port_cfg("qwen")
    shape = ShapeConfig("t", BATCH["S"], BATCH["B"], "train")
    mesh = mesh22()
    res = {}
    for opt in ("adamw", "amc_adamw"):
        st = TrainSettings(optimizer=opt, lr=TRAINER["lr"],
                           q_chunk=BATCH["q_chunk"])
        d_s = os.path.join(out_dir, f"sharded_{opt}")
        d_u = os.path.join(out_dir, f"unsharded_{opt}")
        tc = TrainerConfig(total_steps=2, ckpt_every=2, warmup=1,
                           ckpt_dir=d_s)
        tr = Trainer(cfg, shape, st, tc, device="cpu", mesh=mesh)
        tr.train()
        tr.close()
        sharded_state = flatten(whole(tr.state))[0]
        dist.barrier()
        # sharded -> unsharded: rank 0 resumes the 2x2 checkpoint alone
        if rank == 0:
            tu = Trainer(cfg, shape, st, tc, device="cpu")
            got = flatten(tu.state)[0]
            res[f"{opt}/to_unsharded"] = (
                tu.current_step(),
                [bool(torch.equal(a, b)) for a, b in
                 zip(got, sharded_state)])
            tu.close()
            # an unsharded run writes its own checkpoint
            tw = Trainer(cfg, shape, st, dataclasses.replace(
                tc, ckpt_dir=d_u), device="cpu")
            tw.train()
            tw.close()
            unsharded_state = flatten(tw.state)[0]
        dist.barrier()
        # unsharded -> sharded: every rank resumes it on the mesh
        ts = Trainer(cfg, shape, st, dataclasses.replace(tc, ckpt_dir=d_u),
                     device="cpu", mesh=mesh)
        got = flatten(whole(ts.state))[0]
        placed = all(hasattr(t, "device_mesh")
                     for t in flatten(ts.state.params)[0])
        ts.close()
        if rank == 0:
            res[f"{opt}/to_sharded"] = (
                ts.current_step(), placed,
                [bool(torch.equal(a, b)) for a, b in
                 zip(got, unsharded_state)])
    return res


def case_steps(rank, out_dir, oracle):
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import Rules, local_shard
    from repro_torch.models import model as M
    from repro_torch.models.params import abstract_params, init_params
    from repro_torch.train import step as step_lib
    mesh = mesh22()
    B, P, C, N = (STEPS["B"], STEPS["prompt"], STEPS["chunk"],
                  STEPS["decode"])
    res = {}
    for name in ("qwen", "granite"):
        base = port_cfg(name)
        cfg = dataclasses.replace(base, amc=dataclasses.replace(
            base.amc, kv_mode="int4", kv_impl="kernel"))
        shape = ShapeConfig("d", P + N, B, "decode")
        rules = Rules.make(mesh, cfg, shape)
        params = init_params(cfg, seed=0, device="cpu")
        sp = step_lib.distribute(params, abstract_params(cfg), rules)
        ac = M.abstract_cache(cfg, B, P + N)
        cache = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in ac.items()}
        scache = step_lib.distribute(cache, ac, rules)
        rng = np.random.default_rng(STEPS["seed"])
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P + N))
                                .astype(np.int32))
        def row(t):
            return local_shard(t, mesh, (rules.resolve("batch"),)
                               + (None,) * (t.ndim - 1))
        chunk_u, chunk_s = step_lib.make_chunk_step(cfg), \
            step_lib.make_chunk_step(cfg, rules)
        errs, equal = [], []
        for i in range(P // C):
            b = {"tokens": toks[:, i * C:(i + 1) * C],
                 "positions": torch.full((B,), i * C, dtype=torch.int32),
                 "write_mask": torch.ones(B, dtype=torch.bool)}
            lu, cache = chunk_u(params, cache, b)
            ls, scache = chunk_s(sp, scache, {k: row(v) for k, v in
                                              b.items()})
            ls = ls.full_tensor()
            errs.append(rel_err(ls[..., :cfg.vocab], lu[..., :cfg.vocab]))
            equal.append(float((ls == lu).float().mean()))
        dec_u, dec_s = step_lib.make_decode_step(cfg), \
            step_lib.make_decode_step(cfg, rules)
        for t in range(N):
            b = {"tokens": toks[:, P + t:P + t + 1],
                 "positions": torch.full((B,), P + t, dtype=torch.int32)}
            lu, cache = dec_u(params, cache, b)
            ls, scache = dec_s(sp, scache, {k: row(v) for k, v in
                                            b.items()})
            ls = ls.full_tensor()
            errs.append(rel_err(ls[..., :cfg.vocab], lu[..., :cfg.vocab]))
            equal.append(float((ls == lu).float().mean()))
        sc = whole(scache)
        res[name] = {"logit_err": errs, "logit_equal_share": equal,
                     "cache_equal_share": {
                         k: float((sc[k] == cache[k]).float().mean())
                         for k in cache},
                     "kv_heads": rules.resolve("kv_heads"),
                     "heads": rules.resolve("heads")}
    return res


def case_coll(rank, out_dir, oracle):
    import torch
    from repro_torch.distributed import collectives as C
    mesh = mesh22(("pod", "data"))
    pod = mesh.get_local_rank("pod")
    g = torch.from_numpy(oracle["coll/g"][pod])
    r = torch.from_numpy(oracle["coll/res"][pod])
    out, new_res = C.compressed_allreduce_mean(g, mesh.get_group("pod"), r)
    tree_fn = C.make_compressed_grad_allreduce(mesh, "pod")
    tout, tres = tree_fn({"a": g}, {"a": r})
    res = {"out_equal": bool(np.array_equal(out.numpy(),
                                            oracle["coll/out"][pod])),
           "res_equal": bool(np.array_equal(new_res.numpy(),
                                            oracle["coll/new_res"][pod])),
           "tree_equal": bool(torch.equal(tout["a"], out)
                              and torch.equal(tres["a"], new_res)),
           "data_axis_none": C.make_compressed_grad_allreduce(
               mesh, "model") is None}
    import torch.distributed as dist
    flags = torch.tensor([res["out_equal"], res["res_equal"],
                          res["tree_equal"]], dtype=torch.int32)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    res["all_ranks"] = flags.tolist()
    return res


def case_pipe(rank, out_dir, oracle):
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_mesh
    xs = torch.from_numpy(oracle["pipe/xs"])
    res = {}
    for n, shape, names in ((4, (4,), ("pod",)),
                            (2, (2, 2), ("pod", "data")),
                            (1, (1, 4), ("pod", "data"))):
        mesh = make_mesh(shape, names, "cpu")
        w = torch.from_numpy(oracle[f"pipe/{n}/w"])
        fn = pipeline_forward(mesh, lambda p, x: torch.tanh(x @ p),
                              n_micro=PIPE["n_micro"])
        y = fn(w, xs)
        direct = xs
        for s in range(n):
            direct = torch.tanh(direct @ w[s])
        e_jax = float(np.abs(y.numpy() - oracle[f"pipe/{n}/out"]).max())
        e_dir = float((y - direct).abs().max())
        worst = torch.tensor([e_jax, e_dir], dtype=torch.float64)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        res[n] = {"vs_jax": float(worst[0]), "vs_direct": float(worst[1])}
    return res


def card_mesh():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((1, 1), ("data", "model"), "cuda")


def case_card_train(rank, out_dir, oracle):
    """On one card, a 1-rank NCCL mesh: 5 steps of the sharded Trainer
    (reduced qwen) against the unsharded Trainer from the same
    parameters and batches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.params import init_params
    from repro_torch.train.step import TrainSettings
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_map
    cfg = port_cfg("qwen")
    shape = ShapeConfig("t", 64, 4, "train")
    params = init_params(cfg, seed=0, device="cuda")
    out = {}
    for tag, mesh in (("unsharded", None), ("sharded", card_mesh())):
        tr = Trainer(cfg, shape, TrainSettings(lr=TRAINER["lr"], q_chunk=64),
                     TrainerConfig(total_steps=5, ckpt_every=100, warmup=1,
                                   ckpt_dir=os.path.join(out_dir, tag)),
                     params=tree_map(lambda t: t.clone(), params), mesh=mesh)
        out[tag] = tr.train()
        if mesh is not None:
            from repro_torch.tree import flatten
            out["placed"] = all(hasattr(t, "device_mesh")
                                for t in flatten(tr.state.params)[0])
        tr.close()
    return out


def case_card_steps(rank, out_dir, oracle):
    """On one card, a 1-rank NCCL mesh: the int4 chunked prefill and the
    decode steps of reduced qwen through the sharded steps (kernels 3
    and 6 on the local shards) against the unsharded steps, with the
    launches of each sharded dispatch."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import Rules, local_shard
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.params import abstract_params, init_params
    from repro_torch.train import step as step_lib
    mesh = card_mesh()
    base = port_cfg("qwen")
    cfg = dataclasses.replace(base, amc=dataclasses.replace(
        base.amc, kv_mode="int4", kv_impl="kernel"))
    B, P, C, N = (STEPS["B"], STEPS["prompt"], STEPS["chunk"],
                  STEPS["decode"])
    rules = Rules.make(mesh, cfg, ShapeConfig("d", P + N, B, "decode"))
    params = init_params(cfg, seed=0, device="cuda")
    sp = step_lib.distribute(params, abstract_params(cfg), rules)
    ac = M.abstract_cache(cfg, B, P + N)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype, device="cuda")
             for k, s in ac.items()}
    scache = step_lib.distribute(cache, ac, rules)
    g = torch.Generator(device="cuda").manual_seed(STEPS["seed"])
    toks = torch.randint(0, cfg.vocab, (B, P + N), generator=g,
                         device="cuda", dtype=torch.int32)
    def row(t):
        return local_shard(t, mesh, (rules.resolve("batch"),)
                           + (None,) * (t.ndim - 1))
    out = {"errs": [], "equal": [], "k3": [], "k6": [], "other": []}

    def one(fn_u, fn_s, b, key):
        nonlocal cache, scache
        lu, cache = fn_u(params, cache, b)
        ops.reset_launch_counts()
        ls, scache = fn_s(sp, scache, {k: row(v) for k, v in b.items()})
        counts = ops.launch_counts()
        out[key].append(counts["quantize_pack_kv" if key == "k3"
                               else "packed_kv_attention"])
        out["other"].append(sum(counts.values()) - out[key][-1])
        ls = ls.to_local()
        out["errs"].append(rel_err(ls[..., :cfg.vocab], lu[..., :cfg.vocab]))
        out["equal"].append(bool(torch.equal(ls, lu)))
    with torch.no_grad():
        for i in range(P // C):
            one(step_lib.make_chunk_step(cfg),
                step_lib.make_chunk_step(cfg, rules),
                {"tokens": toks[:, i * C:(i + 1) * C],
                 "positions": torch.full((B,), i * C, dtype=torch.int32,
                                         device="cuda")}, "k3")
        for t in range(N):
            one(step_lib.make_decode_step(cfg),
                step_lib.make_decode_step(cfg, rules),
                {"tokens": toks[:, P + t:P + t + 1],
                 "positions": torch.full((B,), P + t, dtype=torch.int32,
                                         device="cuda")}, "k6")
    out["n_layers"] = cfg.n_layers
    return out


CASE_FNS = {"train": case_train, "ckpt": case_ckpt, "steps": case_steps,
            "coll": case_coll, "pipe": case_pipe,
            "card_train": case_card_train, "card_steps": case_card_steps}


def _world(case: str):
    """(ranks, backend): the card cases run one NCCL rank."""
    return (1, "nccl") if case.startswith("card") else (WORLD, "gloo")


def _rank(rank, case, out_dir, oracle_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    world, backend = _world(case)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        out_dir, "store"), rank=rank, world_size=world)
    try:
        oracle = dict(np.load(oracle_path)) if oracle_path else {}
        case, *arg = case.split(":")
        res = CASE_FNS[case](rank, out_dir, oracle, *arg)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "result.pt"))
        dist.barrier()
    except Exception:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def main(case, out_dir, oracle_path=None):
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_rank, args=(case, out_dir, oracle_path),
                             nprocs=_world(case)[0], join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            sys.exit(f"{case}: ranks not joined within {JOIN_TIMEOUT} s")


if __name__ == "__main__":
    main(*sys.argv[1:])
