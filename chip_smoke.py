"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Phases (one line each, a failing phase exits nonzero):
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the kernel library from src/repro_torch/kernels/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card
              at the main path's full-width shapes, with its time beside
              the plain version's, a one-call library yardstick that the
              port never calls, and the card's bound for the same work;
  4. main     full-width qwen1.5-0.5b (random ternary weights from a
              seed) served by `ServeEngine` at kv_mode int8 and int4:
              8 requests, 48-200 prompt tokens, 32 new tokens each, with
              every kernel's launch count read around the run and the
              first prefill chunk / decode step held against the plain
              path's logits.
The second-to-last lines are the kernels JSON and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [DIR]

profiles the main path at full width instead (device time by kernel and
the device's busy share of a prefill and a decode window; the profiler
tables are written to DIR, default profile_out/).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
KERNEL_ROWS = {
    "ternary_matmul": ("src/repro_torch/kernels/csrc/ternary_matmul.cu",
                       "src/repro/kernels/ternary_matmul.py:64"),
    "paged_kv_attention": ("src/repro_torch/kernels/csrc/paged_kv_attention.cu",
                           "src/repro/kernels/paged_kv_attention.py:103"),
    "quantize_pack_kv": ("src/repro_torch/kernels/csrc/quantize_pack_kv.cu",
                         "src/repro/kernels/quantize_pack_kv.py:87"),
}


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def time_ms(fn, arg_sets, iters: int = 40) -> float:
    """Mean DEVICE time of one fn(*args) call: `iters` calls captured in a
    CUDA graph and replayed between two events, so host-side launch cost
    (Python, argument checks) is not counted. Calls rotate over
    `arg_sets`, copies together larger than the 50 MB L2, so each call
    finds its operands cold, as the main path's layer loop does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up off the capture
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOP_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def copies_for(nbytes_one: int, target: int = 96 << 20, cap: int = 64) -> int:
    return int(min(cap, max(2, target // max(nbytes_one, 1))))


# ---------------------------------------------------------------------------
# phase 1 / 2
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    from repro_torch.device import resolve_device
    resolve_device("cuda")          # pins full-precision f32 matmuls
    name = torch.cuda.get_device_name(0)
    say("device", name=repr(name), count=torch.cuda.device_count(),
        nvidia_smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda)
    return name, smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.library()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        library=path.name)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def check_ternary(gen) -> dict:
    from repro_torch.kernels.ternary_matmul import (ternary_matmul_cuda,
                                                    ternary_matmul_plain)
    from repro_torch.core.ternary import unpack_ternary_2bit
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0}
    for M in (4, 4 * 32):
        for K, N in ((1024, 1024), (1024, 2816), (2816, 1024)):
            n_copy = copies_for(K * N // 4)
            sets = []
            for _ in range(n_copy):
                w = torch.randint(0, 3, (K // 4, N, 4), generator=gen,
                                  device=dev, dtype=torch.uint8)
                w = w[..., 0] | (w[..., 1] << 2) | (w[..., 2] << 4) \
                    | (w[..., 3] << 6)
                scale = torch.rand((1, N), generator=gen, device=dev) * 0.05
                x = torch.randn((M, K), generator=gen, device=dev
                                ).to(torch.bfloat16)
                sets.append((x, w.contiguous(), scale))
            x, w, scale = sets[0]
            got = ternary_matmul_cuda(x, w, scale)
            want = ternary_matmul_plain(x, w, scale)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            row["max_abs_err"] = max(row["max_abs_err"], max_abs(got, want))
            if not err < 1e-2:
                raise AssertionError(f"ternary_matmul M={M} K={K} N={N} "
                                     f"rel_err={err}")
            dense = [(x_, (unpack_ternary_2bit(w_, K).float() * s_
                           ).to(torch.bfloat16)) for x_, w_, s_ in sets]
            ms = time_ms(ternary_matmul_cuda, sets)
            plain_ms = time_ms(ternary_matmul_plain, sets)
            lib_ms = time_ms(torch.matmul, dense)
            b_ms, b_by = bound_ms(M * K * 2 + K * N / 4 + N * 4 + M * N * 2,
                                  2 * M * K * N)
            say("kernel", name="ternary_matmul", M=M, K=K, N=N,
                rel_err=f"{err:.3e}", ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                bound_ms=f"{b_ms:.5f}", bound_by=b_by)
            if (M, K, N) == (4, 1024, 2816):   # the decode MLP up/gate shape
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"M={M} K={K} N={N}")
    for M in (1, 8, 9, 40):                    # path edges and ragged tiles
        x = torch.randn((M, 1024), generator=gen, device=dev
                        ).to(torch.bfloat16)
        w = torch.randint(0, 256, (256, 1024), generator=gen, device=dev,
                          dtype=torch.uint8)
        w = torch.where((w & 3) == 3, w ^ 1, w)   # digit 3 is not a trit
        scale = torch.rand((1, 1024), generator=gen, device=dev)
        err = rel_err(ternary_matmul_cuda(x, w, scale),
                      ternary_matmul_plain(x, w, scale))
        if not err < 1e-2:
            raise AssertionError(f"ternary_matmul M={M} rel_err={err}")
    return row


def _pool(gen, B, KV, D, page, maxP, kv_bits, lengths):
    """A mixed Normal/Augmented pool with random contents and tables."""
    dev = torch.device("cuda")
    Nn = Np = B * maxP + 1
    d_store = D // 2 if kv_bits == 4 else D
    kn = torch.randn((Nn, KV, page, D), generator=gen, device=dev
                     ).to(torch.bfloat16)
    vn = torch.randn((Nn, KV, page, D), generator=gen, device=dev
                     ).to(torch.bfloat16)
    if kv_bits == 4:
        kp = torch.randint(0, 256, (Np, KV, page, d_store), generator=gen,
                           device=dev, dtype=torch.uint8)
        vp = torch.randint(0, 256, (Np, KV, page, d_store), generator=gen,
                           device=dev, dtype=torch.uint8)
        smax = 1.0 / 7
    else:
        kp = torch.randint(-127, 128, (Np, KV, page, d_store), generator=gen,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (Np, KV, page, d_store), generator=gen,
                           device=dev, dtype=torch.int8)
        smax = 1.0 / 127
    ks = (torch.rand((Np, KV, page), generator=gen, device=dev) * 2 * smax
          ).to(torch.bfloat16)
    vs = (torch.rand((Np, KV, page), generator=gen, device=dev) * 2 * smax
          ).to(torch.bfloat16)
    modes = torch.randint(0, 2, (B, maxP), generator=gen, device=dev,
                          dtype=torch.int32)
    perm_n = torch.randperm(Nn - 1, generator=gen, device=dev)[:B * maxP] + 1
    perm_p = torch.randperm(Np - 1, generator=gen, device=dev)[:B * maxP] + 1
    table = torch.where(modes == 1, perm_p.view(B, maxP),
                        perm_n.view(B, maxP)).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return kn, vn, kp, vp, ks, vs, lens, table, modes


def _attention_bytes_ops(B, KV, Hg, D, page, maxP, kv_bits, lens, modes):
    """Bytes the function must move and operations it must do for THIS
    run's lengths: the pages each row holds, read once in their plane."""
    d_store = D // 2 if kv_bits == 4 else D
    n_bytes = 2 * B * KV * Hg * D * 2 + B * 4 + 2 * B * maxP * 4
    n_ops = 0
    for b in range(B):
        n_len = min(int(lens[b]), maxP * page)
        npg = max(-(-n_len // page), 1)
        for p in range(npg):
            per_tok = (2 * D * 2) if int(modes[b, p]) == 0 \
                else (2 * d_store + 2 * 2)
            n_bytes += KV * page * per_tok
        n_ops += 4 * KV * Hg * D * n_len
    return n_bytes, n_ops


def check_attention(gen) -> dict:
    from repro_torch.kernels.paged_kv_attention import (
        paged_gather_kv, paged_kv_attention_cuda, paged_kv_attention_plain)
    dev = torch.device("cuda")
    B, KV, D, page, maxP = 4, 16, 64, 16, 32
    lengths = [1, maxP * page, 200, 77]
    row = {"max_abs_err": 0.0}
    for kv_bits in (8, 4):
        for Hg in (1, 4):
            pool = _pool(gen, B, KV, D, page, maxP, kv_bits, lengths)
            n_copy = copies_for(sum(t.numel() * t.element_size()
                                    for t in pool[:6]) // 4)
            sets = []
            for i in range(n_copy):
                q = torch.randn((B, KV, Hg, D), generator=gen, device=dev
                                ).to(torch.bfloat16)
                sets.append((q,) + (pool if i == 0 else
                                    tuple(t.clone() for t in pool[:6])
                                    + pool[6:]))
            args = sets[0]
            got = paged_kv_attention_cuda(*args, kv_bits=kv_bits)
            want = paged_kv_attention_plain(*args, kv_bits=kv_bits)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            row["max_abs_err"] = max(row["max_abs_err"], max_abs(got, want))
            if not err < 0.03:
                raise AssertionError(f"paged_kv_attention kv_bits={kv_bits} "
                                     f"Hg={Hg} rel_err={err}")

            def library(q, kn, vn, kp, vp, ks, vs, lens, table, modes,
                        Hg=Hg, kv_bits=kv_bits):
                k, v = paged_gather_kv(kn, vn, kp, vp, ks, vs, table, modes,
                                       kv_bits=kv_bits)
                k = k.to(torch.bfloat16).repeat_interleave(Hg, dim=1)
                v = v.to(torch.bfloat16).repeat_interleave(Hg, dim=1)
                mask = (torch.arange(k.shape[2], device=dev)[None, :]
                        < lens[:, None])[:, None, None, :]
                return torch.nn.functional.scaled_dot_product_attention(
                    q.reshape(B, KV * Hg, 1, D), k, v, attn_mask=mask)

            ms = time_ms(lambda *a: paged_kv_attention_cuda(
                *a, kv_bits=kv_bits), sets)
            plain_ms = time_ms(lambda *a: paged_kv_attention_plain(
                *a, kv_bits=kv_bits), sets)
            lib_ms = time_ms(library, sets)
            n_bytes, n_ops = _attention_bytes_ops(
                B, KV, Hg, D, page, maxP, kv_bits, lengths, args[9].cpu())
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            say("kernel", name="paged_kv_attention", kv_bits=kv_bits, Hg=Hg,
                B=B, KV=KV, D=D, lengths=",".join(map(str, lengths)),
                rel_err=f"{err:.3e}", ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                bound_ms=f"{b_ms:.6f}", bound_by=b_by)
            if (kv_bits, Hg) == (8, 1):        # the main path's default
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"B={B} KV={KV} Hg={Hg} D={D} page={page} "
                                 f"kv_bits=8 lengths={lengths}")
    return row


def check_pack(gen) -> dict:
    from repro_torch.kernels.quantize_pack_kv import (quantize_pack_kv_cuda,
                                                      quantize_pack_kv_plain)
    dev = torch.device("cuda")
    D = 64
    row = {"max_abs_err": 0.0}
    # rows: one decode step (4 x 16 heads), one prefill chunk (4 x 32 x 16),
    # one page of every layer (24 x 16 x 16, the augment page op)
    for N in (4 * 16, 4 * 32 * 16, 24 * 16 * 16):
        sets = []
        for _ in range(copies_for(N * D * 2)):
            x = (torch.randn((N, D), generator=gen, device=dev)
                 * torch.rand((N, 1), generator=gen, device=dev) * 8)
            x[: N // 16] = torch.round(x[: N // 16] * 2) / 2   # half ties
            x[0] = 0.0                                          # amax == 0
            sets.append((x.to(torch.bfloat16),))
        (x,) = sets[0]
        p, s = quantize_pack_kv_cuda(x)
        pw, sw = quantize_pack_kv_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(p, pw) and torch.equal(s, sw)):
            raise AssertionError(
                f"quantize_pack_kv N={N}: {(p != pw).sum().item()} bytes, "
                f"{(s != sw).sum().item()} scales differ")
        ms = time_ms(quantize_pack_kv_cuda, sets)
        plain_ms = time_ms(quantize_pack_kv_plain, sets)
        b_ms, b_by = bound_ms(N * D * 2 + N * D // 2 + N * 4, 6 * N * D)
        say("kernel", name="quantize_pack_kv", N=N, D=D, bytes_equal=True,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            bound_ms=f"{b_ms:.6f}", bound_by=b_by)
        if N == 4 * 32 * 16:
            row.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by, shape=f"N={N} D={D}")
    return row


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def first_step_logits_check(cfg, params, kv_mode: str, gen) -> float:
    """The first prefill chunk and first decode step at full width, once
    through the kernels and once through the plain versions, each on its
    own copy of a freshly admitted pool. Returns the worse rel_err."""
    from repro_torch.models import model as M
    from repro_torch.serve.cache_pool import PagedKVPool
    dev = torch.device("cuda")
    kcfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode=kv_mode))
    pcfg = dataclasses.replace(kcfg, amc=dataclasses.replace(
        kcfg.amc, matmul_impl="dense", kv_impl="dequant"))
    B, C = 4, 32
    pool = PagedKVPool(kcfg, max_batch=B, max_seq=512, device=dev)
    for r in range(B):
        pool.admit_row(r, C + 1, step=0)
    tables = pool.device_tables()
    arenas_k = pool.arenas
    arenas_p = {k: v.clone() for k, v in arenas_k.items()}
    tokens = torch.randint(0, cfg.vocab, (B, C), generator=gen, device=dev,
                           dtype=torch.int32)
    batch = {"tokens": tokens,
             "positions": torch.zeros(B, dtype=torch.int32, device=dev),
             "write_mask": torch.ones(B, dtype=torch.bool, device=dev),
             **tables}
    V = cfg.vocab       # padded vocab columns hold -1e30 on both paths
    with torch.no_grad():
        lk, _ = M.paged_prefill_step(kcfg, params, arenas_k, batch)
        lp, _ = M.paged_prefill_step(pcfg, params, arenas_p, batch)
        e_prefill = rel_err(lk[..., :V], lp[..., :V])
        nxt = lp[:, -1].argmax(-1).to(torch.int32)[:, None]
        batch = {"tokens": nxt,
                 "positions": torch.full((B,), C, dtype=torch.int32,
                                         device=dev),
                 "write_mask": torch.ones(B, dtype=torch.bool, device=dev),
                 **tables}
        dk, _ = M.paged_decode_step(kcfg, params, arenas_k, batch)
        dp, _ = M.paged_decode_step(pcfg, params, arenas_p, batch)
        e_decode = rel_err(dk[..., :V], dp[..., :V])
    say("logits", kv_mode=kv_mode, prefill_rel_err=f"{e_prefill:.3e}",
        decode_rel_err=f"{e_decode:.3e}")
    if not (e_prefill < 0.05 and e_decode < 0.05):
        raise AssertionError(f"first-step logits disagree ({kv_mode}): "
                             f"prefill {e_prefill}, decode {e_decode}")
    return max(e_prefill, e_decode)


def phase_main(name: str, smi: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import Request, ServeEngine

    class TimedEngine(ServeEngine):
        """Synchronised host clock around each prompt's prefill; decode
        time is the rest of the run."""
        prefill_s = 0.0
        prefill_tokens = 0

        def prefill(self, slot, tokens, return_next=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().prefill(slot, tokens, return_next)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0
            self.prefill_tokens += len(tokens)
            return out

    cfg = get_arch("qwen1.5-0.5b")
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    gc.collect()                    # drop phase 3's operands and graphs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(dense_cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    launches = {k: 0 for k in ops.KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for kv_mode in ("int8", "int4"):
        eng = TimedEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, params=params, kv_mode=kv_mode)
        params = eng.params                   # packed once, reused
        if kv_mode == "int8":
            say("setup", params_s=round(time.perf_counter() - t0, 3),
                weight_bytes=eng.stats()["weight_bytes_physical"])
        reqs = [Request(prompt=p, max_new_tokens=32, id=i)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        out = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if sorted(out) != list(range(8)) or \
                any(len(out[i]) != 32 for i in range(8)):
            raise AssertionError(f"not every request completed: "
                                 f"{ {k: len(v) for k, v in out.items()} }")
        need = ["ternary_matmul", "paged_kv_attention"] \
            + (["quantize_pack_kv"] if kv_mode == "int4" else [])
        if any(counts[k] == 0 for k in need):
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{counts}")
        for k in launches:
            launches[k] += counts[k]
        decode_s = wall - eng.prefill_s
        st = eng.stats()
        say("main", kv_mode=kv_mode, requests=len(out),
            new_tokens=sum(map(len, out.values())),
            prefill_tokens=eng.prefill_tokens,
            prefill_tok_s=round(eng.prefill_tokens / eng.prefill_s, 3),
            decode_tok_s=round(256 / decode_s, 3),
            wall_s=round(wall, 3), steps=eng.step_idx,
            dispatches=eng.dispatch_count,
            preemptions=st["preemptions"], refreshes=st["refreshes"],
            augment_events=st["augment_events"],
            pool_mode=st["pool"]["pool_mode"],
            peak_mem_gib=round(peak / 2**30, 3),
            allocated_before_gib=round(base / 2**30, 3),
            launches=json.dumps(counts), card=repr(smi))
        # the plain path on the same card: greedy agreement (reported,
        # not asserted: near-ties of random full-width weights may flip)
        pcfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, matmul_impl="dense", kv_impl="dequant"))
        peng = ServeEngine(pcfg, device="cuda", max_batch=4, max_seq=512,
                           prefill_chunk=32, params=params, kv_mode=kv_mode)
        pout = peng.generate([Request(prompt=p, max_new_tokens=32, id=i)
                              for i, p in enumerate(prompts)])
        agree = np.mean([a == b for i in range(8)
                         for a, b in zip(out[i], pout[i])])
        say("agreement", kv_mode=kv_mode,
            greedy_token_agreement=round(float(agree), 4))
        first_step_logits_check(cfg, params, kv_mode, gen)
        del eng, peng
        torch.cuda.empty_cache()
    return launches


def phase_profile(out_dir: Path) -> None:
    """torch.profiler over the main path at full width (int8, the config
    default): one 128-token prompt's prefill (4 chunks) and 16 batched
    decode steps of 4 rows. Prints device time by kernel and the device's
    busy share of each window; full tables go to `out_dir`."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.serve import Request, ServeEngine
    cfg = get_arch("qwen1.5-0.5b")
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, seed=0)
    from torch.autograd import DeviceType
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=129).astype(np.int32)
               for _ in range(4)]
    for i in range(2):           # warm-up: allocator, cuBLAS handles, library
        eng.add_request(Request(prompt=prompts[i], max_new_tokens=128, id=i))
    for _ in range(4):
        eng.step_all()
    out_dir.mkdir(parents=True, exist_ok=True)
    next_id = iter(range(2, 4))

    def window(label, fn):
        """The window once on the host clock without the profiler, then
        once more under it for device time by kernel; busy share = device
        time / unprofiled wall time."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        dev_us = {e.key: e.self_device_time_total for e in avgs
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0}
        busy = sum(dev_us.values()) / 1e6
        table = avgs.table(sort_by="self_device_time_total", row_limit=40)
        (out_dir / f"profile_{label}.txt").write_text(table)
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        say("profile", window=label, units=n, wall_ms=round(wall * 1e3, 3),
            device_busy_ms=round(busy * 1e3, 3),
            device_busy_share=round(busy / wall, 4),
            kernels_per_unit=round(sum(e.count for e in avgs
                                       if e.device_type == DeviceType.CUDA)
                                   / n, 1),
            top=json.dumps({k[:60]: round(v / 1e3, 3) for k, v in top}))

    def prefill_one():
        i = next(next_id)
        eng.add_request(Request(prompt=prompts[i], max_new_tokens=128, id=i))
        return 4                       # ceil(128 / 32) chunks

    def decode_16():
        for _ in range(16):
            eng.step_all()
        return 16

    window("prefill", prefill_one)
    window("decode", decode_16)


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--profile"]:
        phase_device()
        phase_build()
        phase_profile(Path(args[1] if len(args) > 1 else "profile_out"))
        return
    name, smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"ternary_matmul": check_ternary(gen),
            "paged_kv_attention": check_attention(gen),
            "quantize_pack_kv": check_pack(gen)}
    launches = phase_main(name, smi)
    kernels = []
    for k, row in rows.items():
        src, replaces = KERNEL_ROWS[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "shape": row["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
