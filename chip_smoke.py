"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Phases (one line each, a failing phase exits nonzero):
  1. device   the card's name and power limit (nvidia-smi);
  2. build    the kernel library from src/repro_torch/kernels/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card
              at the main paths' full-width shapes, with its time beside
              the plain version's, a one-call library yardstick that the
              port never calls, and the card's bound for the same work;
              the paged reads at qwen's and granite's decode shapes, each
              beside its chunks a row and CTAs; every window slot
              bit-identical to the decode kernel (also at minitron-8b's
              widths, 64 (slot, head) rows a CTA); every row of
              the fixed-order GEMMs (ternary_matmul, dense_matmul) the
              same bits at every row count; the fused paged KV write at
              qwen's decode and prefill shapes (int8, int4) and granite's
              verify and commit shapes, every arena page >= 1 bit for bit
              against its plain version under each pool policy, beside
              the scatter it replaced and the kernels that scatter
              launched;
  4. main     two models served by `ServeEngine`, random weights from a
              seed, 8 requests, 48-200 prompt tokens, 32 new tokens each,
              every kernel's launch count read around each run and the
              first prefill chunk / decode step held against the plain
              path's logits:
              - full-width qwen1.5-0.5b (ternary weights) at kv_mode int8
                and int4, and at spec_k=4 (kv int8), whose tokens must
                equal the stepwise int8 run's on 8/8 requests;
              - full-width granite-3-2b (dual-plane int4 weights, int4 KV,
                GQA 32/8) at spec_k=4 (self-speculative: dequant draft,
                window verify, masked commit) and at spec_k=1, the
                speculative tokens equal to the stepwise ones on 8/8;
              - qwen at kv int4 under augment-on-pressure with a budget
                of 24 Normal pages: pages of both planes, cold Normal
                pages augmented in place through quantize_pack_kv;
  5. imc      in-memory compute on the same requests and weights:
              - qwen1.5-0.5b with every projection in the array
                (matmul_impl="imc", 8-bit activations, kv int4): the IMC
                kernel launched, the ternary matmul never; first prefill
                chunk / decode step against a CPU twin (the same step on
                CPU copies of params and pool), rel_err vs the packed
                route, greedy agreement and energy per token vs phase 4's
                int4 run;
              - granite-3-2b at spec_k=4 with a 4-bit IMC draft
                (spec_draft_impl="imc4") and a 1-bit one (imc1, whose
                rejected drafts drive page retraction on the card), each
                emitting the stepwise tokens on 8/8 requests: the first
                imc4 draft decode step against its CPU twin, the "draft"
                energy group.
  6. hybrid   full-width recurrentgemma-9b (38 layers, RG-LRU + local
              attention, MQA 16/1, hd=256, dense bf16 weights, int4 ring
              KV over a 2048-slot window) on `AugmentedStatePool` slabs,
              4 requests of 12-40 prompt tokens (prefilled token by
              token) and 16 new tokens each: the packed_kv_attention
              kernel 12 times a dispatch; the first decode step after a
              32-token stepwise prefill through the kernel route against
              the plain route on the card (the prefill steps' worst
              reported); the reduced config (16-slot ring, prompts past
              it) on the card against the CPU.
Nine kernels were redesigned for the card: the int4 pack and its masked
store-back are one fused paged KV write a layer (K and V, the page
lookup, the write and commit masks and the stores into the arena views
in one launch; int8 too), and the standalone packs run its row routine;
packed_kv_attention splits the sequence into 64-token chunks, one CTA
each, runs both products on bf16 tensor-core MMAs and merges the chunks'
partials in a second kernel;
paged_kv_attention and paged_kv_attention_window are one split-page
kernel of the same design over the two-plane page pool (chunks of whole
pages, from the page size alone, so each window slot keeps the decode
read's bits);
imc_dot and imc_dual_dot are one launch a call at M <= 16, the quantize
fused in and K split over a thread-block cluster planned from (K, N)
alone, int32 partials added through distributed shared memory (exact, so
every split gives the plain version's bits); prefill keeps the quantize
prepass and the tiles;
dual_plane_matmul keeps its float64 GEMV for decode (M <= 4) and runs
float64 tensor-core (DMMA) tiles for verify and prefill, with K split
across CTAs where the tiles alone do not fill the card (exact sums, so
every route gives the plain version's bits); ternary_matmul is one
fixed-order bf16 tensor-core kernel for every M, its K split taken from
(K, N) alone, and dense_matmul, the same kernel over bf16 weights, serves
the projections augmented storage leaves dense and the tied head in
decode steps and verify windows, so a verify window's rows get the bits
of the decode steps it replaces. dense_matmul has no TPU kernel: its
JSON row names the JAX package's XLA product as `replaces`.
Phase 3 also checks the masked pack and the fused-integrity pack, which
no serving path launches (the fused write took in the first; the JAX
package calls the second from none): their JSON rows show 0 launches.
The second-to-last lines are the kernels JSON and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [DIR]

profiles the main paths at full width instead (device time by kernel and
the device's busy share of qwen's prefill, decode and IMC decode windows,
of granite's stepwise decode and speculative rounds with the dequant and
the imc4 draft, and of recurrentgemma's decode; the profiler tables are
written to DIR, default profile_out/).
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
INT8_OP_PER_S = 1979e12         # dense int8 tensor-core peak (2 ops a MAC)
F64_TC_FLOP_PER_S = 67e12       # dense float64 tensor-core peak (DMMA)
KERNEL_ROWS = {
    "ternary_matmul": ("src/repro_torch/kernels/csrc/ternary_matmul.cu",
                       "src/repro/kernels/ternary_matmul.py:64"),
    # a port-only kernel (no TPU kernel): `replaces` names the XLA product
    # of the JAX package that computes the same function
    "dense_matmul": ("src/repro_torch/kernels/csrc/ternary_matmul.cu",
                     "src/repro/models/augment.py:124"),
    "paged_kv_attention": ("src/repro_torch/kernels/csrc/paged_kv_attention.cu",
                           "src/repro/kernels/paged_kv_attention.py:103"),
    "quantize_pack_kv": ("src/repro_torch/kernels/csrc/quantize_pack_kv.cu",
                         "src/repro/kernels/quantize_pack_kv.py:87"),
    "quantize_pack_kv_masked": (
        "src/repro_torch/kernels/csrc/quantize_pack_kv.cu",
        "src/repro/kernels/quantize_pack_kv.py:70"),
    "dual_plane_matmul": ("src/repro_torch/kernels/csrc/dual_plane_matmul.cu",
                          "src/repro/kernels/dual_plane_matmul.py:63"),
    "paged_kv_attention_window": (
        "src/repro_torch/kernels/csrc/paged_kv_attention.cu",
        "src/repro/kernels/paged_kv_attention.py:231"),
    "imc_dot": ("src/repro_torch/kernels/csrc/imc_dot.cu",
                "src/repro/kernels/imc_dot.py:180"),
    "imc_dual_dot": ("src/repro_torch/kernels/csrc/imc_dot.cu",
                     "src/repro/kernels/imc_dot.py:216"),
    "packed_kv_attention": (
        "src/repro_torch/kernels/csrc/packed_kv_attention.cu",
        "src/repro/kernels/packed_kv_attention.py:128"),
    "quantize_pack_kv_integrity": (
        "src/repro_torch/kernels/csrc/quantize_pack_kv.cu",
        "src/repro/kernels/quantize_pack_kv.py:49"),
    # kernels 3 and 3b with the scatter around them (which XLA fuses into
    # the JAX package's step): bodies :34 and :70 of the same function
    "paged_kv_write": ("src/repro_torch/kernels/csrc/quantize_pack_kv.cu",
                       "src/repro/kernels/quantize_pack_kv.py:87"),
}
# kernels no serving path launches, checked and timed, launches 0: the
# masked pack, whose store-back the fused paged write took in (the
# copy-on-write page op, not yet ported, will call it), and the fused
# integrity pack (the JAX package calls it from no serving path either)
OFF_PATH = ("quantize_pack_kv_masked", "quantize_pack_kv_integrity")


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def raw(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits: bf16 as int16 (so -0.0 != 0.0)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


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


def clocks_under(fn, arg_sets, seconds: float = 2.0) -> dict:
    """`time_ms` over and over for `seconds` while nvidia-smi samples the
    SM clock every 50 ms: the spread of one shape's time beside the clocks
    it ran at (MHz; the card's maximum last)."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,"
                            "clocks.max.sm", "--format=csv,noheader,"
                            "nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    times = []
    try:
        stop = time.perf_counter() + seconds
        while time.perf_counter() < stop:
            times.append(time_ms(fn, arg_sets))
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    mhz = [[int(v) for v in line.split(",")] for line in out.splitlines()
           if line.replace(",", "").replace(" ", "").isdigit()]
    return {"ms_min": f"{min(times):.5f}", "ms_max": f"{max(times):.5f}",
            "replays": len(times),
            "sm_mhz": (f"{min(m for m, _ in mhz)}-{max(m for m, _ in mhz)}"
                       f"/{mhz[-1][1]}" if mhz else "not read")}


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
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

def _trits(gen, K, N):
    """Random (K/4, N) packed trits on the card."""
    w = torch.randint(0, 3, (K // 4, N, 4), generator=gen,
                      device=torch.device("cuda"), dtype=torch.uint8)
    return (w[..., 0] | (w[..., 1] << 2) | (w[..., 2] << 4)
            | (w[..., 3] << 6)).contiguous()


def rows_independent_of_m(fn, x: torch.Tensor) -> bool:
    """Every row of fn(x[:m]) equals its row of fn(x) (x has 160 rows)
    bit for bit at M = 1, 4, 5, 8, 9, 16, 17, 128, 129 (the row tiles'
    edges), and a shuffled call gives the shuffled rows."""
    full = fn(x)
    same = all(torch.equal(fn(x[:m].contiguous()), full[:m])
               for m in (1, 4, 5, 8, 9, 16, 17, 128, 129))
    perm = torch.randperm(x.shape[0], device=x.device)
    return same and torch.equal(fn(x[perm].contiguous()), full[perm])


def check_ternary(gen) -> dict:
    """qwen's shapes (K, N) = (1024, 1024) wq..wo, (1024, 2816) gate/up,
    (2816, 1024) w_down at decode (M=4) and prefill (M=128), against the
    plain version (rel_err < 0.01) and `torch.matmul` on the dequantized
    bf16 weights; every row's bits independent of M at each shape. The
    JSON row is the decode gate/up shape; "shapes" holds the prefill
    w_down shape (the two table shapes of PERF.md)."""
    from repro_torch.kernels.ternary_matmul import (split_plan,
                                                    ternary_matmul_cuda,
                                                    ternary_matmul_plain)
    from repro_torch.core.ternary import unpack_ternary_2bit
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0, "shapes": []}
    for K, N in ((1024, 1024), (1024, 2816), (2816, 1024)):
        w = _trits(gen, K, N)
        scale = torch.rand((1, N), generator=gen, device=dev) * 0.05
        x = torch.randn((160, K), generator=gen, device=dev
                        ).to(torch.bfloat16)
        if not rows_independent_of_m(
                lambda a: ternary_matmul_cuda(a, w, scale), x):
            raise AssertionError(f"ternary_matmul K={K} N={N}: a row's "
                                 f"bits depend on M")
    for M in (4, 4 * 32):
        for K, N in ((1024, 1024), (1024, 2816), (2816, 1024)):
            n_copy = copies_for(K * N // 4)
            sets = []
            for _ in range(n_copy):
                w = _trits(gen, K, N)
                scale = torch.rand((1, N), generator=gen, device=dev) * 0.05
                x = torch.randn((M, K), generator=gen, device=dev
                                ).to(torch.bfloat16)
                sets.append((x, w, scale))
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
            del dense
            b_ms, b_by = bound_ms(M * K * 2 + K * N / 4 + N * 4 + M * N * 2,
                                  2 * M * K * N)
            say("kernel", name="ternary_matmul", M=M, K=K, N=N,
                splits=split_plan(K, N), rel_err=f"{err:.3e}",
                rows_independent_of_m=True, ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                bound_ms=f"{b_ms:.5f}", bound_by=b_by)
            shape = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"M={M} K={K} N={N}")
            if (M, K, N) == (4, 1024, 2816):   # the decode MLP up/gate shape
                row.update(shape)
            elif (M, K, N) == (128, 2816, 1024):   # prefill w_down
                row["shapes"].append(shape)
    for M in (1, 8, 9, 40):                    # ragged row tiles
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


def check_dense(gen) -> dict:
    """The port's bf16 GEMM at the shapes it serves: granite's w_down
    (K=8192, N=2048, "kn") and wq/wo (2048, 2048), and the tied heads read
    from the embedding ("nk": qwen K=1024 N=151936, granite K=2048
    N=49408), at decode (M=4), verify (M=16) and prefill (M=128); within
    2^-7 of `torch.matmul` (its plain version, which is also the library
    yardstick: two f32 sums rounded to bf16 may land one ulp apart) and
    every row's bits independent of M. The JSON row is granite's decode
    w_down; "shapes" holds the others."""
    from repro_torch.kernels.ternary_matmul import (dense_matmul_cuda,
                                                    dense_matmul_plain,
                                                    split_plan)
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0, "shapes": []}
    cases = [("kn", 8192, 2048), ("kn", 2048, 2048), ("nk", 1024, 151936),
             ("nk", 2048, 49408)]
    for layout, K, N in cases:
        shape_w = (K, N) if layout == "kn" else (N, K)
        nbytes = K * N * 2
        ws = [(torch.randn(shape_w, generator=gen, device=dev) / K ** 0.5
               ).to(torch.bfloat16) for _ in range(copies_for(nbytes))]
        x = torch.randn((160, K), generator=gen, device=dev
                        ).to(torch.bfloat16)
        if not rows_independent_of_m(
                lambda a: dense_matmul_cuda(a, ws[0], layout), x):
            raise AssertionError(f"dense_matmul {layout} K={K} N={N}: a "
                                 f"row's bits depend on M")
        for M in (4, 16, 128):
            sets = [(torch.randn((M, K), generator=gen, device=dev
                                 ).to(torch.bfloat16), w) for w in ws]
            got = dense_matmul_cuda(*sets[0], layout)
            want = dense_matmul_plain(*sets[0], layout)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            row["max_abs_err"] = max(row["max_abs_err"], max_abs(got, want))
            if not err < 2 ** -7:
                raise AssertionError(f"dense_matmul {layout} M={M} K={K} "
                                     f"N={N}: rel_err={err}")
            ms = time_ms(lambda a, b: dense_matmul_cuda(a, b, layout), sets)
            plain_ms = time_ms(lambda a, b: dense_matmul_plain(a, b, layout),
                               sets)
            lib_ms = time_ms(torch.matmul, [(a, b.T if layout == "nk" else b)
                                            for a, b in sets])
            b_ms, b_by = bound_ms(M * K * 2 + nbytes + M * N * 2,
                                  2 * M * K * N)
            say("kernel", name="dense_matmul", layout=layout, M=M, K=K, N=N,
                splits=split_plan(K, N), rel_err=f"{err:.3e}",
                rows_independent_of_m=True, ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                library=repr("torch.matmul (cuBLAS)"),
                bound_ms=f"{b_ms:.5f}", bound_by=b_by)
            shape = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"{layout} M={M} K={K} N={N}")
            if (layout, M, K) == ("kn", 4, 8192):
                row.update(shape)
            else:
                row["shapes"].append(shape)
        del ws, sets
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


def split_grid(B, KV, W, Hg, page, maxP) -> dict:
    """The split-page kernels' grid, from shapes alone: chunks a row and
    CTAs launched. Printed beside the times; not part of the JSON row."""
    from repro_torch.kernels.paged_kv_attention import (chunk_plan,
                                                        window_plan)
    nc = -(-maxP // chunk_plan(page))
    return {"chunks_per_row": nc,
            "ctas": B * KV * nc * -(-W // window_plan(W, Hg))}


def check_attention(gen) -> dict:
    """qwen's decode read (B=4, KV=16, Hg=1 and a GQA Hg=4, kv 8 and 4)
    and granite's (KV=8, Hg=4, int4), lengths 1 / 512 / 200 / 77 over
    mixed pages. The JSON row is qwen's int8 read; "shapes" holds the
    others."""
    from repro_torch.kernels.paged_kv_attention import (
        paged_gather_kv, paged_kv_attention_cuda, paged_kv_attention_plain)
    dev = torch.device("cuda")
    D, page, maxP = 64, 16, 32
    lengths = [1, maxP * page, 200, 77]
    B = len(lengths)
    row = {"max_abs_err": 0.0, "shapes": []}
    for KV, Hg, kv_bits in ((16, 1, 8), (16, 4, 8), (16, 1, 4), (16, 4, 4),
                            (8, 4, 4)):
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
            raise AssertionError(f"paged_kv_attention KV={KV} Hg={Hg} "
                                 f"kv_bits={kv_bits} rel_err={err}")

        def library(q, kn, vn, kp, vp, ks, vs, lens, table, modes,
                    Hg=Hg, KV=KV, kv_bits=kv_bits):
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
        grid = split_grid(B, KV, 1, Hg, page, maxP)
        say("kernel", name="paged_kv_attention", kv_bits=kv_bits, Hg=Hg,
            B=B, KV=KV, D=D, lengths=",".join(map(str, lengths)),
            rel_err=f"{err:.3e}", **grid, ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
            bound_ms=f"{b_ms:.6f}", bound_by=b_by)
        shape = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by,
                     shape=f"B={B} KV={KV} Hg={Hg} D={D} page={page} "
                           f"kv_bits={kv_bits} lengths={lengths}")
        if (KV, Hg, kv_bits) == (16, 1, 8):    # the main path's default
            row.update(shape)
        else:
            row["shapes"].append(shape)
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


def check_dual(gen) -> dict:
    """granite's dual buffers: wkv (K=2048, N=512) and w_gate_up
    (K=2048, N=8192) at decode (M=4, the GEMV), verify (M=16, 16-row
    float64 tensor-core tiles) and prefill (M=128, 128-row tiles), each
    bit-identical to the plain version; and a row's bits independent of M
    across every route boundary (M = 1, 4 | 5, 16 | 17, 128 | 129 against
    one M=160 call). The JSON row is the decode gate/up shape; "shapes"
    holds the others. The printed line also gives `dmma_floor_ms`, the
    float64 tensor-core floor of the same multiply-adds (the sums must be
    exact, `csrc` header); it is worked out, not measured, so the JSON row
    leaves it out."""
    from repro_torch.kernels.dual_plane_matmul import (
        dual_plane_matmul_cuda, dual_plane_matmul_plain, k_split)
    from repro_torch.core.quant import unpack_int4_hi, unpack_int4_lo
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0, "shapes": []}
    for K, N in ((2048, 512), (2048, 8192)):
        x = torch.randn((160, K), generator=gen, device=dev
                        ).to(torch.bfloat16)
        buf = torch.randint(0, 256, (K, N), generator=gen, device=dev,
                            dtype=torch.uint8)
        hs = torch.rand((1, N), generator=gen, device=dev) * 0.05
        ls = torch.rand((1, N), generator=gen, device=dev) * 0.05
        full = dual_plane_matmul_cuda(x, buf, hs, ls)
        for m in (1, 4, 5, 16, 17, 128, 129):
            part = dual_plane_matmul_cuda(x[:m].contiguous(), buf, hs, ls)
            if not all(torch.equal(a, b[:m]) for a, b in zip(part, full)):
                raise AssertionError(f"dual_plane_matmul K={K} N={N}: rows "
                                     f"of an M={m} call differ from M=160")
        if not all(torch.equal(a, b) for a, b in
                   zip(full, dual_plane_matmul_plain(x, buf, hs, ls))):
            raise AssertionError(f"dual_plane_matmul M=160 K={K} N={N}: "
                                 f"not bit-identical to the plain version")
    for M in (4, 16, 128):
        for K, N in ((2048, 512), (2048, 8192)):
            sets = []
            for _ in range(copies_for(K * N)):
                buf = torch.randint(0, 256, (K, N), generator=gen,
                                    device=dev, dtype=torch.uint8)
                hs = torch.rand((1, N), generator=gen, device=dev) * 0.05
                ls = torch.rand((1, N), generator=gen, device=dev) * 0.05
                x = torch.randn((M, K), generator=gen, device=dev
                                ).to(torch.bfloat16)
                sets.append((x, buf, hs, ls))
            got = dual_plane_matmul_cuda(*sets[0])
            want = dual_plane_matmul_plain(*sets[0])
            torch.cuda.synchronize()
            err = max(rel_err(a, b) for a, b in zip(got, want))
            bits_equal = all(torch.equal(a, b) for a, b in zip(got, want))
            row["max_abs_err"] = max(row["max_abs_err"],
                                     *(max_abs(a, b)
                                       for a, b in zip(got, want)))
            if not bits_equal:
                raise AssertionError(f"dual_plane_matmul M={M} K={K} N={N} "
                                     f"not bit-identical: rel_err={err}")
            # yardstick: two products on the dequantized bf16 planes
            planes = [(x_, (unpack_int4_hi(b_).float() * h_
                            ).to(torch.bfloat16),
                       (unpack_int4_lo(b_).float() * l_).to(torch.bfloat16))
                      for x_, b_, h_, l_ in sets]
            ms = time_ms(dual_plane_matmul_cuda, sets)
            plain_ms = time_ms(dual_plane_matmul_plain, sets)
            lib_ms = time_ms(lambda x_, h_, l_: (torch.matmul(x_, h_),
                                                 torch.matmul(x_, l_)),
                             planes)
            n_ops = 2 * 2 * M * K * N
            b_ms, b_by = bound_ms(M * K * 2 + K * N + 2 * N * 4
                                  + 2 * M * N * 2, n_ops)
            floor_ms = n_ops / F64_TC_FLOP_PER_S * 1e3
            # the prefill tile's time moved between calls: read its spread
            # beside the SM clocks under sustained float64 tensor-core load
            held = (clocks_under(dual_plane_matmul_cuda, sets)
                    if (M, N) == (128, 8192) else {})
            say("kernel", name="dual_plane_matmul", M=M, K=K, N=N,
                ksplit=k_split(M, K, N)[0],
                rel_err=f"{err:.3e}", bits_equal=bits_equal, ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                bound_ms=f"{b_ms:.5f}", bound_by=b_by,
                dmma_floor_ms=f"{floor_ms:.5f}", **held)
            shape = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"M={M} K={K} N={N}")
            if (M, K, N) == (4, 2048, 8192):   # the decode gate/up shape
                row.update(shape)
            else:
                row["shapes"].append(shape)
    return row


def _window_bytes_ops(B, KV, W, Hg, D, page, maxP, kv_bits, starts, modes):
    """Bytes and operations of one window read for THIS run's starts: the
    pages up to each row's last slot, read once, and each slot's scores
    and PV products over its own horizon."""
    d_store = D // 2 if kv_bits == 4 else D
    n_bytes = 2 * B * KV * W * Hg * D * 2 + B * 4 + 2 * B * maxP * 4
    n_ops = 0
    for b in range(B):
        horizons = [min(int(starts[b]) + w + 1, maxP * page)
                    for w in range(W)]
        for p in range(-(-horizons[-1] // page)):
            per_tok = (2 * D * 2) if int(modes[b, p]) == 0 \
                else (2 * d_store + 2 * 2)
            n_bytes += KV * page * per_tok
        n_ops += 4 * KV * Hg * D * sum(horizons)
    return n_bytes, n_ops


def check_window(gen) -> dict:
    """granite's verify read (B=4, KV=8, W=4, Hg=4, D=64) at kv 8 and 4,
    and minitron-8b's widths at spec_k=16 (W=16, Hg=4, D=128: 64 (slot,
    head) rows, four MMA row tiles a CTA), over mixed pages, starts spread
    over the cache; each slot must equal the decode kernel at
    starts + w + 1 bit for bit (max_abs == 0). The JSON row is granite's
    int4 read; "shapes" holds the others."""
    from repro_torch.kernels.paged_kv_attention import (
        paged_gather_kv, paged_kv_attention_cuda,
        paged_kv_attention_window_cuda, paged_kv_attention_window_plain)
    dev = torch.device("cuda")
    B, KV, page, maxP = 4, 8, 16, 32
    row = {"max_abs_err": 0.0, "shapes": []}
    for W, Hg, D, kv_bits in ((4, 4, 64, 8), (4, 4, 64, 4),
                              (16, 4, 128, 4)):
        starts = [0, 150, 333, maxP * page - W]
        pool = _pool(gen, B, KV, D, page, maxP, kv_bits, starts)
        sets = []
        for i in range(copies_for(sum(t.numel() * t.element_size()
                                      for t in pool[:6]) // 4)):
            q = torch.randn((B, KV, W, Hg, D), generator=gen, device=dev
                            ).to(torch.bfloat16)
            sets.append((q,) + (pool if i == 0 else
                                tuple(t.clone() for t in pool[:6])
                                + pool[6:]))
        args = sets[0]
        st = args[7]
        got = paged_kv_attention_window_cuda(*args, kv_bits=kv_bits)
        slot_abs = 0.0
        for w in range(W):
            one = paged_kv_attention_cuda(args[0][:, :, w], *args[1:7],
                                          st + w + 1, *args[8:],
                                          kv_bits=kv_bits)
            slot_abs = max(slot_abs, max_abs(got[:, :, w], one))
        want = paged_kv_attention_window_plain(*args, kv_bits=kv_bits)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        row["max_abs_err"] = max(row["max_abs_err"], max_abs(got, want))
        if slot_abs != 0.0:
            raise AssertionError(f"window slot differs from the decode "
                                 f"kernel (kv_bits={kv_bits}): max_abs "
                                 f"{slot_abs}")
        if not err < 0.03:
            raise AssertionError(f"paged_kv_attention_window "
                                 f"kv_bits={kv_bits} rel_err={err}")

        def library(q, kn, vn, kp, vp, ks, vs, st, table, modes,
                    kv_bits=kv_bits):
            k, v = paged_gather_kv(kn, vn, kp, vp, ks, vs, table, modes,
                                   kv_bits=kv_bits)
            k = k.to(torch.bfloat16).repeat_interleave(Hg, dim=1)
            v = v.to(torch.bfloat16).repeat_interleave(Hg, dim=1)
            horizon = st[:, None] + torch.arange(1, W + 1, device=dev)
            mask = (torch.arange(k.shape[2], device=dev)[None, None, :]
                    < horizon[:, :, None])[:, None]       # (B, 1, W, S)
            qh = q.permute(0, 1, 3, 2, 4).reshape(B, KV * Hg, W, D)
            return torch.nn.functional.scaled_dot_product_attention(
                qh, k, v, attn_mask=mask)

        ms = time_ms(lambda *a: paged_kv_attention_window_cuda(
            *a, kv_bits=kv_bits), sets)
        plain_ms = time_ms(lambda *a: paged_kv_attention_window_plain(
            *a, kv_bits=kv_bits), sets)
        lib_ms = time_ms(library, sets)
        n_bytes, n_ops = _window_bytes_ops(B, KV, W, Hg, D, page, maxP,
                                           kv_bits, starts, args[9].cpu())
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        grid = split_grid(B, KV, W, Hg, page, maxP)
        say("kernel", name="paged_kv_attention_window", kv_bits=kv_bits,
            B=B, KV=KV, W=W, Hg=Hg, D=D, starts=",".join(map(str, starts)),
            slot_max_abs_vs_decode=slot_abs, rel_err=f"{err:.3e}", **grid,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{lib_ms:.5f}", bound_ms=f"{b_ms:.6f}",
            bound_by=b_by)
        shape = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by,
                     shape=f"B={B} KV={KV} W={W} Hg={Hg} D={D} page={page} "
                           f"kv_bits={kv_bits} starts={starts}")
        if (W, kv_bits) == (4, 4):            # granite's KV mode
            row.update(shape)
        else:
            row["shapes"].append(shape)
    return row


def check_masked_pack(gen) -> dict:
    """The verify commit's store-back: one layer's window rows of granite
    (4 rows x 4 slots x 8 KV heads) and a larger batch, about half the
    rows rejected."""
    from repro_torch.kernels.quantize_pack_kv import (
        quantize_pack_kv_masked_cuda, quantize_pack_kv_plain)
    dev = torch.device("cuda")
    D = 64
    row = {"max_abs_err": 0.0}
    for N in (4 * 4 * 8, 4 * 32 * 16):
        sets = []
        for _ in range(copies_for(N * D * 2)):
            x = (torch.randn((N, D), generator=gen, device=dev)
                 * torch.rand((N, 1), generator=gen, device=dev) * 8)
            x[0] = 0.0
            valid = torch.rand((N,), generator=gen, device=dev) < 0.5
            valid[0] = True                 # a kept all-zero row
            sets.append((x.to(torch.bfloat16), valid))
        x, valid = sets[0]
        p, s = quantize_pack_kv_masked_cuda(x, valid)
        pw, sw = quantize_pack_kv_plain(x, valid)
        torch.cuda.synchronize()
        if not (torch.equal(p, pw) and torch.equal(s, sw)):
            raise AssertionError(
                f"quantize_pack_kv_masked N={N}: {(p != pw).sum().item()} "
                f"bytes, {(s != sw).sum().item()} scales differ")
        if p[~valid].any() or not bool((s[~valid] == 1.0).all()):
            raise AssertionError("rejected rows must give 0 bytes, scale 1")
        ms = time_ms(quantize_pack_kv_masked_cuda, sets)
        plain_ms = time_ms(quantize_pack_kv_plain, sets)
        kept = int(valid.sum())
        b_ms, b_by = bound_ms(kept * D * 2 + N * 4 + N * D // 2 + N * 4,
                              6 * kept * D)
        say("kernel", name="quantize_pack_kv_masked", N=N, D=D,
            rejected=N - kept, bytes_equal=True, ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{b_ms:.6f}",
            bound_by=b_by)
        if N == 4 * 4 * 8:
            row.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by,
                       shape=f"N={N} D={D} rejected={N - kept}")
    return row


def _packed_cache(gen, B, KV, S, D, kv_bits):
    """Random packed K/V levels and per-token bf16 scales of a contiguous
    head-major cache (B, KV, S, D/2 | D)."""
    dev = torch.device("cuda")
    ds = D // 2 if kv_bits == 4 else D
    if kv_bits == 4:
        k, v = (torch.randint(0, 256, (B, KV, S, ds), generator=gen,
                              device=dev, dtype=torch.uint8)
                for _ in range(2))
        smax = 1.0 / 7
    else:
        k, v = (torch.randint(-127, 128, (B, KV, S, ds), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2))
        smax = 1.0 / 127
    ks, vs = ((torch.rand((B, KV, S), generator=gen, device=dev) * 2 * smax
               ).to(torch.bfloat16) for _ in range(2))
    return k, v, ks, vs


def _packed_bytes_ops(B, KV, Hg, D, S, kv_bits, lengths):
    """Bytes and operations of one packed read for THIS run's lengths: the
    valid tokens' packed K, V and scales read once, q read and the output
    written once; a score and a PV product per (token, query head, lane)."""
    ds = D // 2 if kv_bits == 4 else D
    n_tok = sum(min(int(n), S) for n in lengths)
    n_bytes = KV * n_tok * (2 * ds + 2 * 2) + 2 * B * KV * Hg * D * 2 + 4 * B
    return n_bytes, 4 * KV * Hg * D * n_tok


def check_packed_attention(gen) -> dict:
    """recurrentgemma-9b's ring read (B=4 rows, MQA: KV=1, Hg=16, D=256,
    S=2048 slots, bs=512) at kv_bits 4 and 8, with lengths 1, 57, 2048 and
    3000 (past S, as a ring passes it), at the main path's lengths (rings
    of <= 56 tokens), and a GQA shape; every output within rel_err 0.03
    of the plain version (tests/test_kernels.py holds the Pallas kernel
    so), visit counts max(cdiv(min(len, S), bs), 1). The JSON row is the
    full-ring int4 case; "shapes" holds the others."""
    from repro_torch.kernels.packed_kv_attention import (
        packed_kv_attention_cuda, packed_kv_attention_plain)
    from repro_torch.models.layers import unpack_int4_pairs
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0, "shapes": []}
    cases = [(4, 1, 16, 256, 2048, 512, 4, (1, 57, 2048, 3000)),
             (4, 1, 16, 256, 2048, 512, 8, (1, 57, 2048, 3000)),
             (4, 1, 16, 256, 2048, 512, 4, (13, 27, 41, 56)),
             (4, 4, 4, 64, 1024, 256, 4, (12, 300, 1024, 700))]
    for B, KV, Hg, D, S, bs, kv_bits, lengths in cases:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        n_one = B * KV * S * (D + 4)
        sets = []
        for _ in range(copies_for(n_one)):
            q = torch.randn((B, KV, Hg, D), generator=gen, device=dev
                            ).to(torch.bfloat16)
            sets.append((q, *_packed_cache(gen, B, KV, S, D, kv_bits), lens))
        got, visits = packed_kv_attention_cuda(*sets[0], bs=bs,
                                               kv_bits=kv_bits,
                                               debug_visits=True)
        want = packed_kv_attention_plain(*sets[0], kv_bits=kv_bits)
        torch.cuda.synchronize()
        err, mabs = rel_err(got, want), max_abs(got, want)
        row["max_abs_err"] = max(row["max_abs_err"], mabs)
        expect = [[max(-(-min(n, S) // bs), 1)] * KV for n in lengths]
        if not err < 0.03 or visits.tolist() != expect:
            raise AssertionError(f"packed_kv_attention B={B} KV={KV} Hg={Hg} "
                                 f"D={D} kv_bits={kv_bits}: rel_err={err}, "
                                 f"visits {visits.tolist()} != {expect}")

        def library(q, kd, vd, mask, Hg=Hg, KV=KV):
            return torch.nn.functional.scaled_dot_product_attention(
                q.reshape(B, KV * Hg, 1, D), kd, vd, attn_mask=mask,
                enable_gqa=True)

        # the yardstick's operands: the same caches dequantized to bf16 and
        # the length mask, made outside the timing
        mask = (torch.arange(S, device=dev)[None, :]
                < lens.clamp(max=S)[:, None])[:, None, None, :]

        def deq(p, sc):
            lv = unpack_int4_pairs(p) if kv_bits == 4 else p
            return (lv.float() * sc.float()[..., None]).to(torch.bfloat16)
        dense = [(q, deq(k, ks), deq(v, vs), mask)
                 for q, k, v, ks, vs, _ in sets[:copies_for(4 * n_one)]]
        ms = time_ms(lambda *a: packed_kv_attention_cuda(
            *a, bs=bs, kv_bits=kv_bits), sets)
        plain_ms = time_ms(lambda *a: packed_kv_attention_plain(
            *a, kv_bits=kv_bits), sets)
        lib_ms = time_ms(library, dense)
        del dense
        n_bytes, n_ops = _packed_bytes_ops(B, KV, Hg, D, S, kv_bits, lengths)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        say("kernel", name="packed_kv_attention", B=B, KV=KV, Hg=Hg, D=D,
            S=S, bs=bs, kv_bits=kv_bits, lengths=",".join(map(str, lengths)),
            visits=json.dumps([v[0] for v in visits.tolist()]),
            rel_err=f"{err:.3e}", max_abs=mabs, ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
            library=repr("scaled_dot_product_attention (dequantized bf16)"),
            bound_ms=f"{b_ms:.6f}", bound_by=b_by)
        shape = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by,
                     shape=f"B={B} KV={KV} Hg={Hg} D={D} S={S} bs={bs} "
                           f"kv_bits={kv_bits} lengths={list(lengths)}")
        if (KV, kv_bits, lengths[-1]) == (1, 4, 3000):   # the full ring
            row.update(shape)
        else:
            row["shapes"].append(shape)
        del sets
    return row


def check_integrity_pack(gen) -> dict:
    """The fused-integrity pack: bytes and scales bit-identical to the
    plain pack and to the unmasked kernel, each row's word equal to its
    plain version; one granite page of every layer (40 x 8 heads x 16
    tokens, D=64), 2048 rows of D=64, and a recurrentgemma page of its
    attention layers (12 x 1 x 16, D=256)."""
    from repro_torch.kernels.quantize_pack_kv import (
        integrity_words_plain, quantize_pack_kv_cuda,
        quantize_pack_kv_integrity_cuda, quantize_pack_kv_integrity_plain,
        quantize_pack_kv_plain)
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0}
    for N, D in ((2048, 64), (40 * 8 * 16, 64), (12 * 16, 256)):
        sets = []
        for _ in range(copies_for(N * D * 2)):
            x = (torch.randn((N, D), generator=gen, device=dev)
                 * torch.rand((N, 1), generator=gen, device=dev) * 8)
            x[: N // 16] = torch.round(x[: N // 16] * 2) / 2   # half ties
            x[0] = 0.0                                          # amax == 0
            sets.append((x.to(torch.bfloat16),))
        (x,) = sets[0]
        p, s, w = quantize_pack_kv_integrity_cuda(x)
        pw, sw = quantize_pack_kv_plain(x)
        pk, sk = quantize_pack_kv_cuda(x)
        ww = integrity_words_plain(pw)
        torch.cuda.synchronize()
        if not (torch.equal(p, pw) and torch.equal(s, sw)
                and torch.equal(p, pk) and torch.equal(s, sk)
                and torch.equal(w, ww)):
            raise AssertionError(
                f"quantize_pack_kv_integrity N={N} D={D}: "
                f"{(p != pw).sum().item()} bytes, {(s != sw).sum().item()} "
                f"scales, {(w != ww).sum().item()} words differ")
        ms = time_ms(quantize_pack_kv_integrity_cuda, sets)
        plain_ms = time_ms(quantize_pack_kv_integrity_plain, sets)
        b_ms, b_by = bound_ms(N * D * 2 + N * D // 2 + N * 4 + N * 4,
                              6 * N * D + 2 * N * D // 2)
        say("kernel", name="quantize_pack_kv_integrity", N=N, D=D,
            bytes_equal=True, words_equal=True, ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{b_ms:.6f}",
            bound_by=b_by)
        if (N, D) == (2048, 64):              # beside row 3's shape
            row.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by, shape=f"N={N} D={D}")
    return row


def _write_case(gen, *, policy, bits, B, T, KV, D, starts, write_rows,
                accept=None, page=16, maxP=32):
    """One layer's arena views as a max_seq=512 pool sizes them for
    `policy` (random contents, distinct pages, mixed modes under
    augment-on-pressure) and rows at `starts` + [0, T): (arenas, rows),
    rows in the order `paged_kv_write` takes them."""
    dev = torch.device("cuda")
    Nn = 1 + (0 if policy == "always-augmented" else B * maxP)
    Np = 1 + (0 if policy == "normal-only" else B * maxP)
    lo, hi, dt = (0, 256, torch.uint8) if bits == 4 \
        else (-127, 128, torch.int8)
    ar = {n: torch.randn((Nn, KV, page, D), generator=gen, device=dev
                         ).to(torch.bfloat16) for n in ("kn", "vn")}
    for n in ("kp", "vp"):
        ar[n] = torch.randint(lo, hi, (Np, KV, page, D // 2 if bits == 4
                                       else D), generator=gen, device=dev,
                              dtype=dt)
    for n in ("ks", "vs"):
        ar[n] = (torch.rand((Np, KV, page), generator=gen, device=dev)
                 * 0.1).to(torch.bfloat16)
    modes = (torch.randint(0, 2, (B, maxP), generator=gen, device=dev,
                           dtype=torch.int32)
             if policy == "augment-on-pressure" else
             torch.full((B, maxP), int(policy == "always-augmented"),
                        dtype=torch.int32, device=dev))
    perm_n = torch.randperm(B * maxP, generator=gen, device=dev) + 1
    perm_p = torch.randperm(B * maxP, generator=gen, device=dev) + 1
    table = torch.where(modes == 1, perm_p.view(B, maxP),
                        perm_n.view(B, maxP)).to(torch.int32)
    k, v = ((torch.randn((B, T, KV, D), generator=gen, device=dev)
             * torch.rand((B, T, KV, 1), generator=gen, device=dev) * 8
             ).to(torch.bfloat16) for _ in range(2))
    pos = (torch.tensor(starts, device=dev)[:, None]
           + torch.arange(T, device=dev)[None, :])
    pos = pos.to(torch.int32) if T == 1 else pos      # as the engine's
    write = torch.tensor(write_rows, device=dev)[:, None].expand(B, T)
    write = write.contiguous()
    commit = None if accept is None else (
        torch.arange(T, device=dev)[None, :]
        < torch.tensor(accept, device=dev)[:, None])
    return ar, (k, v, pos, write, commit, table, modes)


def device_kernels(fn) -> int:
    """Kernels one call of `fn` puts on the device (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def check_paged_write(gen) -> dict:
    """The fused paged KV write (one layer, K and V) at the main paths'
    shapes: qwen's decode step (B=4, T=1, KV=16, hd=64) and prefill chunk
    (T=32, one row written) at int8 and int4, granite's verify window and
    commit pass (W=4, KV=8, int4; the commit pass with 6 of 16 tokens
    rejected). Every arena page >= 1 bit-identical to the plain version
    under each pool policy, on mixed-mode pools under augment-on-pressure;
    timed under always-augmented (the main paths' policy) and
    augment-on-pressure (both planes written), beside the plain version
    and the scatter it replaces (the plain body with int4 rows packed by
    kernel 3 / 3b, as the port ran it before), with the kernels that
    scatter put on the device. The JSON row is qwen's int8 decode."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize_pack_kv as qpk
    names = ("kn", "vn", "kp", "vp", "ks", "vs")
    plain_pack = qpk._pack_plain

    def old_pack(kv, valid, bits):            # the scatter before this PR
        return ops.quantize_pack_kv(kv, valid) if bits == 4 \
            else plain_pack(kv, valid, bits)

    row = {"max_abs_err": 0.0, "shapes": []}        # bits equal, or raise
    for label, bits, T, KV, starts, write_rows, accept in (
            ("qwen decode", 8, 1, 16, [0, 150, 333, 508], [True] * 4, None),
            ("qwen decode", 4, 1, 16, [0, 150, 333, 508], [True] * 4, None),
            ("qwen prefill", 8, 32, 16, [96, 0, 32, 64],
             [True, False, False, False], None),
            ("qwen prefill", 4, 32, 16, [96, 0, 32, 64],
             [True, False, False, False], None),
            ("granite verify", 4, 4, 8, [0, 150, 333, 505], [True] * 4,
             None),
            ("granite commit", 4, 4, 8, [0, 150, 333, 505], [True] * 4,
             [4, 1, 2, 3])):
        D, B = 64, 4
        for policy in ("always-augmented", "augment-on-pressure",
                       "normal-only"):
            ar, rows = _write_case(gen, policy=policy, bits=bits, B=B, T=T,
                                   KV=KV, D=D, starts=starts,
                                   write_rows=write_rows, accept=accept)
            kw = dict(page_size=16, policy=policy, aug_bits=bits)
            got = {n: t.clone() for n, t in ar.items()}
            want = {n: t.clone() for n, t in ar.items()}
            qpk.paged_kv_write_cuda(*(got[n] for n in names), *rows, **kw)
            qpk.paged_kv_write_plain(*(want[n] for n in names), *rows, **kw)
            torch.cuda.synchronize()
            for n in names:
                if not torch.equal(raw(got[n][1:]), raw(want[n][1:])):
                    raise AssertionError(
                        f"paged_kv_write {label} int{bits} {policy}: "
                        f"{(got[n][1:] != want[n][1:]).sum().item()} "
                        f"{n} entries differ on pages >= 1")
            if policy == "normal-only":
                continue
            sets = [(*(ar[n] for n in names), *rows)]
            nbytes = sum(t.numel() * t.element_size() for t in ar.values())
            for _ in range(copies_for(nbytes) - 1):
                sets.append((*(t.clone() for t in sets[0][:6]), *rows))

            def fused(*a, kw=kw):
                qpk.paged_kv_write_cuda(*a, **kw)

            def plain(*a, kw=kw):
                qpk.paged_kv_write_plain(*a, **kw)

            ms = time_ms(fused, sets)
            plain_ms = time_ms(plain, sets)
            qpk._pack_plain = old_pack
            try:
                old_ms = time_ms(plain, sets)
                old_kernels = device_kernels(lambda: plain(*sets[0]))
            finally:
                qpk._pack_plain = plain_pack
            kernels = device_kernels(lambda: fused(*sets[0]))
            if kernels != 1:
                raise AssertionError(f"paged_kv_write {label}: {kernels} "
                                     f"kernels a call")
            N = B * T * KV
            d_store = D // 2 if bits == 4 else D
            looked_up = len({(b, p // 16) for b in range(B)
                             for p in range(starts[b], starts[b] + T)})
            n_bytes = (2 * N * D * 2 + B * T * (rows[2].element_size() + 1
                                                + (accept is not None))
                       + looked_up * 2 * 4 + 2 * N * (d_store + 2)
                       + (2 * N * D * 2 if policy != "always-augmented"
                          else 0))
            b_ms, b_by = bound_ms(n_bytes, 6 * 2 * N * D)
            say("kernel", name="paged_kv_write", shape=repr(label),
                kv_bits=bits, policy=policy, B=B, T=T, KV=KV, D=D,
                accept=",".join(map(str, accept or [])) or "none",
                bits_equal=True, kernels=kernels,
                ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                replaced_ms=f"{old_ms:.5f}", replaced_kernels=old_kernels,
                bound_ms=f"{b_ms:.6f}", bound_by=b_by)
            shape = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by,
                         shape=f"{label} B={B} T={T} KV={KV} D={D} "
                               f"kv_bits={bits} policy={policy}"
                               + (f" accept={accept}" if accept else ""))
            if (label, bits, policy) == ("qwen decode", 8,
                                         "always-augmented"):
                row.update(shape)
            else:
                row["shapes"].append(shape)
            del sets
    return row


def _imc_weights(gen, fmt: str, K: int, N: int):
    """Random stored bytes of an IMC format, its (K, N) int8 contents and
    a scale per column."""
    from repro_torch.kernels.imc_dot import k_pack, unpack_weights
    dev = torch.device("cuda")
    rows = K // k_pack(fmt)
    if fmt == "int8":
        w = torch.randint(-127, 128, (rows, N), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        w = torch.randint(0, 256, (rows, N), generator=gen, device=dev,
                          dtype=torch.uint8)
        if fmt == "ternary":              # digit 3 is not a trit
            w = torch.where((w & 3) == 3, w ^ 1, w)
    scale = torch.rand((1, N), generator=gen, device=dev) * 0.05
    return w, scale


def _int_mm_or_matmul(xq_w8, dense):
    """The yardstick: `torch._int_mm` on the same int8 operands where its
    shape rules allow (M > 16), else `torch.matmul` on the dequantized
    bf16 weights. Returns (fn, arg sets, name)."""
    if xq_w8[0][0].shape[0] > 16:
        try:
            torch._int_mm(*xq_w8[0])
            return torch._int_mm, xq_w8, "torch._int_mm (int8 operands)"
        except RuntimeError as e:        # a shape or layout it refuses
            say("yardstick", int_mm_refused=repr(str(e)[:120]))
    return torch.matmul, dense, "torch.matmul (dequantized bf16)"


def _decode_plan_line(K: int, N: int, M: int) -> dict:
    """The C source's decode plan at (K, N), for the `[kernel]` line only:
    columns a CTA, CTAs splitting K (one cluster), CTAs launched."""
    from repro_torch.kernels.imc_dot import decode_plan
    if M > 16:
        return {"route": "prepass+tiles"}
    bn, splits = decode_plan(K, N)
    return {"route": "decode", "cols_per_cta": bn, "splits": splits,
            "ctas": N // bn * splits}


def check_imc_dot(gen) -> dict:
    """qwen's IMC shapes: ternary at abits 8 at every decode shape qwen
    launches (M=4: K=1024 N=1024 wq/wk/wv/wo, K=1024 N=2816 w_gate/w_up,
    K=2816 N=1024 w_down) and at prefill (M=128, K=2816, N=1024); ternary,
    int4 and int8 at abits 1/4/8 at the gate/up shape; int8 at K=2816,
    where the plain float32 shift-add may round. Every result bit-identical
    to the plain version except that int8 row (rel_err <= 1e-6), and the
    levels and scales every call used equal to `quantize_activations`."""
    from repro_torch.kernels.imc_dot import (
        imc_dot_cuda, imc_dot_levels, imc_dot_plain, k_pack,
        quantize_activations, unpack_weights)
    dev = torch.device("cuda")
    cases = [("ternary", 8, 4, 1024, 1024), ("ternary", 8, 4, 1024, 2816),
             ("ternary", 8, 4, 2816, 1024), ("ternary", 8, 128, 2816, 1024)]
    cases += [(f, a, 4, 1024, 2816) for f in ("ternary", "int4", "int8")
              for a in (1, 4, 8) if (f, a) != ("ternary", 8)]
    cases += [("int8", 8, 4, 2816, 1024), ("int8", 8, 128, 2816, 1024)]
    row = {"max_abs_err": 0.0}
    for fmt, abits, M, K, N in cases:
        nbytes = K // k_pack(fmt) * N
        sets = []
        for _ in range(copies_for(nbytes)):
            w, scale = _imc_weights(gen, fmt, K, N)
            x = torch.randn((M, K), generator=gen, device=dev
                            ).to(torch.bfloat16)
            sets.append((x, w, scale))
        x, w, scale = sets[0]
        got, q, s = imc_dot_levels(x, w, scale, fmt=fmt, abits=abits)
        qw, sw = quantize_activations(x, abits)
        want = imc_dot_plain(x, w, scale, fmt=fmt, abits=abits)
        torch.cuda.synchronize()
        if not (torch.equal(q, qw) and torch.equal(s, sw)):
            raise AssertionError(
                f"imc_dot quantize abits={abits} M={M} K={K} N={N}: "
                f"{(q != qw).sum().item()} levels, "
                f"{(s != sw).sum().item()} scales differ")
        err, mabs = rel_err(got, want), max_abs(got, want)
        row["max_abs_err"] = max(row["max_abs_err"], mabs)
        exact_k = fmt != "int8" or K <= 1040
        if (exact_k and mabs != 0.0) or err > 1e-6:
            raise AssertionError(f"imc_dot {fmt} abits={abits} M={M} K={K} "
                                 f"N={N}: max_abs={mabs} rel_err={err}")
        ms = time_ms(lambda *a: imc_dot_cuda(*a, fmt=fmt, abits=abits),
                     sets)
        plain_ms = time_ms(lambda *a: imc_dot_plain(*a, fmt=fmt,
                                                    abits=abits), sets)
        lib_fn, lib_sets, lib_name = _int_mm_or_matmul(
            [(quantize_activations(x_, abits)[0], unpack_weights(fmt, w_))
             for x_, w_, _ in sets],
            [(x_, (unpack_weights(fmt, w_).float() * s_).to(torch.bfloat16))
             for x_, w_, s_ in sets])
        lib_ms = time_ms(lib_fn, lib_sets)
        del lib_sets
        b_ms, b_by = bound_ms(M * K * 2 + nbytes + N * 4 + M * N * 2,
                              2 * M * K * N, INT8_OP_PER_S)
        say("kernel", name="imc_dot", fmt=fmt, abits=abits, M=M, K=K, N=N,
            **_decode_plan_line(K, N, M), max_abs=mabs,
            rel_err=f"{err:.3e}", levels_and_scales_equal=True,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{lib_ms:.5f}", library=repr(lib_name),
            bound_ms=f"{b_ms:.5f}", bound_by=b_by)
        if (fmt, abits, M, K, N) == ("ternary", 8, 4, 1024, 2816):
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       shape=f"ternary abits=8 M={M} K={K} N={N}",
                       library=lib_name)
    return row


def check_imc_dual_dot(gen) -> dict:
    """granite's imc draft shapes: w_gate_up (K=2048, N=8192) and wkv
    (K=2048, N=512) at M=4, abits 4 and 8; bit-identical to the plain
    version, the levels and scales used equal to `quantize_activations`."""
    from repro_torch.kernels.imc_dot import (imc_dual_dot_cuda,
                                             imc_dual_dot_levels,
                                             imc_dual_dot_plain,
                                             quantize_activations)
    from repro_torch.core.quant import unpack_int4_hi, unpack_int4_lo
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0}
    for abits in (4, 8):
        for K, N in ((2048, 8192), (2048, 512)):
            M = 4
            sets = []
            for _ in range(copies_for(K * N)):
                buf, hs = _imc_weights(gen, "dual", K, N)
                ls = torch.rand((1, N), generator=gen, device=dev) * 0.05
                x = torch.randn((M, K), generator=gen, device=dev
                                ).to(torch.bfloat16)
                sets.append((x, buf, hs, ls))
            got, q, s = imc_dual_dot_levels(*sets[0], abits=abits)
            qw, sw = quantize_activations(sets[0][0], abits)
            want = imc_dual_dot_plain(*sets[0], abits=abits)
            torch.cuda.synchronize()
            mabs = max(max_abs(a, b) for a, b in zip(got, want))
            err = max(rel_err(a, b) for a, b in zip(got, want))
            row["max_abs_err"] = max(row["max_abs_err"], mabs)
            if mabs != 0.0 or not (torch.equal(q, qw) and torch.equal(s, sw)):
                raise AssertionError(f"imc_dual_dot abits={abits} K={K} "
                                     f"N={N}: max_abs={mabs}, levels equal "
                                     f"{torch.equal(q, qw)}, scales equal "
                                     f"{torch.equal(s, sw)}")
            ms = time_ms(lambda *a: imc_dual_dot_cuda(*a, abits=abits), sets)
            plain_ms = time_ms(lambda *a: imc_dual_dot_plain(*a, abits=abits),
                               sets)
            planes = [(x_, (unpack_int4_hi(b_).float() * h_
                            ).to(torch.bfloat16),
                       (unpack_int4_lo(b_).float() * l_).to(torch.bfloat16))
                      for x_, b_, h_, l_ in sets]
            lib_ms = time_ms(lambda x_, h_, l_: (torch.matmul(x_, h_),
                                                 torch.matmul(x_, l_)),
                             planes)
            del planes
            b_ms, b_by = bound_ms(M * K * 2 + K * N + 2 * N * 4
                                  + 2 * M * N * 2, 2 * 2 * M * K * N,
                                  INT8_OP_PER_S)
            say("kernel", name="imc_dual_dot", abits=abits, M=M, K=K, N=N,
                **_decode_plan_line(K, N, M), max_abs=mabs,
                rel_err=f"{err:.3e}", levels_and_scales_equal=True,
                ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                library_ms=f"{lib_ms:.5f}",
                library=repr("2 x torch.matmul (dequantized bf16 planes)"),
                bound_ms=f"{b_ms:.5f}", bound_by=b_by)
            if (abits, N) == (4, 8192):       # the imc4 draft's gate/up
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"abits=4 M={M} K={K} N={N}",
                           library="2 x torch.matmul (dequantized bf16)")
    return row


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def first_step_logits_check(cfg, params, kv_mode: str, gen,
                            window: int = 0, bound: bool = True,
                            label: str = "") -> float:
    """The first prefill chunk and first decode step at full width (and,
    with `window`, one verify window after them), once through the
    kernels and once through the plain versions, each on its own copy of
    a freshly admitted pool. Returns the worst rel_err; raises past 0.05
    unless `bound` is False (a reported variant, named by `label`)."""
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
        pool.admit_row(r, C + 1 + window, step=0)
    tables = pool.device_tables()
    arenas_k = pool.arenas
    arenas_p = {k: v.clone() for k, v in arenas_k.items()}
    V = cfg.vocab       # padded vocab columns hold -1e30 on both paths
    errs = {}

    def both(step, batch):
        lk, _ = step(kcfg, params, arenas_k, {**batch, **tables})
        lp, _ = step(pcfg, params, arenas_p, {**batch, **tables})
        return rel_err(lk[..., :V], lp[..., :V]), lp

    with torch.no_grad():
        ones = torch.ones(B, dtype=torch.bool, device=dev)
        errs["prefill"], lp = both(M.paged_prefill_step, {
            "tokens": torch.randint(0, cfg.vocab, (B, C), generator=gen,
                                    device=dev, dtype=torch.int32),
            "positions": torch.zeros(B, dtype=torch.int32, device=dev),
            "write_mask": ones})
        nxt = lp[:, -1, :V].argmax(-1).to(torch.int32)[:, None]
        errs["decode"], lp = both(M.paged_decode_step, {
            "tokens": nxt, "write_mask": ones,
            "positions": torch.full((B,), C, dtype=torch.int32,
                                    device=dev)})
        if window:
            win = torch.randint(0, cfg.vocab, (B, window), generator=gen,
                                device=dev, dtype=torch.int32)
            win[:, 0] = lp[:, -1, :V].argmax(-1)
            errs["verify"], _ = both(M.paged_verify_step, {
                "tokens": win,
                "positions": torch.full((B,), C + 1, dtype=torch.int32,
                                        device=dev),
                "write_mask": torch.ones((B, window), dtype=torch.bool,
                                         device=dev)})
    say("logits", model=cfg.name, kv_mode=kv_mode,
        **({"variant": repr(label)} if label else {}),
        **{f"{k}_rel_err": f"{v:.3e}" for k, v in errs.items()})
    if bound and not all(v < 0.05 for v in errs.values()):
        raise AssertionError(f"first-step logits disagree ({cfg.name}, "
                             f"{kv_mode}): {errs}")
    return max(errs.values())


def route_noise(cfg, params) -> None:
    """Two variants of granite's first-step check, reported and not bound:
    the kernel route with the prefill chunk's unpaired bf16 products also
    through the fixed-order GEMM (the product's rounding is all that
    changes), and with every such product through torch.matmul on the
    rows cut in two halves (cuBLAS against itself at another M): how far
    one-ulp changes of those products move the logits once the int4 KV
    carries them through 40 layers."""
    from repro_torch.kernels.ternary_matmul import dense_matmul_plain
    from repro_torch.models import augment
    orig = augment.dense_apply

    def everywhere(x, w, amc=None, *, augmented, layout="kn",
                   fixed_order=True):
        return orig(x, w, amc, augmented=augmented, layout=layout)

    def halves(x, w, amc=None, *, augmented, layout="kn", fixed_order=True):
        x2 = x.reshape(-1, x.shape[-1])
        if not augmented or amc.matmul_impl != "packed" or len(x2) < 2:
            return orig(x, w, amc, augmented=augmented, layout=layout,
                        fixed_order=fixed_order)
        h = len(x2) // 2
        y = torch.cat([dense_matmul_plain(x2[:h], w, layout),
                       dense_matmul_plain(x2[h:], w, layout)])
        return y.reshape(*x.shape[:-1], y.shape[-1])

    for label, fn in (("fixed-order GEMM in prefill too", everywhere),
                      ("torch.matmul on rows cut in halves", halves)):
        augment.dense_apply = fn
        try:
            first_step_logits_check(
                cfg, params, cfg.amc.kv_mode,
                torch.Generator(device="cuda").manual_seed(2), window=4,
                bound=False, label=label)
        finally:
            augment.dense_apply = orig


def serve_once(eng, prompts, max_new: int = 32) -> dict:
    """Serve the prompts, `max_new` new tokens each, on `eng` with every
    launch count set to 0 just before and read just after; host clock
    synchronised around each prompt's prefill (decode time is the
    rest)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request
    timing = {"prefill_s": 0.0, "prefill_tokens": 0}
    base_prefill = eng.prefill

    def timed_prefill(slot, tokens, return_next=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = base_prefill(slot, tokens, return_next)
        torch.cuda.synchronize()
        timing["prefill_s"] += time.perf_counter() - t0
        timing["prefill_tokens"] += len(tokens)
        return out

    eng.prefill = timed_prefill
    reqs = [Request(prompt=p, max_new_tokens=max_new, id=i)
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
    eng.prefill = base_prefill
    if sorted(out) != list(range(len(prompts))) or \
            any(len(out[i]) != max_new for i in range(len(prompts))):
        raise AssertionError(f"not every request completed: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    st = eng.stats()
    decode_s = wall - timing["prefill_s"]
    line = dict(requests=len(out), new_tokens=sum(map(len, out.values())),
                prefill_tokens=timing["prefill_tokens"],
                prefill_tok_s=round(timing["prefill_tokens"]
                                    / timing["prefill_s"], 3),
                decode_tok_s=round(max_new * len(prompts) / decode_s, 3),
                wall_s=round(wall, 3), steps=eng.step_idx,
                dispatches=eng.dispatch_count,
                preemptions=st["preemptions"], refreshes=st["refreshes"],
                augment_events=st["augment_events"],
                pool_mode=st["pool"]["pool_mode"],
                peak_mem_gib=round(torch.cuda.max_memory_allocated()
                                   / 2**30, 3),
                allocated_before_gib=round(base / 2**30, 3))
    return {"out": out, "counts": counts, "line": line, "stats": st}


def require_launches(counts: dict, need, what: str) -> None:
    if any(counts[k] == 0 for k in need):
        raise AssertionError(f"a kernel of the {what} path never launched: "
                             f"{counts}")


def spec_agreement(model: str, draft: str, spec: dict, step: dict) -> str:
    """Print how many requests speculative decode served with exactly the
    stepwise tokens; returns a failure message unless all of them."""
    agree = np.mean([a == b for i in step for a, b in zip(spec[i], step[i])])
    same = sum(spec[i] == step[i] for i in step)
    say("agreement", model=model, draft=draft,
        spec_vs_stepwise=round(float(agree), 4),
        identical_requests=f"{same}/{len(step)}")
    if same != len(step):
        return (f"{model} {draft} draft: speculative tokens differ from "
                f"stepwise on {len(step) - same}/{len(step)} requests")
    return ""


def phase_main(smi: str) -> dict:
    """qwen1.5-0.5b at kv int8 and int4. Returns the launch counts, the
    packed weights, and the int4 run's tokens and ledger (phase 5 compares
    the IMC run with them)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import Request, ServeEngine
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
    outs = {}
    for kv_mode in ("int8", "int4"):
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, params=params, kv_mode=kv_mode)
        params = eng.params                   # packed once, reused
        if kv_mode == "int8":
            say("setup", model=cfg.name,
                params_s=round(time.perf_counter() - t0, 3),
                weight_bytes=eng.stats()["weight_bytes_physical"])
        run = serve_once(eng, prompts)
        counts = run["counts"]
        require_launches(counts, ["ternary_matmul", "dense_matmul",
                                  "paged_kv_attention", "paged_kv_write"],
                         cfg.name)
        outs[kv_mode] = run["out"]
        for k in launches:
            launches[k] += counts[k]
        say("main", model=cfg.name, kv_mode=kv_mode, **run["line"],
            launches=json.dumps(counts), card=repr(smi))
        # the plain path on the same card: greedy agreement (reported,
        # not asserted: near-ties of random full-width weights may flip)
        pcfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, matmul_impl="dense", kv_impl="dequant"))
        peng = ServeEngine(pcfg, device="cuda", max_batch=4, max_seq=512,
                           prefill_chunk=32, params=params, kv_mode=kv_mode)
        pout = peng.generate([Request(prompt=p, max_new_tokens=32, id=i)
                              for i, p in enumerate(prompts)])
        out = run["out"]
        agree = np.mean([a == b for i in range(8)
                         for a, b in zip(out[i], pout[i])])
        say("agreement", model=cfg.name, kv_mode=kv_mode,
            greedy_token_agreement=round(float(agree), 4))
        first_step_logits_check(cfg, params, kv_mode, gen)
        del eng, peng
        torch.cuda.empty_cache()
    imc_stats = run["stats"]["imc"]
    # augment-on-pressure, kv int4: a budget of 24 Normal pages against
    # the ~60 the requests fill, so the pool augments its coldest Normal
    # pages in place (kernel 3, through `_augment_page_op`) while the
    # fused write fills pages of both planes and kernel 2 reads them
    from repro_torch.serve.cache_pool import PageGeometry
    normal_page = PageGeometry(cfg.n_layers, cfg.n_kv_heads, cfg.hd,
                               cfg.amc.page_size, 4).page_bytes_normal
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=params, kv_mode="int4",
                      pool_mode="augment-on-pressure",
                      pool_budget_bytes=24 * normal_page)
    run = serve_once(eng, prompts)
    counts = run["counts"]
    require_launches(counts, ["ternary_matmul", "dense_matmul",
                              "paged_kv_attention", "paged_kv_write",
                              "quantize_pack_kv"],
                     f"{cfg.name} augment-on-pressure")
    for k in launches:
        launches[k] += counts[k]
    agree = np.mean([a == b for i in range(8)
                     for a, b in zip(run["out"][i], outs["int4"][i])])
    say("main", model=cfg.name, kv_mode="int4", **run["line"],
        promote_events=run["stats"]["promote_events"],
        launches=json.dumps(counts), card=repr(smi))
    say("agreement", model=cfg.name, kv_mode="int4",
        pool_mode="augment-on-pressure",
        greedy_token_agreement_vs_always_augmented=round(float(agree), 4))
    if run["line"]["augment_events"] == 0:
        raise AssertionError("augment-on-pressure augmented no page")
    del eng
    torch.cuda.empty_cache()
    # speculative decode at the config's kv int8: the stepwise tokens,
    # exactly (every row's bits are independent of M on the card)
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=params, spec_k=4)
    run = serve_once(eng, prompts)
    counts = run["counts"]
    require_launches(counts, ["ternary_matmul", "dense_matmul",
                              "paged_kv_attention_window", "paged_kv_write"],
                     f"{cfg.name} spec_k=4")
    for k in launches:
        launches[k] += counts[k]
    sp = run["stats"]["spec"]
    say("main", model=cfg.name, kv_mode="int8", spec_k=4, **run["line"],
        rounds=sp["spec_rounds"],
        accepted_per_round=round(sp["accepted_tokens_per_round"], 4),
        launches=json.dumps(counts), card=repr(smi))
    failed = spec_agreement(cfg.name, "dequant", run["out"], outs["int8"])
    del eng
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(failed)
    return {"launches": launches, "params": params, "int4_out": outs["int4"],
            "int4_imc": imc_stats}


def phase_granite(smi: str) -> dict:
    """granite-3-2b as its config sets it (dual weights, int4 KV) at
    spec_k=4 and at spec_k=1. Returns the launch counts, the packed
    weights and the spec_k=1 tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeEngine
    cfg = get_arch("granite-3-2b")
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(dense_cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    launches = {k: 0 for k in ops.KERNELS}
    outs = {}
    for spec_k in (4, 1):
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, params=params, spec_k=spec_k)
        if spec_k == 4:
            params = eng.params                   # packed once, reused
            torch.cuda.empty_cache()              # the dense tree is gone
            say("setup", model=cfg.name,
                params_s=round(time.perf_counter() - t0, 3),
                weight_bytes=eng.stats()["weight_bytes_physical"])
        run = serve_once(eng, prompts)
        counts = run["counts"]
        require_launches(counts, ["dual_plane_matmul", "dense_matmul",
                                  "paged_kv_write"] + (
            ["paged_kv_attention_window"] if spec_k > 1
            else ["paged_kv_attention"]), f"{cfg.name} spec_k={spec_k}")
        for k in launches:
            launches[k] += counts[k]
        sp = run["stats"]["spec"]
        say("main", model=cfg.name, kv_mode=cfg.amc.kv_mode,
            weight_mode=cfg.amc.weight_mode, spec_k=spec_k, **run["line"],
            rounds=sp["spec_rounds"],
            accepted_per_round=round(sp["accepted_tokens_per_round"], 4),
            draft_dispatches=sp["draft_dispatches"],
            verify_dispatches=sp["verify_dispatches"],
            retracted_pages=run["stats"]["pool"]["retracted_pages"],
            launches=json.dumps(counts), card=repr(smi))
        outs[spec_k] = run["out"]
        del eng
        torch.cuda.empty_cache()
    failed = spec_agreement(cfg.name, "dequant", outs[4], outs[1])
    gen = torch.Generator(device="cuda").manual_seed(2)
    first_step_logits_check(cfg, params, cfg.amc.kv_mode, gen, window=4)
    route_noise(cfg, params)
    if failed:
        raise AssertionError(failed)
    return {"launches": launches, "params": params, "stepwise_out": outs[1]}


# ---------------------------------------------------------------------------
# phase 5: in-memory compute
# ---------------------------------------------------------------------------

def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


class ImcCalls:
    """While active, records every `ops.imc_dot` / `ops.imc_dual_dot` call
    that launches a kernel (its CUDA inputs and outputs), so that each can
    be held against its plain version on CPU copies of the same inputs:
    the kernels on the main path's own activations."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = (ops.imc_dot, ops.imc_dual_dot)

        def recording(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                if args[0].is_cuda and not kw.get("plain"):
                    self.calls.append((name, args, kw, out))
                return out
            return call

        ops.imc_dot = recording("imc_dot", ops.imc_dot)
        ops.imc_dual_dot = recording("imc_dual_dot", ops.imc_dual_dot)
        return self

    def __exit__(self, *exc):
        self.ops.imc_dot, self.ops.imc_dual_dot = self.saved

    def max_abs_vs_plain(self) -> float:
        from repro_torch.kernels.imc_dot import (imc_dot_plain,
                                                 imc_dual_dot_plain)
        plain = {"imc_dot": imc_dot_plain, "imc_dual_dot": imc_dual_dot_plain}
        worst = 0.0
        for name, args, kw, out in self.calls:
            want = plain[name](*(a.cpu() for a in args), **kw)
            outs = out if isinstance(out, tuple) else (out,)
            wants = want if isinstance(want, tuple) else (want,)
            worst = max(worst, *(max_abs(o.cpu(), w)
                                 for o, w in zip(outs, wants)))
        return worst


def cpu_twin_check(cfg, params, gen, *, fill_cfg=None,
                   packed_cfg=None) -> dict:
    """The first prefill chunk and first decode step of `cfg` on the card,
    each held against the same step on CPU copies of the params and the
    pool (every op takes its plain version there). With `fill_cfg` the
    pool is first filled on the card by one prefill chunk of that config
    and only the decode step is compared. With `packed_cfg` the card's
    logits are also compared with that config's on the card (reported).
    Every IMC kernel call of the card's steps is held against its plain
    version on CPU copies of its inputs. Returns {step: rel_err},
    {step: rel_err vs packed} and (IMC calls, their worst max_abs)."""
    from repro_torch.models import model as M
    from repro_torch.serve.cache_pool import PagedKVPool
    dev = torch.device("cuda")
    B, C, V = 4, 32, cfg.vocab
    pool = PagedKVPool(cfg, max_batch=B, max_seq=512, device=dev)
    for r in range(B):
        pool.admit_row(r, C + 1, step=0)
    tables = pool.device_tables()
    arenas = pool.arenas
    arenas_p = {k: v.clone() for k, v in arenas.items()}
    params_c = _to_cpu(params)
    batch = {**tables,
             "tokens": torch.randint(0, V, (B, C), generator=gen, device=dev,
                                     dtype=torch.int32),
             "positions": torch.zeros(B, dtype=torch.int32, device=dev),
             "write_mask": torch.ones(B, dtype=torch.bool, device=dev)}
    errs, vs_packed = {}, {}
    calls = ImcCalls()
    with torch.no_grad():
        steps = [("prefill", M.paged_prefill_step),
                 ("decode", M.paged_decode_step)]
        if fill_cfg is not None:
            lc, _ = M.paged_prefill_step(fill_cfg, params, arenas, batch)
            arenas_p = {k: v.clone() for k, v in arenas.items()}
            steps = steps[1:]
        arenas_c = _to_cpu(arenas)
        for name, step in steps:
            if name == "decode":
                batch.update(
                    tokens=lc[:, -1, :V].argmax(-1).to(torch.int32)[:, None]
                    .to(dev),
                    positions=torch.full((B,), C, dtype=torch.int32,
                                         device=dev))
            with calls:
                lk, _ = step(cfg, params, arenas, batch)
            lc, _ = step(cfg, params_c, arenas_c, _to_cpu(batch))
            errs[name] = rel_err(lk[..., :V].cpu(), lc[..., :V])
            if packed_cfg is not None:
                lp, _ = step(packed_cfg, params, arenas_p, batch)
                vs_packed[name] = rel_err(lk[..., :V], lp[..., :V])
        per_call = (len(calls.calls), calls.max_abs_vs_plain())
    del params_c, arenas_c, calls
    return errs, vs_packed, per_call


def phase_imc(smi: str, qwen: dict, granite: dict) -> dict:
    """qwen1.5-0.5b with every projection in the array (ternary weights,
    kv int4, matmul_impl="imc", imc_abits=8), and granite-3-2b as its
    config sets it self-speculating with a 4-bit IMC draft
    (spec_draft_impl="imc4", spec_k=4) and a 1-bit one: phase 4's
    requests and weights. Returns the launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: 0 for k in ops.KERNELS}
    cfg = get_arch("qwen1.5-0.5b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=qwen["params"], kv_mode="int4",
                      matmul_impl="imc", imc_abits=8)
    run = serve_once(eng, prompts)
    counts = run["counts"]
    require_launches(counts, ["imc_dot", "paged_kv_attention",
                              "paged_kv_write"], f"{cfg.name} imc")
    if counts["ternary_matmul"] or counts["dual_plane_matmul"]:
        raise AssertionError(f"a packed matmul kernel ran on the IMC path: "
                             f"{counts}")
    for k in launches:
        launches[k] += counts[k]
    out, imc = run["out"], run["stats"]["imc"]
    agree = np.mean([a == b for i in range(8)
                     for a, b in zip(out[i], qwen["int4_out"][i])])
    say("main", model=cfg.name, kv_mode="int4", matmul_impl="imc",
        imc_abits=8, **run["line"], launches=json.dumps(counts),
        card=repr(smi))
    say("imc", model=cfg.name,
        energy_pj_per_token=round(imc["energy_pj_per_token"], 3),
        packed_energy_pj_per_token=round(
            qwen["int4_imc"]["energy_pj_per_token"], 3),
        weights_events=json.dumps(imc["groups"]["weights"]["events"]),
        greedy_agreement_vs_packed_int4=round(float(agree), 4))
    del eng
    torch.cuda.empty_cache()
    icfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode="int4", matmul_impl="imc", imc_abits=8))
    pcfg = dataclasses.replace(icfg, amc=dataclasses.replace(
        icfg.amc, matmul_impl="packed"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    t0 = time.perf_counter()
    errs, vs_packed, (n_calls, call_abs) = cpu_twin_check(
        icfg, qwen["params"], gen, packed_cfg=pcfg)
    say("logits", model=cfg.name, matmul_impl="imc", twin="cpu",
        **{f"{k}_rel_err": f"{v:.3e}" for k, v in errs.items()},
        **{f"{k}_rel_err_vs_packed": f"{v:.3e}" for k, v in vs_packed.items()},
        imc_calls=n_calls, imc_calls_max_abs_vs_plain=call_abs,
        seconds=round(time.perf_counter() - t0, 3))
    failed = []
    if not all(v < 0.05 for v in errs.values()) or call_abs != 0.0 \
            or n_calls != 2 * 7 * cfg.n_layers:
        failed.append(f"{cfg.name} IMC vs its CPU twin: {errs}, "
                      f"{n_calls} IMC calls, max_abs {call_abs}")

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("granite-3-2b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    # imc4 is the slice's draft; imc1 (binary activations) is the coarsest,
    # run as well so that rejected drafts reach the card's rollback path
    for draft in ("imc4", "imc1"):
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, params=granite["params"],
                          spec_k=4, spec_draft_impl=draft)
        run = serve_once(eng, prompts)
        counts = run["counts"]
        require_launches(counts, ["imc_dual_dot", "dual_plane_matmul",
                                  "dense_matmul", "paged_kv_attention",
                                  "paged_kv_attention_window",
                                  "paged_kv_write"],
                         f"{cfg.name} {draft} draft")
        for k in launches:
            launches[k] += counts[k]
        sp, imc = run["stats"]["spec"], run["stats"]["imc"]
        say("main", model=cfg.name, kv_mode=cfg.amc.kv_mode,
            weight_mode=cfg.amc.weight_mode, spec_k=4, spec_draft_impl=draft,
            **run["line"], rounds=sp["spec_rounds"],
            accepted_per_round=round(sp["accepted_tokens_per_round"], 4),
            draft_dispatches=sp["draft_dispatches"],
            verify_dispatches=sp["verify_dispatches"],
            retracted_pages=run["stats"]["pool"]["retracted_pages"],
            launches=json.dumps(counts), card=repr(smi))
        msg = spec_agreement(cfg.name, draft, run["out"],
                             granite["stepwise_out"])
        if msg:
            failed.append(msg)
        say("imc", model=cfg.name, draft_impl=draft,
            draft=json.dumps(imc["groups"]["draft"]),
            energy_pj_per_token=round(imc["energy_pj_per_token"], 3))
        if draft == "imc4":
            draft_cfg = eng._draft_cfg
        del eng
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    errs, _, (n_calls, call_abs) = cpu_twin_check(
        draft_cfg, granite["params"], gen, fill_cfg=cfg)
    say("logits", model=cfg.name, step="imc4 draft decode", twin="cpu",
        **{f"{k}_rel_err": f"{v:.3e}" for k, v in errs.items()},
        imc_calls=n_calls, imc_calls_max_abs_vs_plain=call_abs,
        seconds=round(time.perf_counter() - t0, 3))
    if not all(v < 0.05 for v in errs.values()) or call_abs != 0.0 \
            or n_calls != 2 * cfg.n_layers:
        failed.append(f"{cfg.name} imc4 draft vs its CPU twin: {errs}, "
                      f"{n_calls} IMC calls, max_abs {call_abs}")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 6: the hybrid family
# ---------------------------------------------------------------------------

def hybrid_route_check(cfg, params, gen, prompt: int = 32) -> dict:
    """4 rows at full width from fresh slabs: `prompt` stepwise prefill
    dispatches and then the first decode step, each from the same state
    through the kernel route (kernel 6 on the ring) and the plain route
    (kv_impl="dequant"); the state advances along the kernel route.
    Returns the first decode step's logits rel_err and the worst of the
    prefill steps with its position."""
    from repro_torch.serve import state_store
    dev = torch.device("cuda")
    pcfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant"))
    B, V = 4, cfg.vocab
    store = state_store.make_store(cfg, max_batch=B, max_seq=64, device=dev)
    for r in range(B):
        store.admit_row(r, prompt + 1, step=0)
    kdec = state_store.make_step_fns(cfg)["decode"]
    pdec = state_store.make_step_fns(pcfg)["decode"]
    state, errs = store.state, []
    toks = torch.randint(0, V, (B, prompt + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    with torch.no_grad():
        for i in range(prompt + 1):
            batch = {**store.device_tables(), "tokens": toks[:, i:i + 1],
                     "positions": torch.full((B,), i, dtype=torch.int32,
                                             device=dev),
                     "write_mask": torch.ones(B, dtype=torch.bool,
                                              device=dev)}
            lk, new_state = kdec(params, state, batch)
            lp, _ = pdec(params, state, batch)
            errs.append(rel_err(lk[..., :V], lp[..., :V]))
            state = new_state
    worst = int(np.argmax(errs[:prompt]))
    return {"decode": errs[prompt], "prefill_worst": errs[worst],
            "prefill_worst_position": worst}


def phase_hybrid(smi: str) -> dict:
    """recurrentgemma-9b as its config sets it (dense bf16 weights, int4
    ring KV over a 2048-slot window, pool `auto`: slabs Normal) at full
    width: 4 requests of 12-40 prompt tokens (prefilled token by token:
    the family has no chunked prefill) and 16 new tokens, kernel 6 on
    every attention layer of every dispatch; the kernel route against
    the plain route on the card; then the reduced config (16-slot ring,
    prompts past it) on the card against the CPU. Returns the launch
    counts of the full-width run."""
    from repro_torch.configs import get_arch
    from repro_torch.models.params import init_params, tree_nbytes
    from repro_torch.serve import Request, ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("recurrentgemma-9b")
    n_attn = cfg.n_layers // len(cfg.hybrid.pattern)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("setup", model=cfg.name, params_s=round(time.perf_counter() - t0, 3),
        weight_bytes=tree_nbytes(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(12, 41, size=4)]
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=64,
                      params=params)
    run = serve_once(eng, prompts, max_new=16)
    counts = run["counts"]
    require_launches(counts, ["packed_kv_attention"], cfg.name)
    if counts["packed_kv_attention"] != n_attn * eng.dispatch_count:
        raise AssertionError(
            f"kernel 6 launched {counts['packed_kv_attention']} times over "
            f"{eng.dispatch_count} dispatches, not {n_attn} a dispatch")
    st = run["stats"]
    say("main", model=cfg.name, kv_mode=cfg.amc.kv_mode,
        weight_mode=st["weight_mode"], **run["line"],
        store=st["pool"]["kind"], slab_bytes=st["pool"]["slab_bytes_normal"],
        kernel6_per_dispatch=counts["packed_kv_attention"]
        / eng.dispatch_count, launches=json.dumps(counts), card=repr(smi))
    say("imc", model=cfg.name,
        energy_pj_per_token=round(st["imc"]["energy_pj_per_token"], 3))
    del eng
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    errs = hybrid_route_check(cfg, params, gen)
    say("logits", model=cfg.name, prompt_tokens=32,
        decode_rel_err=f"{errs['decode']:.3e}",
        prefill_worst_rel_err=f"{errs['prefill_worst']:.3e}",
        prefill_worst_position=errs["prefill_worst_position"],
        seconds=round(time.perf_counter() - t0, 3))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    failed = []
    if not errs["decode"] < 0.05:
        failed.append(f"{cfg.name} kernel vs plain route, first decode step: "
                      f"rel_err {errs['decode']}")

    # the ring wraps: a 16-slot window, prompts of 17-30 tokens
    rcfg = cfg.reduced()
    rparams = init_params(rcfg, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    rprompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32)
                for n in (21, 30, 17)]
    outs = {}
    for dev in ("cpu", "cuda"):
        reng = ServeEngine(rcfg, device=dev, params=rparams, max_batch=2,
                           max_seq=64)
        outs[dev] = reng.generate([Request(prompt=p, max_new_tokens=8, id=i)
                                   for i, p in enumerate(rprompts)])
    same = sum(outs["cuda"][i] == outs["cpu"][i] for i in outs["cpu"])
    agree = np.mean([a == b for i in outs["cpu"]
                     for a, b in zip(outs["cuda"][i], outs["cpu"][i])])
    say("ring", model=rcfg.name, window=rcfg.hybrid.window,
        prompt_tokens=",".join(str(len(p)) for p in rprompts),
        identical_requests=f"{same}/{len(rprompts)}",
        token_agreement_card_vs_cpu=round(float(agree), 4))
    if same != len(rprompts):
        failed.append(f"reduced ring-wrap run: the card's tokens differ from "
                      f"the CPU's ({agree:.4f} agree)")
    if failed:
        raise AssertionError("; ".join(failed))
    return counts


def profile_window(label: str, fn, out_dir: Path) -> None:
    """The window once on the host clock without the profiler, then once
    more under it for device time by kernel; busy share = device time /
    unprofiled wall time. `fn` returns how many units (steps, chunks,
    rounds) it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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


def phase_profile(out_dir: Path) -> None:
    """torch.profiler over the main paths at full width. qwen1.5-0.5b
    (int8, the config default): one 128-token prompt's prefill (4 chunks)
    and 16 batched decode steps of 4 rows; the same 16 steps with every
    projection in the array (kv int4, matmul_impl="imc", 8-bit
    activations). granite-3-2b (dual, int4): 8 stepwise decode steps of 4
    rows, and 4 speculative rounds (spec_k=4) of 4 rows with the dequant
    draft and with the imc4 draft. recurrentgemma-9b (int4 ring KV,
    slabs): 8 decode steps of 4 rows. Prints device time by kernel and the
    device's busy share of each window; full tables go to `out_dir`."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import Request, ServeEngine
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = get_arch("qwen1.5-0.5b")
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=129).astype(np.int32)
               for _ in range(4)]
    for i in range(2):           # warm-up: allocator, cuBLAS handles, library
        eng.add_request(Request(prompt=prompts[i], max_new_tokens=128, id=i))
    for _ in range(4):
        eng.step_all()
    next_id = iter(range(2, 4))

    def prefill_one():
        i = next(next_id)
        eng.add_request(Request(prompt=prompts[i], max_new_tokens=128, id=i))
        return 4                       # ceil(128 / 32) chunks

    def steps(engine, n):
        def run():
            for _ in range(n):
                engine.step_all()
            return n
        return run

    profile_window("prefill", prefill_one, out_dir)
    profile_window("decode", steps(eng, 16), out_dir)
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=eng.params, kv_mode="int4",
                      matmul_impl="imc", imc_abits=8)
    for i in range(4):
        eng.add_request(Request(prompt=prompts[i], max_new_tokens=128, id=i))
    steps(eng, 2)()                     # warm-up
    profile_window("qwen_imc_decode", steps(eng, 16), out_dir)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch("granite-3-2b")
    params = None
    for spec_k, draft, label, n in ((1, "dequant", "granite_decode", 8),
                                    (4, "dequant", "granite_spec", 4),
                                    (4, "imc4", "granite_spec_imc4", 4)):
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, seed=0, params=params,
                          spec_k=spec_k, spec_draft_impl=draft)
        params = eng.params
        rng = np.random.default_rng(1)
        for i in range(4):
            eng.add_request(Request(
                prompt=rng.integers(0, cfg.vocab, size=129).astype(np.int32),
                max_new_tokens=256, id=i))
        steps(eng, 2)()                 # warm-up
        profile_window(label, steps(eng, n), out_dir)
        del eng
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch("recurrentgemma-9b")
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=64, seed=0)
    rng = np.random.default_rng(2)
    for i in range(4):                  # prefilled token by token here
        eng.add_request(Request(
            prompt=rng.integers(0, cfg.vocab, size=17).astype(np.int32),
            max_new_tokens=32, id=i))
    steps(eng, 2)()                     # warm-up
    profile_window("hybrid_decode", steps(eng, 8), out_dir)


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
            "dense_matmul": check_dense(gen),
            "paged_kv_attention": check_attention(gen),
            "quantize_pack_kv": check_pack(gen),
            "quantize_pack_kv_masked": check_masked_pack(gen),
            "dual_plane_matmul": check_dual(gen),
            "paged_kv_attention_window": check_window(gen),
            "imc_dot": check_imc_dot(gen),
            "imc_dual_dot": check_imc_dual_dot(gen),
            "packed_kv_attention": check_packed_attention(gen),
            "quantize_pack_kv_integrity": check_integrity_pack(gen),
            "paged_kv_write": check_paged_write(gen)}
    qwen = phase_main(smi)
    granite = phase_granite(smi)
    imc = phase_imc(smi, qwen, granite)
    del qwen["params"], granite["params"]
    hybrid = phase_hybrid(smi)
    launches = {k: qwen["launches"][k] + granite["launches"][k]
                + imc[k] + hybrid[k] for k in qwen["launches"]}
    del qwen, granite
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
                        "shape": row["shape"],
                        **({"shapes": row["shapes"]} if "shapes" in row
                           else {})})
    if any(k["launches"] == 0 for k in kernels
           if k["name"] not in OFF_PATH):
        raise AssertionError(f"a kernel never launched on the main paths: "
                             f"{launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
