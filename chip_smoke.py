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
              widths, 64 (slot, head) rows a CTA, and minicpm-2b's KV=36);
              the dual buffers and the unpaired products (w_down, heads)
              of minicpm-2b and minitron-8b too; every row of
              the fixed-order GEMMs (ternary_matmul, dense_matmul) the
              same bits at every row count; the fused paged KV write at
              qwen's decode and prefill shapes (int8, int4) and granite's
              verify and commit shapes, every arena page >= 1 bit for bit
              against its plain version under each pool policy, beside
              the scatter it replaced and the kernels that scatter
              launched; the copy-on-write page op at qwen's full-width
              page, all four mode pairs at int4 and int8, every arena
              page >= 1 bit for bit against its plain route;
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
  7. share    qwen1.5-0.5b at kv int4 on 8 requests that share one
              120-token system prompt (tails of 16-72 tokens, 32 new):
              7a under augment-on-pressure at 24 Normal pages, sharing
              on (prefix_cache=4) against off: 1 miss and 7 hits,
              prefill dispatches saved, >= 7 copies on write, the masked
              pack launched (the Normal -> Augmented int4 copy); 7b
              always-augmented, retention 8: sharing off, on (tokens
              identical on 8/8), and on with retention faults (rate
              0.002, seed 1): every fault detected or masked, none
              pending, every request completed or failed with its
              retries used, every request recovery never touched
              identical to the fault-free run.
  8. obs      the observability plane and the serving CLI: 8a phase
              7b's faulted run with trace and metrics on and off (tokens
              identical on 8/8, every kernel's launches equal, the trace
              valid with no span open, every request's lane from enqueue
              to completed, the TTFT histogram within one log bucket of
              the trace's gaps at p50/p90/p99, the counters and fault-lane
              instants equal to stats()); 8b qwen kv int8 at spec_k=4,
              traced, on phase 4's requests (phase 4's speculative tokens
              on 8/8, draft and verify spans, one accepted_per_round
              sample a round); 8c the reduced recurrentgemma on slabs,
              traced (the mode mix equal to describe()'s reduction, the
              Augmented series sampled); 8d `python -m
              repro_torch.launch.serve` at full width as a subprocess
              (exit 0, 8 request lines, its trace valid, its metrics
              dump with amc_requests_completed 8). Times in the [obs]
              lines are the host's clock.
  9. ssm      9a full-width mamba2-130m (depth cut to 6 of its 24
              layers; d 768, 24 SSD heads of 64, state 128, random bf16
              weights; no hand-written
              kernel: the JAX package runs the family in XLA) on slabs, 8
              requests of 48-200 prompt tokens (prefilled token by token)
              and 32 new tokens, always-augmented at state_bits 8 and 4
              and at the config's default (Normal slabs), every request
              completed, the first decode step after a 32-token prefill
              within rel_err 0.05 of a CPU twin; 9b speculative decoding
              on slabs (spec_k=4, snapshot, drafts, restore, the verify
              scan): mamba2's tokens equal the stepwise run's on 8/8 with
              snapshots == rollbacks > 0, and full-width recurrentgemma's
              equal phase 6's on 4/4, kernel 6 launched 12 times in each
              verify step; 9c retention faults on mamba2's slabs
              (always-augmented, retention 4, rate 1.0, seed 1): faults
              injected, all detected or masked, none pending, every
              request completed or failed with its retries used, every
              request recovery never touched identical to the fault-free
              run; then with pin threshold 1 on 4 requests: slabs pinned
              to the Normal plane.
 10. moe      full-width, full-depth qwen3-moe-30b-a3b (48 layers, d
              2048, GQA 32/4, hd 128 with q/k norm, 128 experts top-8 of
              d_ff 768; 60.9 GB of random weights made on the card) on
              phase 4's requests: 10a as its config sets it (dual wk/wv,
              expert banks dense bf16, int4 KV): every request completed,
              one decode step launching expert_matmul 3 x 48, dense_matmul
              3 x 48 + 1 (wq, wo, the f32 router; the head), kernels 4, 2
              and W 48 each, nothing else; first prefill chunk, decode
              step and verify window through the kernels within rel_err
              0.05 of the plain route; 10b spec_k=4 (dequant draft)
              emitting 10a's tokens on 8/8; 10c ternary weights (2-bit
              banks through expert_matmul's 2-bit mode), depth cut to 8
              layers: launches and the same logit check. Phase 3 holds
              expert_matmul (bf16 and 2-bit banks at qwen3's shapes, M =
              1, 4, 16) to its plain version, each expert's rows to a
              one-expert dense_matmul / ternary_matmul call bit for bit,
              a row's bits to every M, and the router's f32 dense_matmul
              to every M.
 11. audio    full-width whisper-tiny (4 decoder layers, d 384, MHA 6 of
              64, vocab 51865, 1500 frames; dense bf16 weights, int8 KV;
              the cross KV on the paged pool's static prefix band, read
              by kernel 2 at the fixed length 1500): 11a the band read
              at B=4, lengths 1500/1500/0/1500 on a seeded band, rows of
              length > 0 within rel_err 0.03 of the plain version, the
              idle row finite, timed beside the plain version, gather +
              SDPA and its byte bound; 11b the first decode step after
              a 32-token stepwise prefill, kernel route against plain
              route, band filled, rel_err < 0.05; 11c phase 4's 8
              requests, 32 new, always-augmented, spec_k=4 (no verify
              step: stepwise, the same tokens on 8/8) and under
              augment-on-pressure (band pages augmented): every request
              completed, kernel 2 exactly 8 and W exactly 4 launches a
              dispatch, nothing else; 11d tests/test_faults.py:184 at
              full width (rate 1.0, retention 4): band pages healed from
              their host masters, the fault-free tokens.
 12. vlm      full-width, full-depth llama-3.2-vision-11b (40 layers = 8
              x (4 self + 1 gated cross), d 4096, GQA 32/8, hd 128, vocab
              128256, 1601 patches; ~19.6 GB of dense bf16 weights made on
              the card, the cross gates set non-zero; int4 KV pages for
              the self layers, the patch KV in a static slab store, one
              CompositeStore): 12a the first decode step after a
              16-token stepwise prefill, kernel route against plain
              route, the slab filled, rel_err < 0.05; 12b 4 requests of
              12-40 prompt tokens, 16 new: every request completed,
              kernel 2 and W exactly 32 launches a dispatch, nothing
              else, composite admission atomic, peak memory; 12a also
              probes its worst prefill step layer by layer (`[vlm_gap]`:
              each self layer's input and attention output against the
              plain route, the int4 K / V levels the step writes
              differently).
 13. archs    full-width, full-depth minicpm-2b (40 layers, d 2304, MHA
              36 of 64, d_ff 5760, tied head over 122880 rows) and
              minitron-8b (32 layers, d 4096, GQA 32/8 of 128, d_ff
              16384, untied 256000-row head), dual weights, int4 KV, on
              phase 4's requests: 13a every request completed, one decode
              step launching exactly kernel 4 2L times, dense_matmul
              3L + 1, kernels 2 and W L times, nothing else; the first
              prefill chunk, decode step and verify window within
              rel_err 0.05 of the plain route; 13b spec_k=4 (dequant
              draft) emitting 13a's tokens on 8/8; weight bytes, peak
              memory at init and serving.
 14. fleet    full-width qwen1.5-0.5b (ternary, kv int4, always-augmented)
              on an `ArrayFleet` of 2 arrays sharing cuda:0: 14a 2 x
              max_batch 2, least-loaded, against phase 4's single-array
              int4 run (tokens identical on 8/8, 4 placements an array,
              peak concurrency >= 3); 14b affinity with prefix_cache 4
              on phase 7b's shared-prefix stream ("prefix" decisions,
              every hit on one array, 7b's sharing-on tokens on 8/8);
              14c the requests piled onto array 0 (migrations, 14a's
              tokens on 8/8); 14d max_retries 0, the busiest array lost
              after 3 fleet steps (every request completed, none failed,
              the lost array empty, requests never on it equal to 14a's);
              14e 14a traced (a valid merged trace, lanes "array 0" /
              "array 1", 8 placement instants) and the CLI with
              --num-arrays 2 --placement affinity as a subprocess.
 15. train    full-width qwen1.5-0.5b (24 layers, d 1024, 464M
              parameters, bf16 master weights from seed 0) through the
              port's Trainer: SyntheticLM at batch 8 x seq 512, cosine
              schedule, lr 1e-3, warmup 3, remat "nothing", 30 steps.
              The stream draws from the first 512 token ids: at the
              full vocab its next-token map is not learnable in 30
              steps (15a runs 10 steps of that stream first, reported,
              losses finite). 15a AdamW: losses finite and falling, median step wall,
              tokens/s, share of the bf16 peak (8NT), kernels a step
              (torch's norm and the fixed-order norm), no launch of
              dense_matmul / expert_matmul / ternary_matmul, peak memory
              and the optimizer state's bytes; 15b AMC-Adam: the same,
              its state and peak memory beside AdamW's, final loss within
              5%; 15c one train step of reduced qwen and qwen3-moe on the
              card against the CPU (loss within 2e-2, every gradient leaf
              rel_err < 0.05); 15d 15a with a checkpoint every 10 steps
              and a SimulatedFailure at step 12: step 10 restored bit for
              bit, 30 losses, steps 13-30 against 15a's (bit-equal count
              printed, all within 2e-2); 15e the train CLI (amc_adamw,
              10 steps) as a subprocess, --mesh pod exits 2; 15f 15a's
              trained weights, 4 prompts of 128 tokens: the prefill step
              (the forward's packed cache) then 16 decode steps at kv
              int8 and int4, kernel 6 exactly 24 launches a step, the
              first step within 0.05 of the dequant route; the chunked
              prefill (4 chunks of 32) launching kernel 3 twice a layer
              a chunk at int4.
 16. fullseq  the full-sequence halves at full width, random weights from
              seed 0 made on the card: 16a mamba2-130m (24 layers)
              through the Trainer, AdamW, batch 8 x seq 512 (two 256-token
              SSD chunks), 30 steps over 15's stream (losses finite and
              falling; step wall, tokens/s, share of the bf16 peak (8NT),
              kernels a step, peak memory), then forward(return_cache)
              on 4 prompts of 256 tokens and 16 contiguous decode steps,
              the first within 0.05 of the same 257 tokens decoded one
              at a time; 16b recurrentgemma-9b (dense): the same
              hand-off with the int4 ring (kernel 6 exactly 12 a decode
              step, the first step within 0.05 of the dequant route; its
              gap to the stepwise-prefilled cache's step reported) and
              with the bf16 ring (the first step within 0.05 of the
              stepwise-prefilled cache's), and one train step at one
              macro-block + one tail layer (widths full) on the card
              against the CPU (loss within 2e-2, every gradient leaf
              rel_err < 0.05); 16c whisper-tiny (1500
              frames): forward(return_cache) at 4 x 64 and 16 decode
              steps at kv int8 and int4 (kernel 6 exactly 4 a step,
              nothing launched by the forward), the first within 0.05 of
              the dequant route, 30 AdamW steps at batch 8 x seq 448 with
              frames (losses falling), one train step card vs CPU; 16d
              llama-3.2-vision-11b (int4, 1601 patches, gates 0.8):
              forward(return_cache) at 2 x 64 and 8 decode steps (kernel
              6 exactly 32 a step), the first within 0.05 of the dequant
              route, one train step at one macro-block card vs CPU; 16e
              AugmentedStore on the card (4096 x 4096 with 2-bit trits;
              the base-3 default at 4095 x 4096): NORMAL ->
              AUGMENTED_DUAL -> push / peek / pop -> AUGMENTED_TERNARY ->
              NORMAL, FILO raising, force clobbering the low nibbles,
              expiry until refresh, physical bytes = the bytes held,
              every read bit-equal to the same store on the CPU.
 17. shard    the distributed layer (Rules on a DeviceMesh, DTensor
              parameters, optimizer state and batches): 17a full-width
              qwen1.5-0.5b through the Trainer on a 1-rank NCCL mesh,
              5 steps of 15a's configuration against the unsharded
              Trainer from the same parameters and batches (losses
              within 1e-3, the bit-equal count printed, both step walls
              (the DTensor host cost) and peak memories); 17b the
              sharded contiguous int4 chunked prefill (4 chunks of 32)
              -> 16 decode steps on the same mesh, kernel 3 exactly 48
              launches a chunk and kernel 6 exactly 24 a decode step on
              the local shards, logits within 0.05 of the unsharded
              steps (the bit-equal count printed); 17c where the machine
              has 4 cards, 17a's step on a 2x2 NCCL mesh within 2e-2 of
              17a's losses, the compressed all-reduce over the pod axis
              and a 2-stage pipeline (else a line saying it skipped).
 18. dryrun   the dry run (a meta-device trace, `launch/dryrun.py`)
              against the card: 18a 15a's configuration on a (1, 1)
              stand-in mesh, the dry run's parameter + optimizer bytes
              equal to the Trainer's state on the card and the traced
              FLOPs equal to FlopCounterMode's count of one real step,
              exactly (the median step wall and the traced compute time's
              share of it printed, and the trace's peak live bytes beside
              the card's peak above the state over 4 steps); 18b full-width qwen's contiguous int4
              decode step and prefill chunk (kernel route), each
              kernel's launches predicted by the trace equal to those of
              one step on the card; 18c the int4 and int8 kernel-route
              decode steps under the analyzer's shape watch make no bf16
              (B, S, KV, hd) tensor in either dim order (int8: no float32
              one), while the dequant route (the positive control) makes
              one.
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
JSON row names the JAX package's XLA product as `replaces`. Neither has
expert_matmul, the same kernel over a MoE layer's E expert banks in one
launch (the expert in grid y; bf16 or 2-bit banks), whose row names the
JAX package's expert-bank product.
Phase 3 also checks the masked pack (launched on the main path only by
phase 7a's copies on write) and the fused-integrity pack, which no
serving path launches (the JAX package calls it from none): its JSON
row shows 0 launches.
The second-to-last lines are the kernels JSON and the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile [DIR]

profiles the main paths at full width instead (device time by kernel and
the device's busy share of qwen's prefill, decode and IMC decode windows,
of granite's stepwise decode and speculative rounds with the dequant and
the imc4 draft, and of recurrentgemma's, mamba2's, qwen3-moe's,
whisper-tiny's, llama-3.2-vision-11b's, minicpm-2b's and minitron-8b's
decode, a 2-array qwen fleet's rounds and full-width qwen's train
steps; the profiler tables are written to DIR, default profile_out/).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
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
    # port-only: the JAX package's expert-bank product (an XLA einsum, or a
    # lax.map of kernel 1 over a ternary bank) in `expert_proj`
    "expert_matmul": ("src/repro_torch/kernels/csrc/ternary_matmul.cu",
                      "src/repro/models/augment.py:127"),
}
# kernels no serving path launches, checked and timed, launches 0: the
# fused integrity pack (the JAX package calls it from no serving path
# either; the pool's page words are plain torch)
OFF_PATH = ("quantize_pack_kv_integrity",)


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
    every row's bits independent of M. Also minicpm-2b's and minitron-8b's
    w_down (K=5760 N=2304, K=16384 N=4096) and heads (tied "nk" K=2304
    N=122880, untied "kn" K=4096 N=256000). The JSON row is granite's
    decode w_down; "shapes" holds the others."""
    from repro_torch.kernels.ternary_matmul import (dense_matmul_cuda,
                                                    dense_matmul_plain,
                                                    split_plan)
    dev = torch.device("cuda")
    row = {"max_abs_err": 0.0, "shapes": []}
    cases = [("kn", 8192, 2048), ("kn", 2048, 2048), ("nk", 1024, 151936),
             ("nk", 2048, 49408),
             # minicpm-2b's and minitron-8b's w_down (the unpaired product
             # at the widest K), minicpm's tied head, minitron's untied one
             ("kn", 5760, 2304), ("kn", 16384, 4096), ("nk", 2304, 122880),
             ("kn", 4096, 256000)]
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


def check_expert(gen) -> dict:
    """The expert GEMM at qwen3-moe's banks (E=128): gate/up (K=2048,
    N=768) and down (768, 2048), bf16 (dual mode's banks) and 2-bit
    (ternary mode's), at M = 1, 4 (decode) and 16 (verify): each expert's
    rows bit-identical to `dense_matmul` / `ternary_matmul` on that expert
    alone, a row's bits the same at every M, within 2^-7 (bf16) / 0.01
    (2-bit) of the expert-at-a-time f32 plain version; timed beside the
    plain version and `torch.bmm` (the 2-bit bank dequantized to bf16).
    Also the router's f32 `dense_matmul` (K=2048, N=128): rows the same
    bits at every M, within 1e-5 of x.float() @ w.float(). The JSON row is
    the decode gate/up bf16 shape; "shapes" holds the others."""
    from repro_torch.core.ternary import unpack_ternary_2bit
    from repro_torch.kernels.ternary_matmul import (dense_matmul_cuda,
                                                    dense_matmul_plain,
                                                    expert_matmul_cuda,
                                                    expert_matmul_plain,
                                                    split_plan,
                                                    ternary_matmul_cuda)
    dev = torch.device("cuda")
    E = 128
    row = {"max_abs_err": 0.0, "shapes": []}

    def bank(kind, K, N):
        if kind == "ternary":
            return (torch.stack([_trits(gen, K, N) for _ in range(E)]),
                    torch.rand((E, N), generator=gen, device=dev) * 0.05)
        return ((torch.randn((E, K, N), generator=gen, device=dev)
                 / K ** 0.5).to(torch.bfloat16), None)

    for kind in ("bf16", "ternary"):
        for K, N in ((2048, 768), (768, 2048)):
            w, scale = bank(kind, K, N)
            x = torch.randn((E, 16, K), generator=gen, device=dev
                            ).to(torch.bfloat16)
            full = expert_matmul_cuda(x, w, scale)
            for e in range(E):
                one = (dense_matmul_cuda(x[e], w[e]) if scale is None
                       else ternary_matmul_cuda(x[e], w[e],
                                                scale[e:e + 1]))
                if not torch.equal(full[e], one):
                    raise AssertionError(f"expert_matmul {kind} K={K} "
                                         f"N={N}: expert {e} differs from "
                                         f"its one-expert call")
            for m in (1, 4):
                if not torch.equal(expert_matmul_cuda(
                        x[:, :m].contiguous(), w, scale), full[:, :m]):
                    raise AssertionError(f"expert_matmul {kind} K={K} "
                                         f"N={N}: rows depend on M ({m})")
            wb = w.numel() * w.element_size()
            n_copy = copies_for(wb)
            banks = [(w, scale)] + [bank(kind, K, N)
                                    for _ in range(n_copy - 1)]
            dense = [b if s is None else torch.stack([
                (unpack_ternary_2bit(b[e], K).float() * s[e]
                 ).to(torch.bfloat16) for e in range(E)])
                for b, s in banks]
            for M in (1, 4, 16):
                sets = [(torch.randn((E, M, K), generator=gen, device=dev
                                     ).to(torch.bfloat16), b, s)
                        for b, s in banks]
                got = expert_matmul_cuda(*sets[0])
                want = expert_matmul_plain(*sets[0])
                torch.cuda.synchronize()
                err = rel_err(got, want)
                row["max_abs_err"] = max(row["max_abs_err"],
                                         max_abs(got, want))
                tol = 2 ** -7 if kind == "bf16" else 1e-2
                if not err < tol:
                    raise AssertionError(f"expert_matmul {kind} M={M} "
                                         f"K={K} N={N}: rel_err={err}")
                ms = time_ms(expert_matmul_cuda, sets)
                plain_ms = time_ms(expert_matmul_plain, sets, iters=4)
                lib_ms = time_ms(torch.bmm, [(a, d) for (a, _, _), d
                                             in zip(sets, dense)])
                b_ms, b_by = bound_ms(E * M * K * 2 + wb
                                      + (0 if scale is None else E * N * 4)
                                      + E * M * N * 2, 2 * E * M * K * N)
                say("kernel", name="expert_matmul", bank=kind, E=E, M=M,
                    K=K, N=N, splits=split_plan(K, N), rel_err=f"{err:.3e}",
                    rows_independent_of_m=True, one_expert_bits=True,
                    ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                    library_ms=f"{lib_ms:.5f}",
                    library=repr("torch.bmm (cuBLAS), bf16 bank"),
                    bound_ms=f"{b_ms:.5f}", bound_by=b_by)
                shape = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             shape=f"{kind} E={E} M={M} K={K} N={N}")
                if (kind, M, K) == ("bf16", 4, 2048):
                    row.update(shape)
                else:
                    row["shapes"].append(shape)
            del banks, dense, sets
    # the router: f32 out of the bf16 GEMM, 128 experts
    w = (torch.randn((2048, E), generator=gen, device=dev) / 2048 ** 0.5
         ).to(torch.bfloat16)
    x = torch.randn((40, 2048), generator=gen, device=dev).to(torch.bfloat16)
    full = dense_matmul_cuda(x, w, out_dtype=torch.float32)
    err = rel_err(full, dense_matmul_plain(x, w, out_dtype=torch.float32))
    same = all(torch.equal(dense_matmul_cuda(x[:m].contiguous(), w,
                                             out_dtype=torch.float32),
                           full[:m]) for m in (1, 4, 16))
    say("kernel", name="dense_matmul", use="moe router, f32 out", M=40,
        K=2048, N=E, splits=split_plan(2048, E), rel_err=f"{err:.3e}",
        rows_independent_of_m=same)
    if not (same and err < 1e-5):
        raise AssertionError(f"router f32 GEMM: rows independent of M "
                             f"{same}, rel_err {err}")
    # its time at a decode step's 4 rows and a verify window's 16, beside
    # the plain version (x.float() @ w.float(), cuBLAS: also the library
    # call); main() files the decode row under dense_matmul's shapes
    ws = [w] + [(torch.randn((2048, E), generator=gen, device=dev)
                 / 2048 ** 0.5).to(torch.bfloat16) for _ in range(63)]
    for M in (4, 16):
        sets = [(torch.randn((M, 2048), generator=gen, device=dev
                             ).to(torch.bfloat16), w_) for w_ in ws]
        ms = time_ms(lambda a, b: dense_matmul_cuda(
            a, b, out_dtype=torch.float32), sets)
        plain_ms = time_ms(lambda a, b: dense_matmul_plain(
            a, b, out_dtype=torch.float32), sets)
        b_ms, b_by = bound_ms(M * 2048 * 2 + 2048 * E * 2 + M * E * 4,
                              2 * M * 2048 * E)
        say("kernel", name="dense_matmul", use="moe router, f32 out", M=M,
            K=2048, N=E, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{plain_ms:.5f}",
            library=repr("x.float() @ w.float() (cuBLAS)"),
            bound_ms=f"{b_ms:.6f}", bound_by=b_by)
        if M == 4:
            row["router"] = dict(ms=ms, plain_ms=plain_ms,
                                 library_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by,
                                 shape=f"router f32 M={M} K=2048 N={E}")
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
    """qwen's decode read (B=4, KV=16, Hg=1 and a GQA Hg=4, kv 8 and 4),
    granite's (KV=8, Hg=4, int4) and minicpm-2b's (KV=36, Hg=1, int4),
    lengths 1 / 512 / 200 / 77 over mixed pages. The JSON row is qwen's int8 read; "shapes" holds the
    others."""
    from repro_torch.kernels.paged_kv_attention import (
        paged_gather_kv, paged_kv_attention_cuda, paged_kv_attention_plain)
    dev = torch.device("cuda")
    D, page, maxP = 64, 16, 32
    lengths = [1, maxP * page, 200, 77]
    B = len(lengths)
    row = {"max_abs_err": 0.0, "shapes": []}
    for KV, Hg, kv_bits in ((16, 1, 8), (16, 4, 8), (16, 1, 4), (16, 4, 4),
                            (8, 4, 4), (36, 1, 4)):
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


# (K, N) of the dual buffers served: granite-3-2b's wkv and w_gate_up,
# minicpm-2b's, minitron-8b's (K is d_model; N one plane's columns)
DUAL_SHAPES = ((2048, 512), (2048, 8192), (2304, 2304), (2304, 5760),
               (4096, 1024), (4096, 16384))


def check_dual(gen) -> dict:
    """The dual buffers at every served width (`DUAL_SHAPES`: granite's
    wkv (K=2048, N=512) and w_gate_up (K=2048, N=8192), minicpm-2b's
    (2304, 2304) / (2304, 5760), minitron-8b's (4096, 1024) /
    (4096, 16384)) at decode (M=4, the GEMV), verify (M=16, 16-row
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
    for K, N in DUAL_SHAPES:
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
        for K, N in DUAL_SHAPES:
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
            # the float64 plain version holds two K x N float64 planes a
            # call: few calls a graph at the widest buffers
            plain_ms = time_ms(dual_plane_matmul_plain, sets,
                               iters=40 if K * N <= 2048 * 8192 else 4)
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
    int4 read; "shapes" holds the others (minicpm-2b's verify read, KV=36
    Hg=1 D=64 W=4, among them)."""
    from repro_torch.kernels.paged_kv_attention import (
        paged_gather_kv, paged_kv_attention_cuda,
        paged_kv_attention_window_cuda, paged_kv_attention_window_plain)
    dev = torch.device("cuda")
    B, page, maxP = 4, 16, 32
    row = {"max_abs_err": 0.0, "shapes": []}
    for KV, W, Hg, D, kv_bits in ((8, 4, 4, 64, 8), (8, 4, 4, 64, 4),
                                  (8, 16, 4, 128, 4), (36, 4, 1, 64, 4)):
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
                    kv_bits=kv_bits, KV=KV, W=W, Hg=Hg, D=D):
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
        if (KV, W, kv_bits) == (8, 4, 4):     # granite's KV mode
            row.update(shape)
        else:
            row["shapes"].append(shape)
    return row


def check_masked_pack(gen) -> dict:
    """The masked pack at a copy-on-write page copy's shape (one K or V
    plane of a qwen page: 24 layers x 16 KV heads x 16 tokens, the first
    8 tokens of each kept, as phase 7a's copies keep them), at granite's
    window rows (4 rows x 4 slots x 8 KV heads) and a larger batch, about
    half the rows rejected. The JSON row is the copy-on-write shape."""
    from repro_torch.kernels.quantize_pack_kv import (
        quantize_pack_kv_masked_cuda, quantize_pack_kv_plain)
    dev = torch.device("cuda")
    D = 64
    cow_n = 24 * 16 * 16
    row = {"max_abs_err": 0.0}
    for N in (cow_n, 4 * 4 * 8, 4 * 32 * 16):
        sets = []
        for _ in range(copies_for(N * D * 2)):
            x = (torch.randn((N, D), generator=gen, device=dev)
                 * torch.rand((N, 1), generator=gen, device=dev) * 8)
            x[0] = 0.0
            if N == cow_n:                  # token < keep, keep = 8
                valid = (torch.arange(N, device=dev) % 16) < 8
            else:
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
        if N == cow_n:
            row.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by,
                       shape=f"N={N} D={D} rejected={N - kept}")
    return row


def check_cow(gen) -> None:
    """`_cow_page_op` at qwen's full-width page (24 layers, 16 KV heads,
    page 16, hd 64) for all four mode pairs at int4 and int8, on the card
    through the kernels (kernel 3b on the Normal -> Augmented int4 leg)
    against the same op with the plain versions, on the card: every arena
    page >= 1 bit-identical, and the copy's page written."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize_pack_kv import quantize_pack_kv_plain
    from repro_torch.serve.cache_pool import _cow_page_op
    dev = torch.device("cuda")
    Lg, N, KV, P, D = 24, 4, 16, 16, 64
    base = ops.quantize_pack_kv

    def plain_pack(kv, valid=None):           # ops.quantize_pack_kv, plain
        lead, D = kv.shape[:-1], kv.shape[-1]
        p, s = quantize_pack_kv_plain(kv.reshape(-1, D), None if valid is None
                                      else torch.broadcast_to(valid, lead))
        return (p.reshape(*lead, D // 2),
                s.reshape(*lead, 1).to(torch.bfloat16))

    for bits in (4, 8):
        ds = D // 2 if bits == 4 else D
        for src_mode in (0, 1):
            for dst_mode in (0, 1):
                for keep in (8, 13):
                    if bits == 4:
                        kp = torch.randint(0, 256, (Lg, N, KV, P, ds),
                                           generator=gen, device=dev,
                                           dtype=torch.uint8)
                    else:
                        kp = torch.randint(-127, 128, (Lg, N, KV, P, ds),
                                           generator=gen, device=dev,
                                           dtype=torch.int8)
                    arenas = {
                        "kn": torch.randn((Lg, N, KV, P, D), generator=gen,
                                          device=dev).to(torch.bfloat16),
                        "kp": kp, "vp": kp.flip(0).contiguous(),
                        "ks": (torch.rand((Lg, N, KV, P), generator=gen,
                                          device=dev) * 0.1).to(
                            torch.bfloat16)}
                    arenas["vn"] = -arenas["kn"] * 3
                    arenas["vs"] = arenas["ks"].flip(0).contiguous()
                    plain = {k: v.clone() for k, v in arenas.items()}
                    before = {k: v.clone() for k, v in arenas.items()}
                    _cow_page_op(arenas, 1, 2, keep, src_mode=src_mode,
                                 dst_mode=dst_mode, aug_bits=bits)
                    ops.quantize_pack_kv = plain_pack
                    try:
                        _cow_page_op(plain, 1, 2, keep, src_mode=src_mode,
                                     dst_mode=dst_mode, aug_bits=bits)
                    finally:
                        ops.quantize_pack_kv = base
                    torch.cuda.synchronize()
                    for k in arenas:
                        if not torch.equal(raw(arenas[k][:, 1:]),
                                           raw(plain[k][:, 1:])):
                            raise AssertionError(
                                f"_cow_page_op {src_mode}->{dst_mode} "
                                f"int{bits} keep={keep}: {k} differs from "
                                f"the plain version")
                    dst = ("kn", "vn") if dst_mode == 0 else ("kp", "vp")
                    if any(torch.equal(raw(arenas[k][:, 2]),
                                       raw(before[k][:, 2])) for k in dst):
                        raise AssertionError("the copy wrote no page")
        say("cow", bits=bits, page=f"({Lg},{KV},{P},{D})",
            mode_pairs="00,01,10,11", keeps="8,13", pages_equal=True)


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
    of <= 56 tokens), a GQA shape, and the contiguous qwen1.5-0.5b decode
    of phase 15f (KV=16, Hg=1, D=64, S=144 = bs, int8 and int4, lengths
    at both ends of its 129..144), and phase 16's whisper-tiny (KV=6,
    Hg=1, D=64, S=80, int8 and int4) and llama-3.2-vision (KV=8, Hg=4,
    D=128, S=72, int4) decode steps; every output within rel_err 0.03
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
             (4, 4, 4, 64, 1024, 256, 4, (12, 300, 1024, 700)),
             (4, 16, 1, 64, 144, 144, 8, (128, 129, 143, 144)),
             (4, 16, 1, 64, 144, 144, 4, (128, 129, 143, 144)),
             # phase 16c / 16d: whisper's and vlm's contiguous decode, a
             # 64-token prompt in a 64 + 16 (+ 8) slot horizon
             (4, 6, 1, 64, 80, 80, 8, (65, 70, 75, 80)),
             (4, 6, 1, 64, 80, 80, 4, (65, 70, 75, 80)),
             (2, 8, 4, 128, 72, 72, 4, (65, 72))]
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
    """Kernels one call of `fn` puts on the device (torch.profiler). The
    profiled window also launches a sentinel, `torch.cuda._sleep(1)`
    (ATen's `spin_kernel`), before the call: a trace without the
    sentinel's event is broken and taken again, up to eight times (a
    card's profiler drops it now and then: three in a row once, PR 28
    call 4), then raises. A trace that holds the sentinel counts every
    other device event, so a call that launched nothing reads 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        sentinel = sum("spin_kernel" in n for n in names)
        if sentinel == 1:
            return len(names) - 1
    raise AssertionError(f"profiler trace without its sentinel kernel eight "
                         f"times (last: {sentinel} sentinel events among "
                         f"{len(names)})")


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


def serve_once(eng, prompts, max_new: int = 32, complete: bool = True) -> dict:
    """Serve the prompts, `max_new` new tokens each, on `eng` with every
    launch count set to 0 just before and read just after; host clock
    synchronised around each prompt's prefill (decode time is the
    rest). Fails unless every request completed, or with `complete`
    False leaves that to the caller (a request may end in `eng.failed`)."""
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
    if complete and (sorted(out) != list(range(len(prompts))) or
                     any(len(out[i]) != max_new for i in range(len(prompts)))):
        raise AssertionError(f"not every request completed: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    st = eng.stats()
    decode_s = wall - timing["prefill_s"]
    pool = st["pool"]        # a composite store names each part's policy
    pool_mode = pool["pool_mode"] if "pool_mode" in pool else "+".join(
        f"{name}:{p['pool_mode']}" for name, p in pool["parts"].items())
    line = dict(requests=len(out), new_tokens=sum(map(len, out.values())),
                prefill_tokens=timing["prefill_tokens"],
                prefill_tok_s=round(timing["prefill_tokens"]
                                    / timing["prefill_s"], 3),
                decode_tok_s=round(sum(map(len, out.values())) / decode_s,
                                   3),
                wall_s=round(wall, 3), steps=eng.step_idx,
                dispatches=eng.dispatch_count,
                preemptions=st["preemptions"], refreshes=st["refreshes"],
                augment_events=st["augment_events"],
                pool_mode=pool_mode,
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
    packed weights, and the int4 run's tokens, wall and ledger (phase 5
    compares the IMC run with them, phase 14 the fleet's)."""
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
    outs, walls = {}, {}
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
        walls[kv_mode] = run["line"]["wall_s"]
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
            "int4_wall_s": walls["int4"], "int4_imc": imc_stats,
            "prompts": prompts, "spec_out": run["out"]}


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
# phase 7: shared prefixes and retention faults
# ---------------------------------------------------------------------------

def share_prompts(vocab: int) -> list:
    """8 prompts: one 120-token system prompt (numpy, seed 0) and a tail
    of 16-72 tokens each. 120 is not a multiple of the page size, so a hit
    maps the entry's boundary page and copies it at its first write."""
    rng = np.random.default_rng(0)
    sys_p = rng.integers(0, vocab, size=120).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(0, vocab, size=int(n))
                            .astype(np.int32)])
            for n in rng.integers(16, 73, size=8)]


def phase_share(smi: str, params) -> dict:
    """qwen1.5-0.5b (ternary weights, kv int4) serving the shared-prefix
    stream: 7a under augment-on-pressure with a budget of 24 Normal pages,
    prefix_cache=4 against 0; 7b always-augmented with retention 8 and
    prefix_cache=4, fault-free against fault_rate 0.002 (fault seed 1).
    Returns the launch counts and 7b's sharing-on tokens (phase 14b's
    reference)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.cache_pool import PageGeometry
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("qwen1.5-0.5b")
    prompts = share_prompts(cfg.vocab)
    launches = {k: 0 for k in ops.KERNELS}
    normal_page = PageGeometry(cfg.n_layers, cfg.n_kv_heads, cfg.hd,
                               cfg.amc.page_size, 4).page_bytes_normal
    common = dict(device="cuda", max_batch=4, max_seq=512, prefill_chunk=32,
                  params=params, kv_mode="int4")
    failed = []
    # 7a: prefix sharing on against off
    outs, runs = {}, {}
    for pc in (4, 0):
        eng = ServeEngine(cfg, **common, pool_mode="augment-on-pressure",
                          pool_budget_bytes=24 * normal_page,
                          prefix_cache=pc)
        peak = [0]
        step_all = eng.step_all

        def sampled(step_all=step_all, eng=eng, peak=peak):
            out = step_all()
            peak[0] = max(peak[0], eng.store.bytes_shared())
            return out

        eng.step_all = sampled
        run = serve_once(eng, prompts)
        counts = run["counts"]
        need = ["ternary_matmul", "dense_matmul", "paged_kv_attention",
                "paged_kv_write", "quantize_pack_kv"]
        if pc:
            need.append("quantize_pack_kv_masked")
        require_launches(counts, need, f"{cfg.name} prefix_cache={pc}")
        for k in launches:
            launches[k] += counts[k]
        pre = run["stats"]["prefix"]
        say("share", model=cfg.name, kv_mode="int4", budget_normal_pages=24,
            prefix_cache=pc, **run["line"],
            prefill_dispatches=pre["prefill_dispatches"],
            **({k: pre[k] for k in ("hits", "misses", "dispatches_saved",
                                    "cow_events", "cow_bytes", "demotions",
                                    "evictions")} if pc else {}),
            peak_bytes_shared=peak[0],
            masked_pack_launches=counts["quantize_pack_kv_masked"],
            launches=json.dumps(counts), card=repr(smi))
        outs[pc], runs[pc] = run["out"], run
        del eng
        torch.cuda.empty_cache()
    pre = runs[4]["stats"]["prefix"]
    # reported, not bound: under this budget the two runs augment
    # different Normal pages (sharing changes how many are live), and an
    # augmented page's int4 rounding changes what later steps read; the
    # sharing invariant is bound below, on runs that migrate no page
    same = sum(outs[4][i] == outs[0][i] for i in outs[0])
    say("agreement", model=cfg.name, part="7a",
        pool_mode="augment-on-pressure",
        sharing_vs_off_identical_requests=f"{same}/{len(outs[0])}")
    if (pre["hits"], pre["misses"]) != (7, 1) \
            or pre["dispatches_saved"] <= 0 or pre["cow_events"] < 7:
        failed.append(f"7a: hits {pre['hits']}, misses {pre['misses']}, "
                      f"dispatches saved {pre['dispatches_saved']}, "
                      f"copies {pre['cow_events']}")
    # 7b: retention faults with healing against the fault-free run, and
    # the fault-free run against sharing off (every page written once at
    # int4 and never migrated: the reference's sharing invariant, bound)
    touched: set = set()
    retries_at_failure: dict = {}
    for pc, rate in ((0, 0.0), (4, 0.0), (4, 0.002)):
        eng = ServeEngine(cfg, **common, pool_mode="always-augmented",
                          retention_steps=8, prefix_cache=pc,
                          fault_rate=rate, fault_seed=1)
        for name in ("_heal_row_recompute", "_preempt"):
            hook = getattr(eng, name)

            def record(row, hook=hook, eng=eng):
                touched.add(eng._slot_entry[row].req.id)
                hook(row)

            setattr(eng, name, record)
        fail_row = eng._fail_row

        def record_failure(row, fail_row=fail_row, eng=eng):
            entry = eng._slot_entry[row]
            retries_at_failure[entry.req.id] = entry.fault_retries
            fail_row(row)

        eng._fail_row = record_failure
        run = serve_once(eng, prompts, complete=rate == 0.0)
        counts = run["counts"]
        require_launches(counts, ["ternary_matmul", "dense_matmul",
                                  "paged_kv_attention", "paged_kv_write"],
                         f"{cfg.name} fault_rate={rate}")
        for k in launches:
            launches[k] += counts[k]
        fl = run["stats"]["faults"]
        say("faults", model=cfg.name, kv_mode="int4", retention_steps=8,
            prefix_cache=pc, fault_rate=rate, fault_seed=1, **run["line"],
            **{k: run["stats"]["prefix"][k] for k in (
                "prefill_dispatches", "cow_events") if pc},
            **{k: fl[k] for k in ("faults_injected", "faults_detected",
                                  "faults_masked", "faults_pending",
                                  "refresh_misses", "integrity_checks",
                                  "recovered_scrub", "recovered_recompute",
                                  "uncorrectable", "zero_silent_corruption")},
            failed=sorted(eng.failed), touched=sorted(touched),
            launches=json.dumps(counts), card=repr(smi))
        if pc == 0:
            off = run["out"]
            continue
        if rate == 0.0:
            golden, touched = run["out"], set()
            same = sum(golden[i] == off[i] for i in off)
            say("agreement", model=cfg.name, part="7b",
                pool_mode="always-augmented",
                sharing_vs_off_identical_requests=f"{same}/{len(off)}")
            if same != len(off):
                failed.append(f"7b: sharing changed the tokens of "
                              f"{len(off) - same}/{len(off)} requests")
            continue
        out, ids = run["out"], set(range(len(prompts)))
        retries_used = all(retries_at_failure.get(i) == cfg.amc.max_retries
                           for i in eng.failed)
        if not fl["faults_injected"] \
                or fl["faults_injected"] != (fl["faults_detected"]
                                             + fl["faults_masked"]) \
                or fl["faults_pending"] or not fl["zero_silent_corruption"]:
            failed.append(f"7b: fault accounting {fl}")
        if set(out) | set(eng.failed) != ids or set(out) & set(eng.failed) \
                or any(len(out[i]) != 32 for i in out) or not retries_used:
            failed.append(f"7b: requests neither completed nor failed: "
                          f"{ {k: len(v) for k, v in out.items()} }, "
                          f"failed {sorted(eng.failed)}")
        clean = [i for i in out if i not in touched]
        bad = [i for i in clean if out[i] != golden[i]]
        redone = [i for i in out if i in touched]
        say("agreement", model=cfg.name, part="7b",
            untouched_identical=f"{len(clean) - len(bad)}/{len(clean)}",
            recomputed_identical=f"{sum(out[i] == golden[i] for i in redone)}"
                                 f"/{len(redone)}",
            completed=len(out), failed=len(eng.failed))
        if bad:
            failed.append(f"7b: requests {bad} untouched by recovery differ "
                          f"from the fault-free run")
        del eng
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": launches, "share_on": golden}


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
    counts of the full-width run, and its weights, prompts and tokens
    (phase 9b serves them again speculatively)."""
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
    stepwise_out = run["out"]
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
    gc.collect()
    torch.cuda.empty_cache()
    failed = []
    if not errs["decode"] < 0.05:
        failed.append(f"{cfg.name} kernel vs plain route, first decode step: "
                      f"rel_err {errs['decode']}")

    # the ring wraps: a 16-slot window, prompts of 17-30 tokens; cuBLAS
    # and the CPU's matmuls may part by a bf16 ulp (0.0078 here), so the
    # prompts (seed 8) keep every emitted token's CPU top-1/top-2 margin
    # over 0.01, checked (seed 5 sits on a one-ulp tie since the hybrid
    # gate rounds its GELU as JAX does)
    rcfg = cfg.reduced()
    rparams = init_params(rcfg, seed=5, device="cpu")
    rng = np.random.default_rng(8)
    rprompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32)
                for n in (21, 30, 17)]
    outs, margin = {}, [float("inf")]
    for dev in ("cpu", "cuda"):
        reng = ServeEngine(rcfg, device=dev, params=rparams, max_batch=2,
                           max_seq=64)
        if dev == "cpu":
            base, stepwise = reng._dispatch, reng._prefill_stepwise
            prefilling = [False]

            def stepwise_flagged(slot, tokens, stepwise=stepwise,
                                 prefilling=prefilling):
                prefilling[0] = True
                try:
                    return stepwise(slot, tokens)
                finally:
                    prefilling[0] = False

            def dispatch(fn, batch, base=base, prefilling=prefilling):
                logits = base(fn, batch)
                if not prefilling[0]:
                    top = logits[batch["write_mask"], -1,
                                 :rcfg.vocab].float().topk(2).values
                    margin[0] = min(margin[0],
                                    float((top[:, 0] - top[:, 1]).min()))
                return logits

            reng._dispatch, reng._prefill_stepwise = (dispatch,
                                                      stepwise_flagged)
        outs[dev] = reng.generate([Request(prompt=p, max_new_tokens=8, id=i)
                                   for i, p in enumerate(rprompts)])
    same = sum(outs["cuda"][i] == outs["cpu"][i] for i in outs["cpu"])
    agree = np.mean([a == b for i in outs["cpu"]
                     for a, b in zip(outs["cuda"][i], outs["cpu"][i])])
    say("ring", model=rcfg.name, window=rcfg.hybrid.window,
        prompt_tokens=",".join(str(len(p)) for p in rprompts),
        identical_requests=f"{same}/{len(rprompts)}",
        token_agreement_card_vs_cpu=round(float(agree), 4),
        cpu_min_margin=margin[0])
    if not margin[0] > 0.01:
        failed.append(f"reduced ring-wrap run: the prompts sit on a "
                      f"near-tie (CPU margin {margin[0]})")
    if same != len(rprompts):
        failed.append(f"reduced ring-wrap run: the card's tokens differ from "
                      f"the CPU's ({agree:.4f} agree)")
    if failed:
        raise AssertionError("; ".join(failed))
    return {"counts": counts, "params": params, "prompts": prompts,
            "out": stepwise_out}

# ---------------------------------------------------------------------------
# phase 8: the observability plane and the serving CLI
# ---------------------------------------------------------------------------

def _lanes(events: list) -> dict:
    """tid -> the names of its timed events, in trace order."""
    lanes: dict = {}
    for e in events:
        if e["ph"] != "M":
            lanes.setdefault(e["tid"], []).append(e["name"])
    return lanes


def obs_checks(eng, out: dict) -> list:
    """8a's checks of one traced run: the trace validates with no span
    open, every request's lane holds its whole lifecycle, the TTFT
    histogram agrees with the trace's enqueue -> first_token gaps within
    one log bucket at p50/p90/p99, and the counters and fault-lane
    instants equal stats()."""
    from repro_torch import obs
    st = eng.stats()
    trace = eng.obs.tracer.chrome_trace()
    events = trace["traceEvents"]
    failed = [f"trace: {p}" for p in obs.validate_chrome_trace(trace)]
    if eng.obs.tracer.open_spans():
        failed.append(f"{eng.obs.tracer.open_spans()} spans left open")
    lanes = _lanes(events)
    for rid in range(len(out) + len(eng.failed)):
        names = lanes.get(obs.REQ_TRACK_BASE + rid, [])
        end = "completed" if rid in out else "failed"
        missing = [n for n in ("enqueue", "queue", "active", "prefill_chunk",
                               "first_token", end) if n not in names]
        if missing:
            failed.append(f"request {rid}'s lane lacks {missing}")
    enq, first = {}, {}
    for e in events:
        if e["ph"] == "i" and e["name"] == "enqueue":
            enq[e["tid"]] = e["ts"]
        elif e["ph"] == "i" and e["name"] == "first_token":
            first.setdefault(e["tid"], e["ts"])
    ref = obs.LogHistogram()
    for tid in first:
        ref.observe((first[tid] - enq[tid]) * 1e-6)
    h = st["obs"]["histograms"]["ttft_s"]
    for p in (50, 90, 99):
        if not ref.within_one_bucket(ref.percentile(p), h[f"p{p}"]):
            failed.append(f"ttft p{p}: histogram {h[f'p{p}']} vs trace "
                          f"{ref.percentile(p)}")
    c, fl = st["obs"]["counters"], st["faults"]
    fault_lane = lanes.get(obs.FAULT_TRACK, [])
    want = {"tokens_emitted": sum(map(len, out.values())),
            "requests_completed": len(out),
            "store_augment": st["augment_events"],
            "fault_inject": fl["faults_injected"],
            "fault_detect": fl["faults_detected"]}
    for k, v in want.items():
        if c.get(k, 0) != v:
            failed.append(f"counter {k}={c.get(k, 0)}, stats say {v}")
    lane = {"inject": fl["faults_injected"], "detect": fl["faults_detected"],
            "heal_scrub": fl["recovered_scrub"],
            "heal_recompute": fl["recovered_recompute"]}
    for k, v in lane.items():
        if fault_lane.count(k) != v:
            failed.append(f"fault lane: {fault_lane.count(k)} {k}, "
                          f"stats say {v}")
    return failed


def phase_obs(smi: str, params, main_prompts: list,
              spec_out: dict) -> dict:
    """8a: phase 7b's faulted run traced (trace and metrics on) and
    untraced: the same tokens and launches, `obs_checks`. 8b: qwen kv int8
    at spec_k=4, traced, on phase 4's requests: phase 4's speculative
    tokens, draft and verify spans, one accepted_per_round sample a
    round. 8c: the reduced recurrentgemma on slabs, traced: the mode mix
    against describe()'s reduction, the Augmented series sampled. 8d: the
    CLI at full width as a subprocess, its trace and metrics files.
    Returns the launch counts of 8a-8c."""
    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("qwen1.5-0.5b")
    launches = {k: 0 for k in ops.KERNELS}
    failed = []
    # 8a: traced against untraced, the faulted shared-prefix stream
    prompts = share_prompts(cfg.vocab)
    runs = {}
    for on in (True, False):
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, params=params, kv_mode="int4",
                          pool_mode="always-augmented", retention_steps=8,
                          prefix_cache=4, fault_rate=0.002, fault_seed=1,
                          trace=on, metrics=on)
        run = serve_once(eng, prompts, complete=False)
        runs[on] = run
        for k in launches:
            launches[k] += run["counts"][k]
        if on:
            failed += [f"8a: {f}" for f in obs_checks(eng, run["out"])]
            trace = eng.obs.tracer.chrome_trace()
            h = run["stats"]["obs"]["histograms"]
            traced = dict(events=len(trace["traceEvents"]),
                          trace_bytes=len(json.dumps(trace)),
                          ttft_p50_s=h["ttft_s"]["p50"],
                          ttft_p99_s=h["ttft_s"]["p99"],
                          step_p50_s=h["step_wall_s"]["p50"],
                          faults=run["stats"]["faults"]["faults_injected"])
        del eng
        torch.cuda.empty_cache()
    same = sum(runs[True]["out"].get(i) == runs[False]["out"].get(i)
               for i in range(len(prompts)))
    if same != len(prompts):
        failed.append(f"8a: tracing changed the tokens of "
                      f"{len(prompts) - same}/{len(prompts)} requests")
    if runs[True]["counts"] != runs[False]["counts"]:
        failed.append(f"8a: launches differ with tracing on "
                      f"{runs[True]['counts']} and off "
                      f"{runs[False]['counts']}")
    say("obs", part="8a", model=cfg.name, kv_mode="int4",
        fault_rate=0.002, identical_requests=f"{same}/{len(prompts)}",
        launches_equal=runs[True]["counts"] == runs[False]["counts"],
        **traced, wall_on_s=runs[True]["line"]["wall_s"],
        wall_off_s=runs[False]["line"]["wall_s"],
        launches=json.dumps(runs[True]["counts"]), card=repr(smi))
    # 8b: speculative decode, traced
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=params, spec_k=4,
                      trace=True, metrics=True)
    run = serve_once(eng, main_prompts)
    for k in launches:
        launches[k] += run["counts"][k]
    st = run["stats"]
    names = [e["name"] for e in eng.obs.tracer.chrome_trace()["traceEvents"]]
    same = sum(run["out"][i] == spec_out[i] for i in spec_out)
    rounds = st["obs"]["histograms"]["accepted_per_round"]["count"]
    say("obs", part="8b", model=cfg.name, kv_mode="int8", spec_k=4,
        identical_to_phase4=f"{same}/{len(spec_out)}",
        spec_rounds=st["spec"]["spec_rounds"], accepted_per_round_n=rounds,
        spec_draft_spans=names.count("spec_draft"),
        spec_verify_spans=names.count("spec_verify"),
        wall_s=run["line"]["wall_s"], card=repr(smi))
    if same != len(spec_out):
        failed.append(f"8b: traced speculative tokens differ from phase "
                      f"4's on {len(spec_out) - same} requests")
    if "spec_draft" not in names or "spec_verify" not in names \
            or rounds != st["spec"]["spec_rounds"]:
        failed.append(f"8b: {names.count('spec_draft')} draft and "
                      f"{names.count('spec_verify')} verify spans, "
                      f"{rounds} round samples for "
                      f"{st['spec']['spec_rounds']} rounds")
    del eng
    torch.cuda.empty_cache()
    # 8c: the slab store, traced
    rcfg = get_arch("recurrentgemma-9b").reduced()
    rparams = init_params(rcfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    rprompts = [rng.integers(0, rcfg.vocab, size=6).astype(np.int32)
                for _ in range(3)]
    eng = ServeEngine(rcfg, device="cuda", max_batch=2, max_seq=32,
                      params=rparams, pool_mode="always-augmented",
                      trace=True, metrics=True)
    run = serve_once(eng, rprompts, max_new=6)
    for k in launches:
        launches[k] += run["counts"][k]
    pool = run["stats"]["pool"]
    mix = eng.store.mode_mix()
    series = eng.obs.metrics.dump_timeseries().get("mode_augmented", [])
    say("obs", part="8c", model=rcfg.name, pool_mode="always-augmented",
        mode_mix=list(mix), describe=[pool["slabs_live_normal"],
                                      pool["slabs_live_augmented"]],
        mode_augmented_samples=len(series),
        mode_augmented_peak=max((v for _, v in series), default=0),
        card=repr(smi))
    if mix != (pool["slabs_live_normal"], pool["slabs_live_augmented"]) \
            or not any(v > 0 for _, v in series):
        failed.append(f"8c: mode mix {mix} vs describe {pool}, "
                      f"mode_augmented series {series}")
    del eng, rparams
    torch.cuda.empty_cache()
    # 8d: the CLI at full width, as a user starts it
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    tpath, mpath = out_dir / "trace.json", out_dir / "metrics.prom"
    for f in (tpath, mpath):
        f.unlink(missing_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         cfg.name, "--requests", "8", "--prompt-len", "48",
         "--shared-prefix", "120", "--prefix-cache", "4", "--max-new", "32",
         "--max-batch", "4", "--max-seq", "512", "--trace-out", str(tpath),
         "--metrics-out", str(mpath)],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=600)
    reqs = [ln for ln in res.stdout.splitlines()
            if ln.startswith("[serve] req ")]
    problems = (obs.validate_chrome_trace_file(str(tpath))
                if tpath.exists() else ["no trace written"])
    prom = mpath.read_text() if mpath.exists() else ""
    say("obs", part="8d", rc=res.returncode, req_lines=len(reqs),
        trace_problems=len(problems), trace_bytes=(tpath.stat().st_size
                                                   if tpath.exists() else 0),
        completed_8="amc_requests_completed 8" in prom,
        seconds=round(time.perf_counter() - t0, 3))
    for ln in res.stdout.splitlines():
        if ln.startswith("[serve]") and not ln.startswith("[serve] req "):
            print(ln, flush=True)
    if res.returncode != 0 or len(reqs) != 8 or problems \
            or "amc_requests_completed 8" not in prom:
        failed.append(f"8d: CLI rc {res.returncode}, {len(reqs)} request "
                      f"lines, trace problems {problems[:3]}, stderr "
                      f"{res.stderr[-2000:]}")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 9: the ssm family, and slab speculation and faults
# ---------------------------------------------------------------------------

def ssm_twin_check(cfg, params, gen, prompt: int = 32) -> float:
    """4 rows from fresh slabs: `prompt` stepwise dispatches on the card,
    then the next decode step on the card and on CPU copies of the params
    and the slab planes. Returns the logits' rel_err."""
    from repro_torch.serve import state_store
    dev = torch.device("cuda")
    B, V = 4, cfg.vocab
    store = state_store.make_store(cfg, max_batch=B, max_seq=256, device=dev)
    for r in range(B):
        store.admit_row(r, prompt + 1, step=0)
    decode = state_store.make_step_fns(cfg)["decode"]
    toks = torch.randint(0, V, (B, prompt + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    state = store.state
    with torch.no_grad():
        for i in range(prompt + 1):
            batch = {**store.device_tables(), "tokens": toks[:, i:i + 1],
                     "positions": torch.full((B,), i, dtype=torch.int32,
                                             device=dev),
                     "write_mask": torch.ones(B, dtype=torch.bool,
                                              device=dev)}
            if i == prompt:
                lc, _ = decode(_to_cpu(params), _to_cpu(state),
                               _to_cpu(batch))
            lk, state = decode(params, state, batch)
    return rel_err(lk[..., :V].cpu(), lc[..., :V])


def fault_run(eng, prompts, golden: dict, label: str, smi: str,
              failed: list) -> dict:
    """Serve `prompts` on a faulted engine and hold it to the fault
    contract: faults injected, every one detected or masked, none
    pending, every request completed or failed with its retries used,
    every request recovery never touched identical to `golden`."""
    touched: set = set()
    retries_at_failure: dict = {}
    for name in ("_heal_row_recompute", "_preempt"):
        hook = getattr(eng, name)

        def record(row, hook=hook):
            touched.add(eng._slot_entry[row].req.id)
            hook(row)

        setattr(eng, name, record)
    fail_row = eng._fail_row

    def record_failure(row):
        entry = eng._slot_entry[row]
        retries_at_failure[entry.req.id] = entry.fault_retries
        fail_row(row)

    eng._fail_row = record_failure
    run = serve_once(eng, prompts, complete=False)
    fl, pool = run["stats"]["faults"], run["stats"]["pool"]
    say("faults", model=eng.cfg.name, part=label,
        state_bits=pool["state_bits"],
        retention_steps=pool["retention_steps"],
        fault_rate=eng.cfg.amc.fault_rate, fault_seed=eng.cfg.amc.fault_seed,
        pin_threshold=eng.cfg.amc.fault_pin_threshold, **run["line"],
        **{k: fl[k] for k in ("faults_injected", "faults_detected",
                              "faults_masked", "faults_pending",
                              "refresh_misses", "integrity_checks",
                              "pinned_normal", "recovered_recompute",
                              "uncorrectable", "zero_silent_corruption")},
        failed=sorted(eng.failed), touched=sorted(touched), card=repr(smi))
    out, ids = run["out"], set(range(len(prompts)))
    if not fl["faults_injected"] \
            or fl["faults_injected"] != (fl["faults_detected"]
                                         + fl["faults_masked"]) \
            or fl["faults_pending"] or not fl["zero_silent_corruption"]:
        failed.append(f"9c {label}: fault accounting {fl}")
    retries_used = all(retries_at_failure.get(i) == eng.cfg.amc.max_retries
                       for i in eng.failed)
    if set(out) | set(eng.failed) != ids or set(out) & set(eng.failed) \
            or any(len(out[i]) != 32 for i in out) or not retries_used:
        failed.append(f"9c {label}: requests neither completed nor failed: "
                      f"{ {k: len(v) for k, v in out.items()} }, failed "
                      f"{sorted(eng.failed)}")
    clean = [i for i in out if i not in touched]
    bad = [i for i in clean if out[i] != golden[i]]
    redone = [i for i in out if i in touched]
    say("agreement", model=eng.cfg.name, part=label,
        untouched_identical=f"{len(clean) - len(bad)}/{len(clean)}",
        recomputed_identical=f"{sum(out[i] == golden[i] for i in redone)}"
                             f"/{len(redone)}",
        completed=len(out), failed=len(eng.failed))
    if bad:
        failed.append(f"9c {label}: requests {bad} untouched by recovery "
                      f"differ from the fault-free run")
    return fl


SSM_DEPTH = 6


def phase_ssm(smi: str, hybrid: dict) -> dict:
    """9a: full-width mamba2-130m (depth cut to 6 of its 24 layers; d
    768, 24 SSD heads of 64, state 128, random bf16 weights) on
    `AugmentedStatePool` slabs, 8
    requests of 48-200 prompt tokens (prefilled token by token) and 32 new
    tokens, always-augmented at state_bits 8 and 4 and at the config's
    default (Normal slabs); the first decode step after a 32-token prefill
    against a CPU twin. 9b: speculative decoding on slabs (spec_k=4):
    mamba2 on 9a's requests, and full-width recurrentgemma-9b on phase 6's
    (kernel 6 in every verify step), each against its stepwise tokens.
    9c: retention faults on mamba2's slabs (always-augmented, retention 4,
    rate 1.0, seed 1), then with pin threshold 1. Returns the launch
    counts of every run."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, tree_nbytes
    from repro_torch.serve import ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    # depth cut to 6 of the 24 layers (widths full): the phase is
    # host-bound serving, a token a dispatch (its walls scale with the
    # layers), and the smoke's time limit has room for phase 16 only
    # with this cut
    cfg = dataclasses.replace(get_arch("mamba2-130m"), n_layers=SSM_DEPTH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("setup", model=cfg.name, n_layers=cfg.n_layers,
        params_s=round(time.perf_counter() - t0, 3),
        weight_bytes=tree_nbytes(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    spec_bytes = {k: s.nbytes // 4 for k, s in
                  M.abstract_cache(cfg, 4, 256).items()}
    launches, outs, failed = None, {}, []

    def add(counts):
        nonlocal launches
        launches = dict(counts) if launches is None else {
            k: launches[k] + counts[k] for k in launches}

    def with_amc(**kw):
        return dataclasses.replace(cfg, amc=dataclasses.replace(cfg.amc,
                                                                **kw))

    gen = torch.Generator(device="cuda").manual_seed(9)
    for label, amc in (("aug8", dict(pool_mode="always-augmented",
                                     state_bits=8)),
                       ("aug4", dict(pool_mode="always-augmented",
                                     state_bits=4)),
                       ("default", {})):
        c = with_amc(**amc)
        eng = ServeEngine(c, device="cuda", max_batch=4, max_seq=256,
                          params=params)
        run = serve_once(eng, prompts)
        add(run["counts"])
        outs[label] = run["out"]
        pool = run["stats"]["pool"]
        if pool["slab_bytes_normal"] != sum(spec_bytes.values()):
            failed.append(f"9a {label}: a Normal slab is "
                          f"{pool['slab_bytes_normal']} B, not "
                          f"{spec_bytes} from abstract_cache")
        say("main", model=cfg.name, part="9a", **run["line"],
            state_bits=pool["state_bits"],
            slab_bytes_normal=pool["slab_bytes_normal"],
            slab_bytes_aug=pool["slab_bytes_aug"],
            ssd_state_bytes=spec_bytes["ssd_state"],
            conv_state_bytes=spec_bytes["conv_state"],
            promote_events=pool["promote_events"],
            restamps=pool["refreshes"] - pool["promote_events"],
            launches=json.dumps({k: v for k, v in run["counts"].items()
                                 if v}), card=repr(smi))
        if label != "aug4":
            t1 = time.perf_counter()
            err = ssm_twin_check(c, params, gen)
            say("logits", model=cfg.name, part="9a",
                pool_mode=pool["pool_mode"], prompt_tokens=32,
                decode_rel_err_vs_cpu=f"{err:.3e}",
                seconds=round(time.perf_counter() - t1, 3))
            if not err < 0.05:
                failed.append(f"9a {label}: first decode step on the card "
                              f"vs the CPU twin, rel_err {err}")
        del eng
        torch.cuda.empty_cache()

    # 9b: speculation on slabs, against the stepwise tokens
    W = 4
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=256,
                      params=params, spec_k=W)
    run = serve_once(eng, prompts)
    add(run["counts"])
    st = run["stats"]
    say("spec", model=cfg.name, part="9b", spec_k=W, **run["line"],
        spec_snapshots=st["pool"]["spec_snapshots"],
        spec_rollbacks=st["pool"]["spec_rollbacks"],
        accepted_tokens_per_round=round(
            st["spec"]["accepted_tokens_per_round"], 4), card=repr(smi))
    msg = spec_agreement(cfg.name, st["spec"]["spec_draft_impl"],
                         run["out"], outs["default"])
    if msg:
        failed.append("9b: " + msg)
    if not st["pool"]["spec_snapshots"] == st["pool"]["spec_rollbacks"] > 0:
        failed.append(f"9b: snapshots {st['pool']['spec_snapshots']} vs "
                      f"rollbacks {st['pool']['spec_rollbacks']}")
    del eng
    torch.cuda.empty_cache()

    hcfg = get_arch("recurrentgemma-9b")
    n_attn = hcfg.n_layers // len(hcfg.hybrid.pattern)
    eng = ServeEngine(hcfg, device="cuda", max_batch=4, max_seq=64,
                      params=hybrid["params"], spec_k=W)
    run = serve_once(eng, hybrid["prompts"], max_new=16)
    add(run["counts"])
    st = run["stats"]
    sp = st["spec"]
    # the stepwise prefill and every verify step read the ring through
    # kernel 6; the dequant draft reads it through the plain route
    draft_kernel = sp["spec_draft_impl"] not in ("dequant", "dense")
    want6 = n_attn * (eng.prefill_dispatch_count
                      + W * sp["verify_dispatches"]
                      + draft_kernel * sp["draft_dispatches"])
    say("spec", model=hcfg.name, part="9b", spec_k=W, **run["line"],
        spec_rounds=sp["spec_rounds"],
        accepted_tokens_per_round=round(sp["accepted_tokens_per_round"], 4),
        kernel6=run["counts"]["packed_kv_attention"], kernel6_expected=want6,
        kernel6_per_round=round((run["counts"]["packed_kv_attention"]
                                 - n_attn * eng.prefill_dispatch_count)
                                / sp["spec_rounds"], 3),
        spec_snapshots=st["pool"]["spec_snapshots"], card=repr(smi))
    msg = spec_agreement(hcfg.name, sp["spec_draft_impl"], run["out"],
                         hybrid["out"])
    if msg:
        failed.append("9b: " + msg)
    if run["counts"]["packed_kv_attention"] != want6:
        failed.append(f"9b: kernel 6 launched "
                      f"{run['counts']['packed_kv_attention']} times, not "
                      f"{want6}")
    del eng, run
    hybrid.pop("params")
    gc.collect()
    torch.cuda.empty_cache()

    # 9c: retention faults on slabs, healed by a stepwise re-prefill
    for label, kw, n in (("chaos", {}, 8),
                         ("pinned", dict(fault_pin_threshold=1), 4)):
        c = with_amc(pool_mode="always-augmented", fault_rate=1.0,
                     fault_seed=1, **kw)
        eng = ServeEngine(c, device="cuda", max_batch=4, max_seq=256,
                          params=params, retention_steps=4)
        fl = fault_run(eng, prompts[:n], outs["aug8"], label, smi, failed)
        if label == "pinned" and not fl["pinned_normal"]:
            failed.append(f"9c pinned: no slab pinned to Normal: {fl}")
        del eng
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 10: the moe family
# ---------------------------------------------------------------------------

def decode_step_launches(cfg, params) -> dict:
    """Each kernel's launches in one kernel-route decode step of 4 rows
    after a 32-token prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serve.cache_pool import PagedKVPool
    dev = torch.device("cuda")
    B, C, V = 4, 32, cfg.vocab
    pool = PagedKVPool(cfg, max_batch=B, max_seq=512, device=dev)
    for r in range(B):
        pool.admit_row(r, C + 1, step=0)
    tables = pool.device_tables()
    gen = torch.Generator(device="cuda").manual_seed(3)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    with torch.no_grad():
        lp, _ = M.paged_prefill_step(cfg, params, pool.arenas, {
            **tables, "write_mask": ones,
            "tokens": torch.randint(0, V, (B, C), generator=gen, device=dev,
                                    dtype=torch.int32),
            "positions": torch.zeros(B, dtype=torch.int32, device=dev)})
        ops.reset_launch_counts()
        M.paged_decode_step(cfg, params, pool.arenas, {
            **tables, "write_mask": ones,
            "tokens": lp[:, -1, :V].argmax(-1).to(torch.int32)[:, None],
            "positions": torch.full((B,), C, dtype=torch.int32,
                                    device=dev)})
        torch.cuda.synchronize()
    return {k: v for k, v in ops.launch_counts().items() if v}


def phase_moe(smi: str) -> dict:
    """10a: full-width, full-depth qwen3-moe-30b-a3b as its config sets it
    (dual weights: wk/wv paired, expert banks dense bf16; int4 KV),
    random weights from seed 0 made on the card, served on phase 4's 8
    requests: every request completed, each kernel's launches in one
    decode step exactly as the path needs them, the first prefill chunk,
    decode step and verify window through the kernels within rel_err
    0.05 of the plain route. 10b: spec_k=4 (dequant draft) emits 10a's
    tokens on 8/8. 10c: ternary weights (the 2-bit banks through the
    expert GEMM's 2-bit mode), depth cut to 8 layers: served, launches,
    the same logit check. Returns the launch counts of every run."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("qwen3-moe-30b-a3b")
    L = cfg.n_layers
    rng = np.random.default_rng(0)              # phase 4's requests
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    launches = {k: 0 for k in ops.KERNELS}

    def dense_of(c):
        return dataclasses.replace(c, amc=dataclasses.replace(
            c.amc, weight_mode="normal"))

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def decode_launches(c, params, want: dict) -> None:
        counts = decode_step_launches(c, params)
        if counts != want:
            raise AssertionError(f"{c.name} {c.amc.weight_mode}: launches "
                                 f"in one decode step {counts}, want {want}")

    # 10a: the config as it stands
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(dense_of(cfg), seed=0, device="cuda")
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=params)
    params = eng.params                   # wk/wv packed, banks as drawn
    torch.cuda.synchronize()
    weight_bytes = eng.stats()["weight_bytes_physical"]
    say("setup", model=cfg.name, params_s=round(time.perf_counter() - t0, 3),
        weight_bytes=weight_bytes,
        init_peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    run = serve_once(eng, prompts)
    counts = run["counts"]
    require_launches(counts, ["expert_matmul", "dense_matmul",
                              "dual_plane_matmul", "paged_kv_attention",
                              "paged_kv_write"], cfg.name)
    add(counts)
    stepwise = run["out"]
    del eng
    torch.cuda.empty_cache()
    decode_launches(cfg, params, {
        "expert_matmul": 3 * L, "dense_matmul": 3 * L + 1,
        "dual_plane_matmul": L, "paged_kv_attention": L,
        "paged_kv_write": L})
    say("main", model=cfg.name, weight_mode=cfg.amc.weight_mode,
        kv_mode=cfg.amc.kv_mode, **run["line"],
        weight_bytes=weight_bytes,
        energy_pj_per_token=round(
            run["stats"]["imc"]["energy_pj_per_token"], 3),
        launches=json.dumps(counts), card=repr(smi))
    gen = torch.Generator(device="cuda").manual_seed(4)
    first_step_logits_check(cfg, params, cfg.amc.kv_mode, gen, window=4)

    # 10b: speculative decoding, the dequant draft
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=params, spec_k=4)
    run = serve_once(eng, prompts)
    counts = run["counts"]
    require_launches(counts, ["expert_matmul", "dense_matmul",
                              "dual_plane_matmul",
                              "paged_kv_attention_window", "paged_kv_write"],
                     f"{cfg.name} spec_k=4")
    add(counts)
    sp = run["stats"]["spec"]
    say("main", model=cfg.name, weight_mode=cfg.amc.weight_mode,
        kv_mode=cfg.amc.kv_mode, spec_k=4, **run["line"],
        rounds=sp["spec_rounds"],
        accepted_per_round=round(sp["accepted_tokens_per_round"], 4),
        launches=json.dumps(counts), card=repr(smi))
    failed = spec_agreement(cfg.name, "dequant", run["out"], stepwise)
    del eng, params, run
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(failed)

    # 10c: ternary weights, 8 layers
    tcfg = dataclasses.replace(cfg, n_layers=8, amc=dataclasses.replace(
        cfg.amc, weight_mode="ternary"))
    L = tcfg.n_layers
    params = init_params(dense_of(tcfg), seed=0, device="cuda")
    eng = ServeEngine(tcfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, params=params)
    params = eng.params
    weight_bytes = eng.stats()["weight_bytes_physical"]
    run = serve_once(eng, prompts)
    counts = run["counts"]
    require_launches(counts, ["expert_matmul", "ternary_matmul",
                              "dense_matmul", "paged_kv_attention",
                              "paged_kv_write"], f"{cfg.name} ternary")
    add(counts)
    del eng
    torch.cuda.empty_cache()
    decode_launches(tcfg, params, {
        "expert_matmul": 3 * L, "ternary_matmul": 4 * L,
        "dense_matmul": L + 1, "paged_kv_attention": L,
        "paged_kv_write": L})
    say("main", model=cfg.name, weight_mode="ternary", n_layers=L,
        kv_mode=tcfg.amc.kv_mode, **run["line"],
        weight_bytes=weight_bytes,
        energy_pj_per_token=round(
            run["stats"]["imc"]["energy_pj_per_token"], 3),
        launches=json.dumps(counts), card=repr(smi))
    first_step_logits_check(tcfg, params, tcfg.amc.kv_mode, gen, window=4,
                            label="ternary, 8 layers")
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 11 / 12: the static-plane families (audio, vlm)
# ---------------------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def fill_static_plane(store, gen) -> None:
    """Seeded random values in the static plane, in place: every page of
    the audio pool's two planes (the prefix band's among them; a decode
    page is written before a read reaches it), or the vlm patch slab's
    Normal plane."""
    dev = torch.device("cuda")
    if store.kind == "composite":
        for v in store.parts["prefix"].state["normal"].values():
            v.copy_(torch.randn(v.shape, generator=gen, device=dev))
        return
    for k, v in store.arenas.items():
        if v.dtype == torch.bfloat16 and k in ("ks", "vs"):
            v.copy_(torch.rand(v.shape, generator=gen, device=dev) * 0.02)
        elif v.dtype == torch.bfloat16:
            v.copy_(torch.randn(v.shape, generator=gen, device=dev) * 0.5)
        else:
            lo, hi = (0, 256) if v.dtype == torch.uint8 else (-127, 128)
            v.copy_(torch.randint(lo, hi, v.shape, generator=gen,
                                  device=dev, dtype=v.dtype))


def static_route_check(cfg, params, gen, prompt: int) -> dict:
    """4 rows at full width on a fresh store whose static plane holds
    seeded random values: `prompt` stepwise dispatches, then the first
    decode step, each from the same state through the kernel route and
    the plain route (matmul_impl="dense", kv_impl="dequant", on a copy of
    the state); the state advances along the kernel route. Returns the
    decode step's logits rel_err and the worst prefill step's."""
    from repro_torch.serve import state_store
    dev = torch.device("cuda")
    pcfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, matmul_impl="dense", kv_impl="dequant"))
    B, V = 4, cfg.vocab
    store = state_store.make_store(cfg, max_batch=B, max_seq=64, device=dev)
    for r in range(B):
        if not store.admit_row(r, prompt + 1, step=0):
            raise AssertionError(f"{cfg.name}: row {r} not admitted")
    fill_static_plane(store, gen)
    kdec = state_store.make_step_fns(cfg)["decode"]
    pdec = state_store.make_step_fns(pcfg)["decode"]
    toks = torch.randint(0, V, (B, prompt + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    errs = []
    with torch.no_grad():
        for i in range(prompt + 1):
            batch = {**store.device_tables(), "tokens": toks[:, i:i + 1],
                     "positions": torch.full((B,), i, dtype=torch.int32,
                                             device=dev),
                     "write_mask": torch.ones(B, dtype=torch.bool,
                                              device=dev)}
            snap = _clone(store.state)
            lk, store.state = kdec(params, store.state, batch)
            lp, _ = pdec(params, snap, batch)
            if not (torch.isfinite(lk[..., :V]).all()
                    and torch.isfinite(lp[..., :V]).all()):
                raise AssertionError(f"{cfg.name}: non-finite logits at "
                                     f"step {i}")
            errs.append(rel_err(lk[..., :V], lp[..., :V]))
            del snap
    worst = int(np.argmax(errs[:prompt]))
    return {"decode": errs[prompt], "prefill_worst": errs[worst],
            "prefill_worst_position": worst}


def vlm_gap_probe(cfg, params, seed: int, prompt: int, position: int
                  ) -> dict:
    """Where 12a's worst stepwise-prefill step parts between the routes:
    `static_route_check`'s run (the same seed, so the same slab and
    tokens) up to `position` along the kernel route, then that step once
    through each route from the same state, recording every self layer's
    input and attention-block output. Returns, per self layer, the input's
    and the attention output's rel_err (kernel vs plain), whether the
    attention output's bits differ, and how many int4 K / V levels of the
    token the step writes differ between the two routes' arenas."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import state_store
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pcfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, matmul_impl="dense", kv_impl="dequant"))
    B, V = 4, cfg.vocab
    store = state_store.make_store(cfg, max_batch=B, max_seq=64, device=dev)
    for r in range(B):
        store.admit_row(r, prompt + 1, step=0)
    fill_static_plane(store, gen)
    kdec = state_store.make_step_fns(cfg)["decode"]
    pdec = state_store.make_step_fns(pcfg)["decode"]
    toks = torch.randint(0, V, (B, prompt + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    orig = T.attn_block_decode_paged
    rec: list = []

    def recording(cfg_, p, x, *a, **kw):
        out = orig(cfg_, p, x, *a, **kw)
        rec.append((x.clone(), out.clone()))
        return out

    def batch_at(i):
        return {**store.device_tables(), "tokens": toks[:, i:i + 1],
                "positions": torch.full((B,), i, dtype=torch.int32,
                                        device=dev),
                "write_mask": torch.ones(B, dtype=torch.bool, device=dev)}

    with torch.no_grad():
        for i in range(position):
            _, store.state = kdec(params, store.state, batch_at(i))
        batch = batch_at(position)
        snap = _clone(store.state)
        T.attn_block_decode_paged = recording
        try:
            lk, store.state = kdec(params, store.state, batch)
            k_rec, rec[:] = rec[:], []
            lp, snap = pdec(params, snap, batch)
            p_rec = rec[:]
        finally:
            T.attn_block_decode_paged = orig
        torch.cuda.synchronize()
    out = {"logits_rel_err": rel_err(lk[..., :V], lp[..., :V]),
           "x_rel": [], "attn_rel": [], "attn_bits_differ": [],
           "kv_levels_differ": []}
    ka, pa = store.state["kv"], snap["kv"]
    for layer, ((xk, ak), (xp, ap)) in enumerate(zip(k_rec, p_rec)):
        out["x_rel"].append(float(f"{rel_err(xk, xp):.3e}"))
        out["attn_rel"].append(float(f"{rel_err(ak, ap):.3e}"))
        out["attn_bits_differ"].append(int((raw(ak) != raw(ap)).sum()))
        levels = 0
        for plane in ("kp", "vp"):
            a, b = ka[plane][layer], pa[plane][layer]
            levels += int(((a & 15) != (b & 15)).sum()
                          + ((a >> 4) != (b >> 4)).sum())
        out["kv_levels_differ"].append(levels)
    del store, snap
    return out


def per_dispatch_launches(counts: dict, dispatches: int, want: dict,
                          what: str) -> None:
    """Every dispatch of a run launched exactly `want` (kernel -> launches
    a dispatch) and no other kernel."""
    need = {k: v * dispatches for k, v in want.items()}
    got = {k: v for k, v in counts.items() if v}
    if got != need:
        raise AssertionError(f"{what}: launches {got} over {dispatches} "
                             f"dispatches, want {need}")


def check_band_read(gen) -> dict:
    """11a: the audio family's cross read, kernel 2 through
    `ops.paged_prefix_attention`, at whisper-tiny's shapes (B=4, KV=6,
    Hg=1, D=64, int8, page 16, a 94-page band: 1500 frames), lengths
    1500 / 1500 / 0 / 1500 on a seeded band (the idle row's table the
    dump page 0, Normal). Rows of length > 0 within rel_err 0.03 of the
    plain version, the idle row finite; timed beside the plain version
    and gather + SDPA. Returns the JSON row's shape entry."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_kv_attention import (
        paged_gather_kv, paged_kv_attention_plain)
    dev = torch.device("cuda")
    B, KV, Hg, D, page, maxP, kv_bits = 4, 6, 1, 64, 16, 94, 8
    lengths = [1500, 1500, 0, 1500]
    pool = list(_pool(gen, B, KV, D, page, maxP, kv_bits, lengths))
    pool[7][2], pool[8][2] = 0, 0             # the idle slot's table
    n_copy = copies_for(sum(t.numel() * t.element_size()
                            for t in pool[:6]) // 4)
    sets = []
    for i in range(n_copy):
        q = torch.randn((B, KV, Hg, D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        sets.append((q,) + (tuple(pool) if i == 0 else
                            tuple(t.clone() for t in pool[:6])
                            + tuple(pool[6:])))
    args = sets[0]
    got = ops.paged_prefix_attention(*args, kv_bits=kv_bits)
    want = paged_kv_attention_plain(*args, kv_bits=kv_bits)
    torch.cuda.synchronize()
    live = args[7] > 0
    err = rel_err(got[live], want[live])
    if not (err < 0.03 and bool(torch.isfinite(got).all())):
        raise AssertionError(f"band read: rel_err={err}, finite="
                             f"{bool(torch.isfinite(got).all())}")

    def library(q, kn, vn, kp, vp, ks, vs, lens, table, modes):
        k, v = paged_gather_kv(kn, vn, kp, vp, ks, vs, table, modes,
                               kv_bits=kv_bits)
        mask = (torch.arange(k.shape[2], device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, KV * Hg, 1, D), k.to(torch.bfloat16),
            v.to(torch.bfloat16), attn_mask=mask)

    ms = time_ms(lambda *a: ops.paged_prefix_attention(
        *a, kv_bits=kv_bits), sets)
    plain_ms = time_ms(lambda *a: paged_kv_attention_plain(
        *a, kv_bits=kv_bits), sets)
    lib_ms = time_ms(library, sets)
    n_bytes, n_ops = _attention_bytes_ops(B, KV, Hg, D, page, maxP, kv_bits,
                                          lengths, args[9].cpu())
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    say("kernel", name="paged_kv_attention", read="prefix band (11a)",
        kv_bits=kv_bits, Hg=Hg, B=B, KV=KV, D=D, band_pages=maxP,
        lengths=",".join(map(str, lengths)), rel_err=f"{err:.3e}",
        idle_row_finite=True, **split_grid(B, KV, 1, Hg, page, maxP),
        ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
        library_ms=f"{lib_ms:.5f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=max_abs(got[live], want[live]),
                shape=f"prefix band B={B} KV={KV} Hg={Hg} D={D} page={page} "
                      f"band_pages={maxP} kv_bits={kv_bits} "
                      f"lengths={lengths}")


def phase_audio(smi: str, gen) -> dict:
    """11: full-width whisper-tiny (4 decoder layers, d 384, MHA 6 of 64,
    vocab 51865, 1500 frames; dense bf16 weights; int8 KV, its cross KV on
    the pool's static prefix band). 11a the band read (`check_band_read`);
    11b the first decode step after a 32-token stepwise prefill, kernel
    route against plain route, band filled; 11c phase 4's 8 requests, 32
    new, always-augmented, spec_k=4 and augment-on-pressure at a budget
    of half the rows' Normal pages (band pages among the augmented): every
    request completed, kernel 2 exactly 8 and W exactly 4 launches a
    dispatch, nothing else, the spec_k=4 tokens the stepwise ones on 8/8
    with no speculative round; 11d tests/test_faults.py:184 at full
    width: rate-1.0 faults at retention 4 heal from the band's masters
    with the fault-free tokens. Returns the launch counts and the band
    read's JSON shape."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    band = check_band_read(gen)
    cfg = get_arch("whisper-tiny")
    L = cfg.n_layers
    launches = {k: 0 for k in ops.KERNELS}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    params = init_params(cfg, seed=0, device="cuda")
    route = static_route_check(cfg, params, torch.Generator(
        device="cuda").manual_seed(11), prompt=32)
    say("logits", model=cfg.name, kv_mode=cfg.amc.kv_mode,
        decode_rel_err=f"{route['decode']:.3e}",
        prefill_worst_rel_err=f"{route['prefill_worst']:.3e}",
        prefill_worst_position=route["prefill_worst_position"])
    if not route["decode"] < 0.05:
        raise AssertionError(f"{cfg.name}: first decode step rel_err "
                             f"{route['decode']}")
    rng = np.random.default_rng(0)              # phase 4's requests
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    per = {"paged_kv_attention": 2 * L, "paged_kv_write": L}
    runs = {}
    for label, kw in (("always-augmented", {}), ("spec_k=4", {"spec_k": 4}),
                      ("augment-on-pressure",
                       {"pool_mode": "augment-on-pressure"})):
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          params=params, **kw)
        prefix_augments = []
        if label == "augment-on-pressure":
            pool = eng.store
            row = pool.max_pages + pool.prefix_pages
            pool.budget_bytes = 4 * row * (pool.geom.page_bytes_normal
                                           + pool.geom.page_bytes_aug) // 2
            augment = pool.augment_page

            def record(r, lp, step, augment=augment, pool=pool):
                prefix_augments.append(
                    pool.max_batch <= r < 2 * pool.max_batch)
                augment(r, lp, step)
            pool.augment_page = record
        run = serve_once(eng, prompts)
        per_dispatch_launches(run["counts"], eng.dispatch_count, per,
                              f"{cfg.name} {label}")
        add(run["counts"])
        st = run["stats"]
        runs[label] = run["out"]
        say("main", model=cfg.name, part=label, kv_mode=cfg.amc.kv_mode,
            **run["line"], spec_rounds=st["spec"]["spec_rounds"],
            band_pages_augmented=sum(prefix_augments),
            energy_pj_per_token=round(st["imc"]["energy_pj_per_token"], 3),
            launches=json.dumps({k: v for k, v in run["counts"].items()
                                 if v}), card=repr(smi))
        if st["spec"]["spec_rounds"]:
            raise AssertionError(f"{cfg.name} {label}: a speculative "
                                 f"round on a family without a verify step")
        if label == "augment-on-pressure" and not (
                st["augment_events"] and any(prefix_augments)):
            raise AssertionError(f"{cfg.name}: no band page augmented "
                                 f"under pressure ({st['augment_events']} "
                                 f"augment events)")
        del eng
    failed = spec_agreement(cfg.name, "none (stepwise)", runs["spec_k=4"],
                            runs["always-augmented"])
    if failed:
        raise AssertionError(failed)

    # 11d: tests/test_faults.py:184 at full width
    rng = np.random.default_rng(5)
    fprompts = [rng.integers(0, cfg.vocab, size=4).astype(np.int32)
                for _ in range(2)]
    kw = dict(device="cuda", max_batch=2, max_seq=32, params=params,
              retention_steps=4)
    golden = serve_once(ServeEngine(cfg, **kw), fprompts, max_new=6)
    add(golden["counts"])
    eng = ServeEngine(cfg, fault_rate=1.0, fault_seed=3, **kw)
    run = serve_once(eng, fprompts, max_new=6)
    add(run["counts"])
    fl = run["stats"]["faults"]
    same = sum(run["out"].get(i) == out for i, out in golden["out"].items())
    say("faults", model=cfg.name, part="band scrub (11d)", **run["line"],
        **{k: fl[k] for k in ("faults_injected", "faults_detected",
                              "faults_masked", "faults_pending",
                              "recovered_scrub", "recovered_recompute",
                              "uncorrectable", "zero_silent_corruption")},
        identical=f"{same}/{len(golden['out'])}", card=repr(smi))
    if not (fl["recovered_scrub"] > 0 and fl["zero_silent_corruption"]
            and fl["faults_pending"] == 0 and not eng.failed
            and run["out"] == golden["out"]):
        raise AssertionError(f"{cfg.name} 11d: band scrub contract {fl}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "band": band}


def phase_vlm(smi: str) -> dict:
    """12: full-width, full-depth llama-3.2-vision-11b (40 layers = 8 x (4
    self + 1 gated cross), d 4096, GQA 32/8, hd 128, vocab 128256, 1601
    patches; dense bf16 weights made on the card, the cross gates set to
    0.8; int4 KV pages for the 32 self layers, the patch KV in a static
    slab store beside them, one CompositeStore). 12a the first decode
    step after a 16-token stepwise prefill, kernel route against plain
    route, the slab filled; 12b 4 requests of 12-40 prompt tokens and 16
    new: every request completed, kernel 2 and W exactly 32 launches a
    dispatch, nothing else; composite admission atomic at full width;
    peak memory. Returns the launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params, tree_nbytes
    from repro_torch.serve import ServeEngine, state_store
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("llama-3.2-vision-11b")
    n_self = cfg.n_layers // 5 * 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    for k in ("gate_attn", "gate_ffn"):
        params["blocks"]["cross"][k].fill_(0.8)
    torch.cuda.synchronize()
    say("setup", model=cfg.name, params_s=round(time.perf_counter() - t0, 3),
        weight_bytes=tree_nbytes(params),
        init_peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    route = static_route_check(cfg, params, torch.Generator(
        device="cuda").manual_seed(12), prompt=16)
    say("logits", model=cfg.name, kv_mode=cfg.amc.kv_mode,
        decode_rel_err=f"{route['decode']:.3e}",
        prefill_worst_rel_err=f"{route['prefill_worst']:.3e}",
        prefill_worst_position=route["prefill_worst_position"])
    if not route["decode"] < 0.05:
        raise AssertionError(f"{cfg.name}: first decode step rel_err "
                             f"{route['decode']}")
    # the worst prefill step, layer by layer (reported: ROADMAP queue 3)
    probe = vlm_gap_probe(cfg, params, 12, 16,
                          route["prefill_worst_position"])
    first = next((i for i, n in enumerate(probe["attn_bits_differ"]) if n),
                 None)
    say("vlm_gap", position=route["prefill_worst_position"],
        logits_rel_err=f"{probe['logits_rel_err']:.3e}",
        first_layer_attn_bits_differ=first,
        first_layer_kv_levels_differ=next(
            (i for i, n in enumerate(probe["kv_levels_differ"]) if n), None),
        **{k: json.dumps(v) for k, v in probe.items()
           if k != "logits_rel_err"})
    # composite admission is atomic at full width
    store = state_store.make_store(cfg, max_batch=2, max_seq=64,
                                   device=torch.device("cuda"))
    prefix = store.parts["prefix"]
    prefix.budget_bytes = prefix.slab_bytes_normal
    kv_live = None
    if store.admit_row(0, 40, 0):
        kv_live = store.parts["kv"].live_bytes
    atomic = (kv_live is not None and not store.admit_row(1, 40, 0)
              and store.parts["kv"].live_bytes == kv_live
              and not store.parts["kv"].allocated[1].any())
    store.release_row(0)
    atomic = atomic and store.live_bytes == 0
    del store, prefix
    if not atomic:
        raise AssertionError(f"{cfg.name}: composite admission not atomic")
    rng = np.random.default_rng(0)              # phase 6's requests' shape
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(12, 41, size=4)]
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=64,
                      params=params)
    run = serve_once(eng, prompts, max_new=16)
    per_dispatch_launches(run["counts"], eng.dispatch_count,
                          {"paged_kv_attention": n_self,
                           "paged_kv_write": n_self}, cfg.name)
    st = run["stats"]
    say("main", model=cfg.name, kv_mode=cfg.amc.kv_mode, **run["line"],
        composite_atomic=atomic, store=st["pool"]["kind"],
        energy_pj_per_token=round(st["imc"]["energy_pj_per_token"], 3),
        launches=json.dumps({k: v for k, v in run["counts"].items() if v}),
        card=repr(smi))
    counts = run["counts"]
    del eng, params, run
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 13: the last two archs (minicpm-2b, minitron-8b)
# ---------------------------------------------------------------------------

def phase_archs(smi: str) -> dict:
    """13: full-width, full-depth minicpm-2b (40 layers, d 2304, MHA 36 of
    64, d_ff 5760, tied head over 122880 rows) and minitron-8b (32 layers,
    d 4096, GQA 32/8 of 128, d_ff 16384, untied 256000-row head), each as
    its config sets it (dual weights: wk/wv and w_gate/w_up paired in int4
    planes, wq / wo / w_down and the head bf16; int4 KV), random weights
    from seed 0 made on the card, on phase 4's 8 requests. 13a: every
    request completed; one decode step launching kernel 4 2L times,
    dense_matmul 3L + 1, kernels 2 and W L times each, nothing else; the
    first prefill chunk, decode step and verify window through the
    kernels within rel_err 0.05 of the plain route. 13b: spec_k=4
    (dequant draft) emits 13a's tokens on 8/8. Weight bytes and peak
    memory at init and while serving. Returns the launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.serve import ServeEngine
    launches = {k: 0 for k in ops.KERNELS}
    failed = []
    for seed, name in enumerate(("minicpm-2b", "minitron-8b")):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        L = cfg.n_layers
        rng = np.random.default_rng(0)          # phase 4's requests
        prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
                   for n in rng.integers(48, 201, size=8)]
        dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, weight_mode="normal"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(dense_cfg, seed=0, device="cuda")
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, params=params)
        params = eng.params               # packed; the dense tree is gone
        torch.cuda.synchronize()
        st = eng.stats()
        say("setup", model=cfg.name, params_s=round(time.perf_counter() - t0,
                                                    3),
            weight_bytes_logical=st["weight_bytes_logical"],
            weight_bytes=st["weight_bytes_physical"],
            init_peak_gib=round(torch.cuda.max_memory_allocated() / 2**30,
                                3))
        run = serve_once(eng, prompts)
        counts = run["counts"]
        require_launches(counts, ["dual_plane_matmul", "dense_matmul",
                                  "paged_kv_attention", "paged_kv_write"],
                         cfg.name)
        for k in launches:
            launches[k] += counts[k]
        stepwise = run["out"]
        say("main", model=cfg.name, weight_mode=cfg.amc.weight_mode,
            kv_mode=cfg.amc.kv_mode, **run["line"],
            energy_pj_per_token=round(
                run["stats"]["imc"]["energy_pj_per_token"], 3),
            launches=json.dumps(counts), card=repr(smi))
        del eng, run
        torch.cuda.empty_cache()
        want = {"dual_plane_matmul": 2 * L, "dense_matmul": 3 * L + 1,
                "paged_kv_attention": L, "paged_kv_write": L}
        got = decode_step_launches(cfg, params)
        say("launches", model=cfg.name, decode_step=json.dumps(got),
            want=json.dumps(want))
        if got != want:
            failed.append(f"{cfg.name}: launches in one decode step {got}, "
                          f"want {want}")
        gen = torch.Generator(device="cuda").manual_seed(13 + seed)
        first_step_logits_check(cfg, params, cfg.amc.kv_mode, gen, window=4)
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, params=params, spec_k=4)
        run = serve_once(eng, prompts)
        counts = run["counts"]
        require_launches(counts, ["dual_plane_matmul", "dense_matmul",
                                  "paged_kv_attention_window",
                                  "paged_kv_write"], f"{cfg.name} spec_k=4")
        for k in launches:
            launches[k] += counts[k]
        sp = run["stats"]["spec"]
        say("main", model=cfg.name, weight_mode=cfg.amc.weight_mode,
            kv_mode=cfg.amc.kv_mode, spec_k=4, **run["line"],
            rounds=sp["spec_rounds"],
            accepted_per_round=round(sp["accepted_tokens_per_round"], 4),
            launches=json.dumps(counts), card=repr(smi))
        msg = spec_agreement(cfg.name, "dequant", run["out"], stepwise)
        if msg:
            failed.append(msg)
        del eng, run, params
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 14: the array fleet
# ---------------------------------------------------------------------------

def serve_fleet(fleet, prompts, max_new: int = 32,
                drive=None) -> dict:
    """`serve_once` for an `ArrayFleet`: every launch count set to 0 just
    before and read just after; `drive(fleet, requests)` runs the
    requests (default: `fleet.generate`)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request
    reqs = [Request(prompt=p, max_new_tokens=max_new, id=i)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (drive or (lambda f, r: f.generate(r)))(fleet, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    out = fleet.outputs
    st = fleet.stats()
    fl = st["fleet"]
    line = dict(requests=len(out), new_tokens=sum(map(len, out.values())),
                decode_and_prefill_tok_s=round(
                    sum(map(len, out.values())) / wall, 3),
                wall_s=round(wall, 3), fleet_steps=fl["steps"],
                placements_per_array=fl["placements_per_array"],
                peak_concurrency=fl["peak_concurrency"],
                migrations=fl["migrations"],
                array_losses=fl["array_losses"],
                drain_requeues=fl["drain_requeues"],
                dispatches=[a["dispatches"] for a in fl["per_array"]],
                peak_mem_gib=round(torch.cuda.max_memory_allocated()
                                   / 2**30, 3))
    return {"out": out, "counts": counts, "line": line, "stats": st}


def phase_fleet(smi: str, single: dict, share_golden: dict) -> dict:
    """14: full-width qwen1.5-0.5b (ternary weights, kv int4,
    always-augmented) on an `ArrayFleet` of 2 arrays sharing cuda:0.
    14a: 2 arrays x max_batch 2, least-loaded, the weights drawn by the
    fleet itself (seed 0, once, shared), on phase 4's 8 requests: tokens
    equal phase 4's single-array int4 run (max_batch 4) on 8/8, 4
    placements each, peak concurrency >= 3. 14b: affinity, prefix_cache
    4, retention 8, 8 rows an array, on phase 7b's shared-prefix stream:
    "prefix" decisions, every hit on one array, tokens equal 7b's
    sharing-on run on 8/8. 14c: the 8 requests piled onto array 0
    (bypassing the policy): migrations > 0, 14a's tokens on 8/8. 14d:
    max_retries 0, the busiest array lost after 3 fleet steps: every
    request completed, none failed, dead == [lost], drain requeues > 0,
    the lost array's live bytes 0, every request never started on the
    lost array equal to 14a's (the others reported: they re-prefill
    through chunked prefill). 14e: 14a traced (the merged trace valid,
    pids {0, 1}, lanes "array 0" / "array 1", 8 placement instants,
    amc_placement_admit 8) and the CLI with --num-arrays 2 --placement
    affinity as a subprocess (exit 0). Returns the launch counts."""
    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.serve import ArrayFleet
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("qwen1.5-0.5b")
    rng = np.random.default_rng(0)              # phase 4's requests
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(48, 201, size=8)]
    launches = {k: 0 for k in ops.KERNELS}
    failed = []
    common = dict(device="cuda", max_seq=512, prefill_chunk=32,
                  kv_mode="int4", pool_mode="always-augmented")

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def same_as(out, ref):
        return sum(out.get(i) == ref[i] for i in ref)

    # 14a
    t0 = time.perf_counter()
    fleet = ArrayFleet(cfg, num_arrays=2, placement="least-loaded", seed=0,
                       max_batch=2, **common)
    setup_s = time.perf_counter() - t0
    params = fleet.engines[0].params
    shared = all(fleet.engines[1].params[k] is params[k]
                 for k in params if not isinstance(params[k], dict))
    run = serve_fleet(fleet, prompts)
    require_launches(run["counts"], ["ternary_matmul", "dense_matmul",
                                     "paged_kv_attention", "paged_kv_write"],
                     "fleet 14a")
    add(run["counts"])
    ref = run["out"]
    n_same = same_as(ref, single["out"])
    fl = run["stats"]["fleet"]
    say("fleet", part="14a", model=cfg.name, arrays=2, max_batch=2,
        placement="least-loaded", setup_s=round(setup_s, 3),
        dense_leaves_shared=shared,
        devices=json.dumps([str(e.device) for e in fleet.engines]),
        **run["line"], identical_to_single=f"{n_same}/8",
        single_wall_s=single["wall_s"], launches=json.dumps(run["counts"]),
        card=repr(smi))
    if n_same != 8 or fl["placements_per_array"] != [4, 4] \
            or fl["peak_concurrency"] < 3 or fleet.failed:
        failed.append(f"14a: {n_same}/8 identical to one array, "
                      f"placements {fl['placements_per_array']}, peak "
                      f"concurrency {fl['peak_concurrency']}, failed "
                      f"{sorted(fleet.failed)}")
    del fleet, run
    torch.cuda.empty_cache()

    # 14b: affinity over the shared-prefix stream
    fleet = ArrayFleet(cfg, num_arrays=2, placement="affinity",
                       params=params, max_batch=8, prefix_cache=4,
                       retention_steps=8, **common)
    run = serve_fleet(fleet, share_prompts(cfg.vocab))
    add(run["counts"])
    decisions = run["stats"]["placement"]["decisions"]
    hits = [a["prefix"]["hits"] for a in run["stats"]["arrays"]]
    n_same = same_as(run["out"], share_golden)
    say("fleet", part="14b", placement="affinity", prefix_cache=4,
        max_batch=8, **run["line"], decisions=json.dumps(decisions),
        hits_per_array=hits, identical_to_7b=f"{n_same}/8",
        launches=json.dumps(run["counts"]), card=repr(smi))
    if not decisions.get("prefix") or sum(h > 0 for h in hits) != 1 \
            or n_same != 8:
        failed.append(f"14b: decisions {decisions}, hits {hits}, "
                      f"{n_same}/8 identical to 7b")
    del fleet, run
    torch.cuda.empty_cache()

    # 14c: everything piled onto array 0; the rebalance migrates it
    fleet = ArrayFleet(cfg, num_arrays=2, params=params, max_batch=2,
                       **common)

    def piled(f, reqs):
        for r in reqs:
            f.engines[0].add_request(r)
        while f.has_work:
            f.step_all()

    run = serve_fleet(fleet, prompts, drive=piled)
    add(run["counts"])
    n_same = same_as(run["out"], ref)
    say("fleet", part="14c", **run["line"], identical_to_14a=f"{n_same}/8",
        launches=json.dumps(run["counts"]), card=repr(smi))
    if run["line"]["migrations"] <= 0 or n_same != 8 or fleet.failed:
        failed.append(f"14c: migrations {run['line']['migrations']}, "
                      f"{n_same}/8 identical to 14a")
    del fleet, run
    torch.cuda.empty_cache()

    # 14d: array loss at max_retries 0
    fleet = ArrayFleet(cfg, num_arrays=2, params=params, max_batch=2,
                       max_retries=0, **common)
    started: dict = {}
    for aid, eng in enumerate(fleet.engines):
        def start(row, entry, shared=None, base=eng._start_row, aid=aid):
            started.setdefault(entry.req.id, set()).add(aid)
            base(row, entry, shared=shared)

        eng._start_row = start
    lost = []

    def lose(f, reqs):
        for r in reqs:
            f.add_request(r)
        for _ in range(3):
            f.step_all()
        lost.append(f.inject_array_loss())
        while f.has_work:
            f.step_all()

    run = serve_fleet(fleet, prompts, drive=lose)
    add(run["counts"])
    out, fl = run["out"], run["stats"]["fleet"]
    never = [i for i in range(8) if lost[0] not in started.get(i, ())]
    moved = [i for i in range(8) if i not in never]
    n_never = sum(out.get(i) == ref[i] for i in never)
    say("fleet", part="14d", lost=lost[0], max_retries=0, **run["line"],
        dead=fl["dead"], failed=sorted(fleet.failed),
        lost_live_bytes=fl["per_array"][lost[0]]["live_bytes"],
        never_on_lost_identical=f"{n_never}/{len(never)}",
        drained_identical=f"{sum(out.get(i) == ref[i] for i in moved)}"
                          f"/{len(moved)}",
        launches=json.dumps(run["counts"]), card=repr(smi))
    if fleet.failed or sorted(out) != list(range(8)) \
            or any(len(v) != 32 for v in out.values()) \
            or fl["dead"] != lost or fl["drain_requeues"] <= 0 \
            or fl["per_array"][lost[0]]["live_bytes"] != 0 \
            or n_never != len(never):
        failed.append(f"14d: failed {sorted(fleet.failed)}, completed "
                      f"{ {k: len(v) for k, v in out.items()} }, dead "
                      f"{fl['dead']} vs {lost}, drain requeues "
                      f"{fl['drain_requeues']}, never-lost identical "
                      f"{n_never}/{len(never)}")
    del fleet, run
    torch.cuda.empty_cache()

    # 14e: 14a traced, then the CLI
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    fleet = ArrayFleet(cfg, num_arrays=2, params=params, max_batch=2,
                       trace=True, metrics=True, **common)
    run = serve_fleet(fleet, prompts)
    add(run["counts"])
    trace = fleet.export_trace(str(out_dir / "fleet_trace.json"))
    prom = fleet.export_metrics(str(out_dir / "fleet_metrics.prom"))
    ev = trace["traceEvents"]
    problems = obs.validate_chrome_trace(trace)
    pids = sorted({e["pid"] for e in ev})
    lanes = sorted(e["args"]["name"] for e in ev
                   if e.get("name") == "process_name")
    admits = [e for e in ev if e.get("name") == "placement"
              and e["args"].get("kind") == "admit"]
    n_same = same_as(run["out"], ref)
    say("fleet", part="14e", traced=True, **run["line"],
        trace_events=len(ev), trace_problems=len(problems), pids=pids,
        lanes=json.dumps(lanes), placement_instants=len(admits),
        admit_metric="amc_placement_admit 8" in prom,
        identical_to_14a=f"{n_same}/8", card=repr(smi))
    if problems or pids != [0, 1] or lanes != ["array 0", "array 1"] \
            or len(admits) != 8 or "amc_placement_admit 8" not in prom:
        failed.append(f"14e: trace problems {problems[:3]}, pids {pids}, "
                      f"lanes {lanes}, {len(admits)} placement instants")
    del fleet, run, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         cfg.name, "--num-arrays", "2", "--placement", "affinity",
         "--shared-prefix", "120", "--prefix-cache", "4", "--requests", "8",
         "--prompt-len", "48", "--max-new", "32", "--max-batch", "4",
         "--max-seq", "512", "--trace-out", str(out_dir / "cli_fleet.json"),
         "--metrics-out", str(out_dir / "cli_fleet.prom")],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        capture_output=True, text=True, timeout=600)
    reqs = [ln for ln in res.stdout.splitlines()
            if ln.startswith("[serve] req ")]
    say("fleet", part="14e", cli_rc=res.returncode, req_lines=len(reqs),
        seconds=round(time.perf_counter() - t0, 3))
    for ln in res.stdout.splitlines():
        if ln.startswith("[serve]") and not ln.startswith("[serve] req "):
            print(ln, flush=True)
    if res.returncode != 0 or len(reqs) != 8:
        failed.append(f"14e: CLI rc {res.returncode}, {len(reqs)} request "
                      f"lines, stderr {res.stderr[-2000:]}")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 15: the training path and the contiguous prefill -> decode steps
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 30
# the gated runs draw the synthetic stream from the first 512 token ids:
# at the full 151936-id vocab its next-token map is not learnable in 30
# steps (each id comes up ~0.03 times a step), and the loss sits at
# ln(V) within the batches' noise (15a's full-vocab run shows it)
LEARN_VOCAB = 512
SERVING_KERNELS = ("dense_matmul", "expert_matmul", "ternary_matmul")


def _train_parts(optimizer: str = "adamw", **tkw):
    """15a's configuration: full-width qwen1.5-0.5b, SyntheticLM at batch
    8 x seq 512 over LEARN_VOCAB ids, cosine schedule, lr 1e-3, warmup 3,
    remat "nothing"."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import TrainSettings
    from repro_torch.train.trainer import TrainerConfig
    cfg = get_arch("qwen1.5-0.5b")
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    settings = TrainSettings(optimizer=optimizer, lr=1e-3,
                             remat_policy="nothing", q_chunk=TRAIN_S)
    tcfg = TrainerConfig(**{"total_steps": TRAIN_STEPS, "ckpt_every": 10 ** 9,
                            "warmup": 3, "seed": 0, **tkw})
    return cfg, shape, settings, tcfg


def _make_trainer(cfg, shape, settings, tcfg, vocab=LEARN_VOCAB, **kw):
    """The port's Trainer on the card, its synthetic stream swapped for
    one over the first `vocab` ids (None: the model's whole vocab, the
    stream the Trainer builds)."""
    from repro_torch.data import PrefetchIterator, SyntheticLM
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.train.trainer import Trainer
    tr = Trainer(cfg, shape, settings, tcfg, device="cuda", **kw)
    if vocab is not None:
        tr.data.close()
        tr.data = PrefetchIterator(
            SyntheticLM(vocab, shape.seq_len, shape.global_batch,
                        seed=tcfg.seed),
            put_fn=lambda b: to_tensors(b, tr.device))
    return tr


def _timed_steps(tr, n: int) -> list:
    """Wall seconds of each of `n` steps (each ends in the loss's host
    read, which waits for the step)."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        tr.train(n_steps=1)
        walls.append(time.perf_counter() - t0)
    return walls


@contextlib.contextmanager
def _norm_order(fixed: bool):
    """`layers.rms_norm` with every call's `fixed_order` forced to
    `fixed` while the block runs."""
    from repro_torch.models import layers
    norm = layers.rms_norm
    layers.rms_norm = lambda *a, fixed_order=True, **kw: norm(
        *a, fixed_order=fixed, **kw)
    try:
        yield
    finally:
        layers.rms_norm = norm


def _kernels_a_step(fn) -> int:
    """Device kernels one call of `fn` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _state_bytes(opt) -> int:
    from repro_torch.models.params import tree_nbytes
    return sum(tree_nbytes(t) for t in opt[1:])


def _n_params(params) -> int:
    from repro_torch.tree import flatten
    return sum(v.numel() for v in flatten(params)[0])


def train_run(smi: str, optimizer: str, tmp: str, vocab=LEARN_VOCAB,
              steps: int = TRAIN_STEPS) -> dict:
    """15a / 15b: `steps` steps (of the 30-step schedule) through the
    port's Trainer. Returns the losses,
    the step walls, the launch counts, the peak memory, the optimizer
    state's bytes and the trainer."""
    from repro_torch.kernels import ops
    cfg, shape, settings, tcfg = _train_parts(optimizer, ckpt_dir=tmp)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = _make_trainer(cfg, shape, settings, tcfg, vocab=vocab)
    ops.reset_launch_counts()
    walls = _timed_steps(tr, steps)
    counts = ops.launch_counts()
    out = {"losses": list(tr.losses), "walls": walls, "counts": counts,
           "peak": torch.cuda.max_memory_allocated() - base,
           "opt_bytes": _state_bytes(tr.state.opt),
           "n_params": _n_params(tr.state.params), "trainer": tr}
    tr.close()
    return out


def _train_line(tag: str, run: dict, smi: str) -> float:
    losses = run["losses"]
    med = float(np.median(run["walls"][4:]))
    tokens = TRAIN_B * TRAIN_S
    share = 8 * run["n_params"] * tokens / (med * BF16_FLOP_PER_S)
    say(tag, n_params=run["n_params"], steps=len(losses),
        loss_first5=round(float(np.mean(losses[:5])), 4),
        loss_last5=round(float(np.mean(losses[-5:])), 4),
        loss_final=round(losses[-1], 4),
        median_step_ms=round(med * 1e3, 3),
        tokens_per_s=round(tokens / med, 1),
        bf16_peak_share_8NT=round(share, 4),
        peak_mem_gib=round(run["peak"] / 2 ** 30, 3),
        opt_state_gb=round(run["opt_bytes"] / 1e9, 4),
        serving_kernel_launches=json.dumps(
            {k: run["counts"][k] for k in SERVING_KERNELS}),
        card=repr(smi))
    return med


def train_twin_check(arch: str) -> dict:
    """15c: one train step's loss and gradients of a reduced model on the
    card against the same step on the CPU (same weights, same batch)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.models import model as M
    from repro_torch.models.params import _leaves, init_params
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, seed=3, device="cpu")
    batch = SyntheticLM(cfg.vocab, 64, 4, seed=3).batch_at(0)
    loss = lambda p, b: M.loss_fn(cfg, p, b, remat_policy="nothing",
                                  q_chunk=64)
    cpu = value_and_grad(loss, params, to_tensors(batch))
    dev = value_and_grad(loss, tree_map(lambda t: t.cuda(), params),
                         to_tensors(batch, "cuda"))
    errs = {"/".join(p): rel_err(g.cpu(), dict(_leaves(cpu[1]))[p])
            for p, g in _leaves(dev[1])}
    worst = max(errs, key=errs.get)
    out = {"loss_cpu": float(cpu[0]), "loss_card": float(dev[0]),
           "worst_leaf": worst, "worst_rel_err": errs[worst]}
    say("train", part="15c", arch=arch,
        loss_abs_diff=round(abs(out["loss_cpu"] - out["loss_card"]), 6),
        worst_grad_leaf=worst, worst_grad_rel_err=round(errs[worst], 5),
        leaves=len(errs))
    return out


def _trees_equal(a, b) -> bool:
    """Bit equality of two trees of tensors."""
    from repro_torch.tree import flatten
    la, lb = flatten(a)[0], flatten(b)[0]
    bits = lambda t: t.reshape(-1).view(torch.uint8)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def restart_run(smi: str, golden: list, tmp: str) -> dict:
    """15d: 15a's configuration with a checkpoint every 10 steps and a
    SimulatedFailure before step 12: the Supervisor restores step 10."""
    from repro_torch.distributed.fault import SimulatedFailure
    from repro_torch.tree import tree_map
    cfg, shape, settings, tcfg = _train_parts(ckpt_dir=tmp, ckpt_every=10,
                                              keep_ckpts=1)
    fired = {"n": 0}

    def injector(step):
        if step == 12 and not fired["n"]:
            fired["n"] = 1
            raise SimulatedFailure("card lost (simulated)")

    tr = _make_trainer(cfg, shape, settings, tcfg,
                       failure_injector=injector)
    seen = {}
    save, restore = tr._save, tr._restore

    def saving(step):
        save(step)
        if step == 10:
            seen["saved"] = tree_map(torch.clone, tr.state)

    def restoring(step):
        restore(step)
        seen["restored_step"] = step
        seen["restored_equal"] = _trees_equal(tr.state, seen["saved"])
        del seen["saved"]

    tr._save, tr._restore = saving, restoring
    t0 = time.perf_counter()
    losses = tr.train()
    wall = time.perf_counter() - t0
    tr.close()
    cont = losses[12:]
    ref = golden[12:]
    bit_equal = sum(a == b for a, b in zip(cont, ref))
    worst = max(abs(a - b) for a, b in zip(cont, ref))
    say("train", part="15d", restarts=tr.supervisor.restarts,
        restored_step=seen.get("restored_step"),
        restored_state_bit_equal=seen.get("restored_equal"),
        losses=len(losses), continued_bit_equal=f"{bit_equal}/{len(ref)}",
        continued_worst_abs_diff=worst, wall_s=round(wall, 3),
        card=repr(smi))
    return {"restarts": tr.supervisor.restarts, "seen": seen,
            "losses": losses, "bit_equal": bit_equal, "worst": worst,
            "n": len(ref)}


def contiguous_steps(smi: str, params) -> dict:
    """15f: 4 prompts of 128 tokens through `make_prefill_step` (the
    forward's packed cache) and 16 `make_decode_step` steps at kv int8
    and int4 on kernel 6, the first step against the kv_impl="dequant"
    route on the same cache; and the same prompts through
    `prefill_chunk_step` in 4 chunks of 32 (kernel 3 packs each chunk's
    K and V at int4). Returns the launch counts of the runs."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import (TrainSettings, make_decode_step,
                                   make_prefill_step)
    base = get_arch("qwen1.5-0.5b")
    B, P, N, C = 4, 128, 16, 32
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, base.vocab, (B, P + N))
                            .astype(np.int32)).cuda()
    total = {k: 0 for k in ops.launch_counts()}
    failed = []
    for kv in ("int8", "int4"):
        cfg = dataclasses.replace(base, amc=dataclasses.replace(
            base.amc, weight_mode="normal", kv_mode=kv, kv_impl="kernel"))
        dq = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, kv_impl="dequant"))
        L = cfg.n_layers
        with torch.no_grad():
            ops.reset_launch_counts()
            lg_f, fc = make_prefill_step(cfg, TrainSettings(q_chunk=P))(
                params, {"tokens": toks[:, :P]})
            cache = {k: torch.zeros(s.shape, dtype=s.dtype, device="cuda")
                     for k, s in M.abstract_cache(cfg, B, P + N).items()}
            for k, v in fc.items():
                cache[k][:, :, :, :P] = v         # head-major: seq axis 3
            # the chunked prefill of the same prompts into its own cache
            cc = {k: torch.zeros_like(v) for k, v in cache.items()}
            for i in range(P // C):
                lg_c, cc = M.prefill_step(cfg, params, cc, {
                    "tokens": toks[:, i * C:(i + 1) * C],
                    "positions": torch.full((B,), i * C, dtype=torch.int32,
                                            device="cuda"),
                    "write_mask": torch.ones(B, dtype=torch.bool,
                                             device="cuda")})
            prefill_counts = ops.launch_counts()
            pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
            first = {"tokens": toks[:, P:P + 1], "positions": pos}
            ref, _ = make_decode_step(dq)(params, cache, first)
            decode = make_decode_step(cfg)
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(N):
                lg, cache = decode(params, cache, {
                    "tokens": toks[:, P + t:P + t + 1], "positions": pos + t})
                if t == 0:      # the padded vocab slots hold -1e30
                    V = cfg.vocab
                    err = rel_err(lg[..., :V], ref[..., :V])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
        same = {k: float((cc[k][:, :, :, :P] == cache[k][:, :, :, :P])
                         .float().mean()) for k in fc}
        want_k3 = 2 * L * (P // C) if kv == "int4" else 0
        say("train", part="15f", kv=kv, decode_steps=N,
            kernel6_per_step=counts["packed_kv_attention"] / N,
            kernel3_per_layer_chunk=prefill_counts["quantize_pack_kv"]
            / (L * (P // C)),
            first_step_rel_err_vs_dequant=round(err, 6),
            chunked_vs_forward_last_logits=round(
                rel_err(lg_c[:, -1, :V], lg_f[:, -1, :V]), 5),
            chunked_cache_equal_share=json.dumps(
                {k: round(v, 5) for k, v in same.items()}),
            decode_ms_per_step=round(wall / N * 1e3, 3),
            other_launches=json.dumps({k: v for k, v in counts.items()
                                       if v and k != "packed_kv_attention"}),
            card=repr(smi))
        if counts["packed_kv_attention"] != L * N:
            failed.append(f"15f {kv}: kernel 6 launched "
                          f"{counts['packed_kv_attention']} times in {N} "
                          f"decode steps, want {L * N}")
        if prefill_counts["quantize_pack_kv"] != want_k3:
            failed.append(f"15f {kv}: kernel 3 launched "
                          f"{prefill_counts['quantize_pack_kv']} times in "
                          f"the chunked prefill, want {want_k3}")
        if not err < 0.05:
            failed.append(f"15f {kv}: first decode step rel_err {err} vs the "
                          f"dequant route")
        for k in total:
            total[k] += counts[k] + prefill_counts[k]
    return {"launches": total, "failed": failed}


def phase_train(smi: str) -> dict:
    """15a-15f. Returns the launch counts of the main-path runs (15f's:
    the train steps launch none)."""
    import shutil
    import tempfile
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.models import model as M
    from repro_torch.train.step import value_and_grad
    failed = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # 15a: first the stream over the model's whole vocab (reported)
        full = train_run(smi, "adamw", os.path.join(tmp, "a0"),
                         vocab=None, steps=10)
        full.pop("trainer")
        _train_line("train15a_full_vocab", full, smi)
        if not all(np.isfinite(full["losses"])):
            failed.append(f"15a: non-finite losses {full['losses']}")
        gc.collect()
        torch.cuda.empty_cache()
        adam = train_run(smi, "adamw", os.path.join(tmp, "a"))
        _train_line("train15a", adam, smi)
        tr = adam.pop("trainer")
        cfg = tr.cfg
        batch = to_tensors(SyntheticLM(LEARN_VOCAB, TRAIN_S, TRAIN_B, seed=0)
                           .batch_at(0), "cuda")
        per_step = {}
        loss = lambda p, b: M.loss_fn(cfg, p, b, remat_policy="nothing",
                                      q_chunk=TRAIN_S)
        for fixed in (False, True):
            # the serving steps' fixed-order norm tree, patched in for
            # this one count (the forward takes torch's mean)
            with _norm_order(fixed):
                per_step[fixed] = _kernels_a_step(
                    lambda: value_and_grad(loss, tr.state.params, batch))
        say("train", part="15a_launches",
            kernels_per_step_torch_norm=per_step[False],
            kernels_per_step_fixed_order_norm=per_step[True],
            note="forward + backward (remat nothing), no optimizer")
        losses = adam["losses"]
        if not all(np.isfinite(losses)):
            failed.append(f"15a: non-finite losses {losses}")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            failed.append(f"15a: loss did not fall ({losses})")
        if any(adam["counts"][k] for k in SERVING_KERNELS):
            failed.append(f"15a: a serving kernel launched in a train step "
                          f"{adam['counts']}")
        trained = tr.state.params
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        # 15b
        amc = train_run(smi, "amc_adamw", os.path.join(tmp, "b"))
        amc.pop("trainer")
        _train_line("train15b", amc, smi)
        n = adam["n_params"]
        from repro_torch.tree import flatten
        rows = sum(v.numel() // v.shape[-1] for v in flatten(trained)[0])
        say("train", part="15b_vs_15a",
            opt_state_gb_predicted_adamw=round(8 * n / 1e9, 4),
            opt_state_gb_measured_adamw=round(adam["opt_bytes"] / 1e9, 4),
            opt_state_gb_predicted_amc=round((2 * n + 8 * rows) / 1e9, 4),
            opt_state_gb_measured_amc=round(amc["opt_bytes"] / 1e9, 4),
            peak_gap_gib_predicted=round(
                (adam["opt_bytes"] - amc["opt_bytes"]) / 2 ** 30, 3),
            peak_gap_gib_measured=round(
                (adam["peak"] - amc["peak"]) / 2 ** 30, 3),
            final_loss_adamw=round(adam["losses"][-1], 4),
            final_loss_amc=round(amc["losses"][-1], 4))
        al = amc["losses"]
        if not all(np.isfinite(al)) or not np.mean(al[-5:]) < np.mean(al[:5]):
            failed.append(f"15b: AMC-Adam losses {al}")
        if any(amc["counts"][k] for k in SERVING_KERNELS):
            failed.append(f"15b: a serving kernel launched {amc['counts']}")
        if not amc["opt_bytes"] < 0.3 * adam["opt_bytes"]:
            failed.append(f"15b: AMC state {amc['opt_bytes']} vs AdamW "
                          f"{adam['opt_bytes']}")
        if not abs(al[-1] - losses[-1]) <= 0.05 * losses[-1]:
            failed.append(f"15b: final loss {al[-1]} vs AdamW {losses[-1]}")
        gc.collect()
        torch.cuda.empty_cache()

        # 15c
        for arch in ("qwen1.5-0.5b", "qwen3-moe-30b-a3b"):
            tw = train_twin_check(arch)
            if not (abs(tw["loss_cpu"] - tw["loss_card"]) < 2e-2
                    and tw["worst_rel_err"] < 0.05):
                failed.append(f"15c {arch}: card vs CPU {tw}")

        # 15d
        rs = restart_run(smi, losses, os.path.join(tmp, "d"))
        seen = rs["seen"]
        if not (rs["restarts"] == 1 and seen.get("restored_step") == 10
                and seen.get("restored_equal")):
            failed.append(f"15d: restore {seen}")
        if len(rs["losses"]) != TRAIN_STEPS:
            failed.append(f"15d: {len(rs['losses'])} losses, want "
                          f"{TRAIN_STEPS}")
        if not rs["worst"] < 2e-2:
            failed.append(f"15d: continued losses {rs['worst']} from 15a's")
        gc.collect()
        torch.cuda.empty_cache()

        # 15e
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve()
                                               .parent / "src")}
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "qwen1.5-0.5b", "--steps", "10", "--batch", str(TRAIN_B),
               "--seq", str(TRAIN_S), "--optimizer", "amc_adamw",
               "--ckpt-dir", os.path.join(tmp, "e")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600)
        wall = time.perf_counter() - t0
        pod = subprocess.run(cmd + ["--mesh", "pod"], env=env,
                             capture_output=True, text=True, timeout=600)
        line = [l for l in res.stdout.splitlines() if l.startswith("[train]")]
        say("train", part="15e", rc=res.returncode, line=repr(line[-1:]),
            wall_s=round(wall, 3), mesh_pod_rc=pod.returncode)
        if res.returncode != 0 or not line:
            failed.append(f"15e: CLI rc {res.returncode}: "
                          f"{res.stderr[-2000:]}")
        if pod.returncode != 2:
            failed.append(f"15e: --mesh pod rc {pod.returncode}")

        # 15f
        cs = contiguous_steps(smi, trained)
        failed += cs["failed"]
        del trained
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return cs["launches"]


FULLSEQ_B, FULLSEQ_P, FULLSEQ_N = 4, 256, 16


def _fullseq_cfg(arch: str, **amc):
    """The arch at full width with dense weights, its kv mode (or the
    one given) read through kernel 6."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, **{"weight_mode": "normal", "kv_impl": "kernel", **amc}))


def _tokens(vocab: int, B: int, S: int) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(
        np.int32)).cuda()


def _positions(B: int, p: int) -> torch.Tensor:
    return torch.full((B,), p, dtype=torch.int32, device="cuda")


def _zero_cache(cfg, B: int, S: int) -> dict:
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device="cuda"),
                    M.abstract_cache(cfg, B, S))


def _into_horizon(cfg, cache: dict, B: int, S: int, T: int) -> dict:
    """The audio / vlm forward's cache with its self KV of S tokens in the
    first S slots of a zeroed S + T decode cache (the cross / patch KV as
    it is)."""
    full = _zero_cache(cfg, B, S + T)
    ax = 2 if cfg.amc.kv_mode == "normal" else 3
    for k, v in cache.items():
        if k.startswith(("cross", "patch")):
            full[k] = v
        else:
            full[k].narrow(ax, 0, S).copy_(v)
    return full


def _decode_run(cfg, params, cache, toks, P: int, N: int) -> dict:
    """N contiguous decode steps from position P (tokens P.. of `toks`),
    the launch counts and the wall a step. Returns the first step's
    logits too."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    B = toks.shape[0]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(N):
            lg, cache = M.decode_step(cfg, params, cache, {
                "tokens": toks[:, P + t:P + t + 1],
                "positions": _positions(B, P + t)})
            if t == 0:
                first = lg
    torch.cuda.synchronize()
    return {"first": first, "counts": ops.launch_counts(),
            "ms": (time.perf_counter() - t0) / N * 1e3}


def _stepwise_logits(cfg, params, toks, upto: int):
    """The logits of token `upto` after decoding tokens 0..upto one at a
    time from an empty cache (the reference of the hand-off)."""
    from repro_torch.models import model as M
    B = toks.shape[0]
    cache = _zero_cache(cfg, B, upto + 1)
    with torch.no_grad():
        for t in range(upto + 1):
            lg, cache = M.decode_step(cfg, params, cache, {
                "tokens": toks[:, t:t + 1], "positions": _positions(B, t)})
    return lg


def _launch_gate(failed: list, tag: str, counts: dict, kernel6: int,
                 steps: int) -> None:
    """Kernel 6 exactly `kernel6` launches a decode step, nothing else."""
    want = {k: (kernel6 * steps if k == "packed_kv_attention" else 0)
            for k in counts}
    if counts != want:
        failed.append(f"{tag}: launches {counts}, want {kernel6} of kernel "
                      f"6 a step for {steps} steps and nothing else")


def fullseq_twin(cfg, batch_cpu: dict, seed: int = 3, gates=None) -> dict:
    """One train step's loss and gradients of `cfg` on the card against
    the same step on the CPU (weights made on the card from `seed`,
    copied to the CPU; `gates` sets the vlm cross gates)."""
    from repro_torch.models import model as M
    from repro_torch.models.params import _leaves, init_params
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_map
    dev = init_params(cfg, seed=seed, device="cuda")
    if gates is not None:
        for k in ("gate_attn", "gate_ffn"):
            dev["blocks"]["cross"][k].fill_(gates)
    cpu = tree_map(lambda t: t.cpu(), dev)
    loss = lambda p, b: M.loss_fn(cfg, p, b, remat_policy="nothing",
                                  q_chunk=batch_cpu["tokens"].shape[1])
    t0 = time.perf_counter()
    lc, gc_ = value_and_grad(loss, cpu, batch_cpu)
    cpu_s = time.perf_counter() - t0
    ld, gd = value_and_grad(loss, dev, {k: v.cuda() for k, v in
                                        batch_cpu.items()})
    want = dict(_leaves(gc_))
    errs = {"/".join(p): rel_err(g.cpu(), want[p]) for p, g in _leaves(gd)}
    worst = max(errs, key=errs.get)
    return {"loss_cpu": float(lc), "loss_card": float(ld), "worst": worst,
            "worst_rel_err": errs[worst], "leaves": len(errs),
            "n_layers": cfg.n_layers, "cpu_s": cpu_s}


def _twin_line(tag: str, tw: dict, failed: list) -> None:
    say("fullseq", part=tag, n_layers=tw["n_layers"],
        loss_abs_diff=round(abs(tw["loss_cpu"] - tw["loss_card"]), 6),
        worst_grad_leaf=tw["worst"],
        worst_grad_rel_err=round(tw["worst_rel_err"], 5),
        leaves=tw["leaves"], cpu_step_s=round(tw["cpu_s"], 3))
    if not (abs(tw["loss_cpu"] - tw["loss_card"]) < 2e-2
            and tw["worst_rel_err"] < 0.05):
        failed.append(f"{tag}: card vs CPU {tw}")


def fullseq_ssm(smi: str, tmp: str, failed: list) -> dict:
    """16a: full-width mamba2-130m through the Trainer (AdamW, batch 8 x
    seq 512, 30 steps, the LEARN_VOCAB stream), then forward(return_cache)
    on 4 prompts of 256 and 16 decode steps, the first against the same
    257 tokens decoded one at a time from an empty cache."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import TrainSettings
    from repro_torch.train.step import value_and_grad
    from repro_torch.train.trainer import TrainerConfig
    cfg = get_arch("mamba2-130m")
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    settings = TrainSettings(optimizer="adamw", lr=1e-3,
                             remat_policy="nothing", q_chunk=TRAIN_S)
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=10 ** 9,
                         warmup=3, seed=0, ckpt_dir=tmp)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = _make_trainer(cfg, shape, settings, tcfg)
    ops.reset_launch_counts()
    walls = _timed_steps(tr, TRAIN_STEPS)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    losses = list(tr.losses)
    batch = to_tensors(SyntheticLM(LEARN_VOCAB, TRAIN_S, TRAIN_B, seed=0)
                       .batch_at(0), "cuda")
    kernels = _kernels_a_step(lambda: value_and_grad(
        lambda p, b: M.loss_fn(cfg, p, b, remat_policy="nothing",
                               q_chunk=TRAIN_S), tr.state.params, batch))
    med = float(np.median(walls[4:]))
    n = _n_params(tr.state.params)
    tokens = TRAIN_B * TRAIN_S
    say("fullseq", part="16a_train", model=cfg.name, n_params=n,
        steps=len(losses), loss_first5=round(float(np.mean(losses[:5])), 4),
        loss_last5=round(float(np.mean(losses[-5:])), 4),
        loss_final=round(losses[-1], 4), median_step_ms=round(med * 1e3, 3),
        tokens_per_s=round(tokens / med, 1),
        bf16_peak_share_8NT=round(8 * n * tokens / (med * BF16_FLOP_PER_S),
                                  5),
        kernels_per_step=kernels, peak_mem_gib=round(peak / 2 ** 30, 3),
        port_kernel_launches=sum(counts.values()), card=repr(smi))
    if not all(np.isfinite(losses)) \
            or not np.mean(losses[-5:]) < np.mean(losses[:5]):
        failed.append(f"16a: mamba2 losses {losses}")
    if any(counts.values()):
        failed.append(f"16a: a port kernel launched in a train step {counts}")
    params = tr.state.params
    tr.close()
    del tr
    B, P, N = FULLSEQ_B, FULLSEQ_P, FULLSEQ_N
    toks = _tokens(cfg.vocab, B, P + N)
    with torch.no_grad():
        _, cache = M.forward(cfg, params, {"tokens": toks[:, :P]},
                             return_cache=True, remat_policy="none",
                             q_chunk=P)
    run = _decode_run(cfg, params, cache, toks, P, N)
    ref = _stepwise_logits(cfg, params, toks, P)
    V = cfg.vocab
    err = rel_err(run["first"][..., :V], ref[..., :V])
    say("fullseq", part="16a_handoff", model=cfg.name, B=B, prompt=P,
        decode_steps=N, first_step_rel_err_vs_stepwise=round(err, 6),
        decode_ms_per_step=round(run["ms"], 3),
        launches=sum(run["counts"].values()), card=repr(smi))
    if not err < 0.05:
        failed.append(f"16a: first decode step after the hand-off {err} "
                      f"from the stepwise prefill's")
    _launch_gate(failed, "16a", run["counts"], 0, N)
    return run["counts"]


def fullseq_hybrid(smi: str, failed: list) -> dict:
    """16b: full-width recurrentgemma-9b (dense weights): forward(
    return_cache) at 4 x 256 and 16 decode steps, with the int4 ring
    (kernel 6 exactly 12 a step; the first step within 0.05 of the
    dequant route on the same cache) and with the bf16 ring (the first
    step within 0.05 of the same 257 tokens decoded one at a time). The
    int4 ring's first step against its stepwise-prefilled cache's is
    reported: int4 turns the routes' rounding differences into level
    flips (ROADMAP condition (g); the JAX package's own forward and steps
    part the same way, tests/test_torch_fullseq_handoff_gap.py). Then one
    train step at one macro-block + one tail layer, card vs CPU."""
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    base = _fullseq_cfg("recurrentgemma-9b")
    params = init_params(base, seed=0, device="cuda")
    B, P, N = FULLSEQ_B, FULLSEQ_P, FULLSEQ_N
    toks = _tokens(base.vocab, B, P + N)
    nb = base.n_layers // 3
    V = base.vocab
    total = None
    for kv in ("int4", "normal"):
        cfg = _fullseq_cfg("recurrentgemma-9b", kv_mode=kv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            _, cache = M.forward(cfg, params, {"tokens": toks[:, :P]},
                                 return_cache=True, remat_policy="none",
                                 q_chunk=P)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        run = _decode_run(cfg, params, cache, toks, P, N)
        step_err = rel_err(run["first"][..., :V],
                           _stepwise_logits(cfg, params, toks, P)[..., :V])
        line = dict(model=cfg.name, kv=kv, B=B, prompt=P,
                    forward_ms=round(fwd_ms, 3), decode_steps=N,
                    kernel6_per_step=run["counts"]["packed_kv_attention"]
                    / N, first_step_rel_err_vs_stepwise=round(step_err, 6),
                    decode_ms_per_step=round(run["ms"], 3))
        if kv == "int4":
            dq = dataclasses.replace(cfg, amc=dataclasses.replace(
                cfg.amc, kv_impl="dequant"))
            with torch.no_grad():
                ref, _ = M.decode_step(dq, params, cache, {
                    "tokens": toks[:, P:P + 1],
                    "positions": _positions(B, P)})
            err = rel_err(run["first"][..., :V], ref[..., :V])
            line["first_step_rel_err_vs_dequant"] = round(err, 6)
            if not err < 0.05:
                failed.append(f"16b int4: first decode step {err} from the "
                              f"dequant route")
        elif not step_err < 0.05:
            failed.append(f"16b {kv}: first decode step after the hand-off "
                          f"{step_err} from the stepwise prefill's")
        say("fullseq", part="16b_handoff", **line, card=repr(smi))
        _launch_gate(failed, f"16b {kv}", run["counts"],
                     nb if kv == "int4" else 0, N)
        total = run["counts"] if total is None else {
            k: total[k] + v for k, v in run["counts"].items()}
        del cache
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # one macro-block and one tail layer, widths full
    small = dataclasses.replace(base, n_layers=4)
    batch = to_tensors(SyntheticLM(base.vocab, 32, 1, seed=3).batch_at(0))
    _twin_line("16b_train_twin", fullseq_twin(small, batch), failed)
    return total


def fullseq_audio(smi: str, failed: list) -> dict:
    """16c: full-width whisper-tiny, 1500 frames from seed 0:
    forward(return_cache) at 4 x 64 and 16 decode steps at kv int8 and
    int4 (kernel 6 exactly 4 a step, nothing launched by the forward's
    pack), the first step against the dequant route; 30 AdamW steps at
    batch 8 x seq 448; one train step card vs CPU."""
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.optim import SCHEDULES, adamw
    from repro_torch.train import TrainSettings
    from repro_torch.train import step as step_lib
    base = _fullseq_cfg("whisper-tiny")
    params = init_params(base, seed=0, device="cuda")
    e = base.encdec
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, P, N = FULLSEQ_B, 64, FULLSEQ_N
    frames = torch.randn((B, e.n_frames, e.frame_dim), generator=gen,
                         device="cuda").bfloat16()
    toks = _tokens(base.vocab, B, P + N)
    total = None
    for kv in ("int8", "int4"):
        cfg = _fullseq_cfg("whisper-tiny", kv_mode=kv)
        dq = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, kv_impl="dequant"))
        ops.reset_launch_counts()
        with torch.no_grad():
            _, cache = M.forward(cfg, params, {"tokens": toks[:, :P],
                                               "frames": frames},
                                 return_cache=True, remat_policy="none",
                                 q_chunk=P)
            fwd_counts = ops.launch_counts()
            full = _into_horizon(cfg, cache, B, P, N)
            ref, _ = M.decode_step(dq, params, full, {
                "tokens": toks[:, P:P + 1], "positions": _positions(B, P)})
        run = _decode_run(cfg, params, full, toks, P, N)
        V = cfg.vocab
        err = rel_err(run["first"][..., :V], ref[..., :V])
        say("fullseq", part="16c_handoff", model=cfg.name, kv=kv, B=B,
            prompt=P, frames=e.n_frames, decode_steps=N,
            kernel6_per_step=run["counts"]["packed_kv_attention"] / N,
            forward_launches=sum(fwd_counts.values()),
            first_step_rel_err_vs_dequant=round(err, 6),
            decode_ms_per_step=round(run["ms"], 3), card=repr(smi))
        if not err < 0.05:
            failed.append(f"16c {kv}: first decode step {err} from the "
                          f"dequant route")
        if any(fwd_counts.values()):
            failed.append(f"16c {kv}: the forward launched {fwd_counts}")
        _launch_gate(failed, f"16c {kv}", run["counts"], cfg.n_layers, N)
        total = run["counts"] if total is None else {
            k: total[k] + v for k, v in run["counts"].items()}
    # 30 AdamW steps on batches that carry frames
    settings = TrainSettings(optimizer="adamw", lr=1e-3,
                             remat_policy="nothing", q_chunk=448)
    lr_fn = lambda s: SCHEDULES["cosine"](s, peak_lr=settings.lr, warmup=3,
                                          total=TRAIN_STEPS)
    step = step_lib.make_train_step(base, settings, lr_fn=lr_fn)
    state = step_lib.TrainState(params, adamw.adamw_init(params),
                                torch.zeros((), dtype=torch.int32,
                                            device="cuda"))
    stream = SyntheticLM(LEARN_VOCAB, 448, TRAIN_B, seed=0)
    tframes = torch.randn((TRAIN_B, e.n_frames, e.frame_dim), generator=gen,
                          device="cuda").bfloat16()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        batch = {**to_tensors(stream.batch_at(i), "cuda"), "frames": tframes}
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls[4:]))
    say("fullseq", part="16c_train", model=base.name, steps=len(losses),
        batch=f"{TRAIN_B}x448", frames=e.n_frames,
        loss_first5=round(float(np.mean(losses[:5])), 4),
        loss_last5=round(float(np.mean(losses[-5:])), 4),
        loss_final=round(losses[-1], 4), median_step_ms=round(med * 1e3, 3),
        tokens_per_s=round(TRAIN_B * 448 / med, 1),
        peak_mem_gib=round((torch.cuda.max_memory_allocated() - mem0)
                           / 2 ** 30, 3), card=repr(smi))
    if not all(np.isfinite(losses)) \
            or not np.mean(losses[-5:]) < np.mean(losses[:5]):
        failed.append(f"16c: whisper losses {losses}")
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    batch = to_tensors(SyntheticLM(base.vocab, 64, 2, seed=3).batch_at(0))
    batch["frames"] = torch.randn((2, e.n_frames, e.frame_dim),
                                  generator=torch.Generator().manual_seed(3)
                                  ).bfloat16()
    _twin_line("16c_train_twin", fullseq_twin(base, batch), failed)
    return total


VLM_GATE = 0.8          # phase 12's cross gates (zero at init)


def fullseq_vlm(smi: str, failed: list) -> dict:
    """16d: full-width llama-3.2-vision-11b (dense weights, int4, 1601
    patches): forward(return_cache) at 2 x 64 and 8 decode steps (kernel
    6 exactly 32 a step), the first against the dequant route; one train
    step at one macro-block (4 self + 1 cross), widths full, card vs
    CPU."""
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import to_tensors
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = _fullseq_cfg("llama-3.2-vision-11b")
    dq = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant"))
    v = cfg.vision
    params = init_params(cfg, seed=0, device="cuda")
    for k in ("gate_attn", "gate_ffn"):
        params["blocks"]["cross"][k].fill_(VLM_GATE)
    B, P, N = 2, 64, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    patches = torch.randn((B, v.n_patches, v.vision_dim), generator=gen,
                          device="cuda").bfloat16()
    toks = _tokens(cfg.vocab, B, P + N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, cache = M.forward(cfg, params, {"tokens": toks[:, :P],
                                           "patches": patches},
                             return_cache=True, remat_policy="none",
                             q_chunk=P)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        full = _into_horizon(cfg, cache, B, P, N)
        del cache
        ref, _ = M.decode_step(dq, params, full, {
            "tokens": toks[:, P:P + 1], "positions": _positions(B, P)})
    run = _decode_run(cfg, params, full, toks, P, N)
    V = cfg.vocab
    err = rel_err(run["first"][..., :V], ref[..., :V])
    n_self = cfg.n_layers // 5 * 4
    say("fullseq", part="16d_handoff", model=cfg.name, kv=cfg.amc.kv_mode,
        B=B, prompt=P, patches=v.n_patches, forward_ms=round(fwd_ms, 3),
        decode_steps=N,
        kernel6_per_step=run["counts"]["packed_kv_attention"] / N,
        first_step_rel_err_vs_dequant=round(err, 6),
        decode_ms_per_step=round(run["ms"], 3), card=repr(smi))
    if not err < 0.05:
        failed.append(f"16d: first decode step {err} from the dequant route")
    _launch_gate(failed, "16d", run["counts"], n_self, N)
    del params, full
    gc.collect()
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, n_layers=5)
    batch = to_tensors(SyntheticLM(cfg.vocab, 32, 1, seed=3).batch_at(0))
    batch["patches"] = torch.randn((1, v.n_patches, v.vision_dim),
                                   generator=torch.Generator().manual_seed(3)
                                   ).bfloat16()
    _twin_line("16d_train_twin", fullseq_twin(small, batch, gates=VLM_GATE),
               failed)
    return run["counts"]


def fullseq_store(smi: str, failed: list) -> None:
    """16e: AugmentedStore on the card through NORMAL -> AUGMENTED_DUAL ->
    push / peek / pop -> AUGMENTED_TERNARY -> NORMAL, FILO, force,
    retention and refresh, every read and physical byte count against
    the same store on the CPU: 4096 x 4096 with 2-bit trits, and the
    base-3 default at 4095 x 4096 (base-3 packs 5 rows a byte)."""
    from repro_torch.core import (AugmentedStore, FILOViolation, Mode,
                                  RetentionExpired)

    def drive(shape, fmt, dev, w, a):
        st = AugmentedStore(shape, device=dev, retention_steps=2,
                            ternary_fmt=fmt)
        n = shape[0] * shape[1]
        out, phys, events = [], [], []
        st.write_static(w)
        phys.append((st.physical_bytes(), st._dense.numel() * 2, 2 * n))
        st.set_mode(Mode.AUGMENTED_DUAL)
        phys.append((st.physical_bytes(), st._dual.buf.numel(), n))
        out += [st.read_static(), st._dual.buf]
        st.push_dynamic(a)
        try:
            st.read_static()
            events.append("no FILOViolation")
        except FILOViolation:
            events.append("filo")
        out += [st.peek_dynamic(), st.pop_dynamic()]
        st.push_dynamic(a)
        st.tick(3)
        try:
            st.pop_dynamic()
            events.append("no RetentionExpired")
        except RetentionExpired:
            events.append("expired")
        st.refresh(a)
        out.append(st.pop_dynamic())
        st.push_dynamic(a)
        out.append(st.read_static(force=True))     # clobbers the plane
        events.append("clobbered" if not bool((st._dual.buf & 0x0F).any())
                      else "low nibbles left")
        out.append(st._dual.buf)
        st.set_mode(Mode.AUGMENTED_TERNARY)
        per = 5 if fmt == "base3" else 4
        phys.append((st.physical_bytes(), st._tern_packed.numel(),
                     -(-n // per)))
        out += [st._tern_packed, st._tern_scale, st.read_static()]
        st.set_mode(Mode.NORMAL)
        phys.append((st.physical_bytes(), st._dense.numel() * 2, 2 * n))
        out.append(st.read_static())
        return out, phys, events, st

    for shape, fmt in (((4096, 4096), "2bit"), ((4095, 4096), "base3")):
        g = torch.Generator().manual_seed(0)
        w, a = (torch.randn(shape, generator=g) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = drive(shape, fmt, "cuda", w, a)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        host = drive(shape, fmt, "cpu", w, a)
        equal = sum(x.dtype == y.dtype and torch.equal(x.cpu(), y)
                    for x, y in zip(card[0], host[0]))
        phys_ok = all(len(set(p)) == 1 for p in card[1])
        st = card[3]
        say("fullseq", part="16e_store", shape="x".join(map(str, shape)),
            ternary_fmt=fmt, reads_bit_equal=f"{equal}/{len(card[0])}",
            physical_bytes=json.dumps([p[0] for p in card[1]]),
            physical_bytes_match=phys_ok, events=json.dumps(card[2]),
            stats=json.dumps(st.stats), energy_fj=st.energy_fj(),
            card_s=round(card_s, 3), card=repr(smi))
        if equal != len(card[0]) or not phys_ok \
                or card[2] != ["filo", "expired", "clobbered"] \
                or card[2] != host[2] or not st._dense.is_cuda:
            failed.append(f"16e {shape} {fmt}: reads {equal}/"
                          f"{len(card[0])}, bytes {card[1]}, events "
                          f"{card[2]} / {host[2]}")


def phase_fullseq(smi: str) -> dict:
    """16a-16e. Returns the launch counts of the main-path runs (the
    contiguous decode steps after each hand-off)."""
    import shutil
    import tempfile
    failed = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fullseq_")
    runs = []
    try:
        for part in (lambda: fullseq_ssm(smi, tmp, failed),
                     lambda: fullseq_hybrid(smi, failed),
                     lambda: fullseq_audio(smi, failed),
                     lambda: fullseq_vlm(smi, failed)):
            t0 = time.perf_counter()
            runs.append(part())
            say("fullseq", part_wall_s=round(time.perf_counter() - t0, 3))
            gc.collect()
            torch.cuda.empty_cache()
        fullseq_store(smi, failed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return {k: sum(r[k] for r in runs) for k in runs[0]}


# ---------------------------------------------------------------------------
# phase 17: the distributed layer (Rules on a DeviceMesh, sharded steps)
# ---------------------------------------------------------------------------

SHARD_STEPS = 5
SHARD_P, SHARD_C, SHARD_N, SHARD_B = 128, 32, 16, 4


def _shard_trainer(cfg, shape, settings, tmp: str, tag: str, params,
                   mesh=None) -> dict:
    """SHARD_STEPS steps of the Trainer from `params` (a copy), with or
    without `mesh`: losses, step walls, peak memory."""
    from repro_torch.train.trainer import TrainerConfig
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=10 ** 9,
                         warmup=3, seed=0, ckpt_dir=os.path.join(tmp, tag))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = _make_trainer(cfg, shape, settings, tcfg, vocab=None,
                       params=_clone(params), mesh=mesh)
    walls = _timed_steps(tr, SHARD_STEPS)
    out = {"losses": list(tr.losses), "walls": walls,
           "peak": torch.cuda.max_memory_allocated() - base}
    tr.close()
    del tr
    return out


def shard_steps(smi: str, params, mesh, failed: list) -> dict:
    """17b: the contiguous int4 chunked prefill (4 chunks of 32) and 16
    decode steps of full-width qwen through `make_chunk_step` /
    `make_decode_step` with the rules of the 1-rank mesh, against the
    same steps unsharded: kernel 3 exactly 48 launches a chunk, kernel 6
    exactly 24 a decode step, on the local shards."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import Rules, local_shard
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.params import abstract_params
    from repro_torch.train import step as step_lib
    base = _train_parts()[0]
    cfg = dataclasses.replace(base, amc=dataclasses.replace(
        base.amc, weight_mode="normal", kv_mode="int4", kv_impl="kernel"))
    B, P, C, N, L = SHARD_B, SHARD_P, SHARD_C, SHARD_N, cfg.n_layers
    rules = Rules.make(mesh, cfg, ShapeConfig("decode", P + N, B, "decode"))
    ac = M.abstract_cache(cfg, B, P + N)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype, device="cuda")
             for k, s in ac.items()}
    sp = step_lib.distribute(params, abstract_params(cfg), rules)
    scache = step_lib.distribute(cache, ac, rules)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P + N))
                            .astype(np.int32)).cuda()
    def row(t):
        return local_shard(t, mesh, (rules.resolve("batch"),)
                           + (None,) * (t.ndim - 1))
    V = cfg.vocab
    errs, equal = [], []
    k3, k6 = [], []
    chunk_u, chunk_s = (step_lib.make_chunk_step(cfg),
                        step_lib.make_chunk_step(cfg, rules))
    dec_u, dec_s = (step_lib.make_decode_step(cfg),
                    step_lib.make_decode_step(cfg, rules))
    walls = {"sharded": 0.0, "unsharded": 0.0}

    def timed(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[tag] += time.perf_counter() - t0
        return out
    launches = {k: 0 for k in ops.launch_counts()}
    with torch.no_grad():
        for i in range(P // C):
            b = {"tokens": toks[:, i * C:(i + 1) * C],
                 "positions": torch.full((B,), i * C, dtype=torch.int32,
                                         device="cuda"),
                 "write_mask": torch.ones(B, dtype=torch.bool,
                                          device="cuda")}
            lu, cache = timed("unsharded",
                              lambda: chunk_u(params, cache, b))
            sb = {k: row(v) for k, v in b.items()}
            ops.reset_launch_counts()
            ls, scache = timed("sharded", lambda: chunk_s(sp, scache, sb))
            counts = ops.launch_counts()
            k3.append(counts["quantize_pack_kv"])
            for k in launches:
                launches[k] += counts[k]
            ls = ls.to_local()
            errs.append(rel_err(ls[..., :V], lu[..., :V]))
            equal.append(int(torch.equal(ls, lu)))
        for t in range(N):
            b = {"tokens": toks[:, P + t:P + t + 1],
                 "positions": torch.full((B,), P + t, dtype=torch.int32,
                                         device="cuda")}
            lu, cache = timed("unsharded", lambda: dec_u(params, cache, b))
            sb = {k: row(v) for k, v in b.items()}
            ops.reset_launch_counts()
            ls, scache = timed("sharded", lambda: dec_s(sp, scache, sb))
            counts = ops.launch_counts()
            k6.append(counts["packed_kv_attention"])
            for k in launches:
                launches[k] += counts[k]
            ls = ls.to_local()
            errs.append(rel_err(ls[..., :V], lu[..., :V]))
            equal.append(int(torch.equal(ls, lu)))
    cache_equal = {k: float((scache[k].to_local() == cache[k]).float()
                            .mean()) for k in cache}
    say("shard", part="17b", kv="int4", chunks=P // C, decode_steps=N,
        kernel3_per_chunk=json.dumps(sorted(set(k3))),
        kernel6_per_step=json.dumps(sorted(set(k6))),
        worst_logit_rel_err=round(max(errs), 6),
        bit_equal_logits=f"{sum(equal)}/{len(equal)}",
        cache_equal_share=json.dumps({k: round(v, 6)
                                      for k, v in cache_equal.items()}),
        sharded_wall_s=round(walls["sharded"], 3),
        unsharded_wall_s=round(walls["unsharded"], 3), card=repr(smi))
    if set(k3) != {2 * L}:
        failed.append(f"17b: kernel 3 launched {k3} times a chunk, want "
                      f"{2 * L}")
    if set(k6) != {L}:
        failed.append(f"17b: kernel 6 launched {k6} times a decode step, "
                      f"want {L}")
    if not max(errs) < 0.05:
        failed.append(f"17b: logits vs the unsharded steps {max(errs)}")
    return launches


def _shard_rank(rank: int, store: str, out: str, losses_ref: list) -> None:
    """17c, one of 4 ranks (one card each, NCCL): the sharded Trainer on
    a (2, 2) ("data", "model") mesh, the compressed all-reduce over the
    pod axis of a (2, 2) ("pod", "data") mesh, a 2-stage pipeline."""
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="file://" + store,
                            rank=rank, world_size=4)
    res = {}
    try:
        from repro_torch.distributed import collectives as coll
        from repro_torch.distributed.pipeline import pipeline_forward
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.params import init_params
        cfg, shape, settings, _ = _train_parts()
        mesh = make_mesh((2, 2), ("data", "model"))
        params = init_params(cfg, seed=0, device="cuda")
        run = _shard_trainer(cfg, shape, settings, out, f"r{rank}", params,
                             mesh=mesh)
        res["losses"] = run["losses"]
        res["walls"] = run["walls"]
        res["worst_vs_17a"] = max(abs(a - b) for a, b in
                                  zip(run["losses"], losses_ref))
        pod = make_mesh((2, 2), ("pod", "data"))
        me = pod.get_local_rank("pod")
        gs = [torch.randn(256, 1024, generator=torch.Generator()
                          .manual_seed(s)).cuda() * 1e-3 for s in (0, 1)]
        got, _ = coll.compressed_allreduce_mean(gs[me], pod.get_group("pod"))
        qs = [coll._q8(g) for g in gs]
        want = (qs[0][0].float() * qs[0][1] + qs[1][0].float() * qs[1][1]) \
            / 2.0
        res["allreduce_bit_equal"] = bool(torch.equal(got, want))
        w = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(
            2)).cuda() / 8
        xs = torch.randn(3, 4, 64, generator=torch.Generator().manual_seed(
            3)).cuda()
        y = pipeline_forward(pod, lambda p, x: torch.tanh(x @ p), 3)(w, xs)
        direct = torch.tanh(torch.tanh(xs @ w[0]) @ w[1])
        res["pipeline_max_abs"] = float((y - direct).abs().max())
    finally:
        if rank == 0:
            with open(os.path.join(out, "17c.json"), "w") as f:
                json.dump(res, f)
        dist.destroy_process_group()


def shard_4cards(smi: str, tmp: str, losses_ref: list, failed: list):
    """17c on 4 cards, or the line saying why not."""
    n = torch.cuda.device_count()
    if n < 4:
        say("shard", part="17c", skipped=f"device_count={n}")
        return
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    ctx = mp.start_processes(_shard_rank, args=(
        os.path.join(tmp, "store4"), tmp, losses_ref), nprocs=4,
        join=False, start_method="spawn")
    while not ctx.join(timeout=300):
        if time.perf_counter() - t0 > 300:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            failed.append("17c: ranks not joined within 300 s")
            return
    with open(os.path.join(tmp, "17c.json")) as f:
        res = json.load(f)
    say("shard", part="17c", mesh="2x2", losses=json.dumps(
        [round(x, 5) for x in res["losses"]]),
        worst_abs_vs_17a=round(res["worst_vs_17a"], 6),
        median_step_ms=round(float(np.median(res["walls"][1:])) * 1e3, 3),
        allreduce_bit_equal=res["allreduce_bit_equal"],
        pipeline_max_abs=res["pipeline_max_abs"], card=repr(smi))
    if not res["worst_vs_17a"] < 2e-2:
        failed.append(f"17c: 2x2 losses vs 17a {res['worst_vs_17a']}")
    if not res["allreduce_bit_equal"]:
        failed.append("17c: the compressed all-reduce is not the mean of "
                      "the dequantized rows")
    if not res["pipeline_max_abs"] < 1e-5:
        failed.append(f"17c: pipeline vs direct {res['pipeline_max_abs']}")


def phase_shard(smi: str) -> dict:
    """17a-17c. Returns the launch counts of 17b's sharded steps."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import init_params
    failed = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "store1"), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg, shape, settings, _ = _train_parts()
        params = init_params(cfg, seed=0, device="cuda")
        plain = _shard_trainer(cfg, shape, settings, tmp, "u", params)
        shard = _shard_trainer(cfg, shape, settings, tmp, "s", params,
                               mesh=mesh)
        worst = max(abs(a - b) for a, b in zip(shard["losses"],
                                               plain["losses"]))
        same = sum(a == b for a, b in zip(shard["losses"], plain["losses"]))
        say("shard", part="17a", mesh="1x1", steps=SHARD_STEPS,
            losses=json.dumps([round(x, 5) for x in shard["losses"]]),
            worst_abs_vs_unsharded=worst,
            bit_equal_losses=f"{same}/{SHARD_STEPS}",
            median_step_ms=round(float(np.median(shard["walls"][1:])) * 1e3,
                                 3),
            unsharded_median_step_ms=round(float(np.median(
                plain["walls"][1:])) * 1e3, 3),
            peak_mem_gib=round(shard["peak"] / 2 ** 30, 3),
            unsharded_peak_mem_gib=round(plain["peak"] / 2 ** 30, 3),
            card=repr(smi))
        if not worst < 1e-3:
            failed.append(f"17a: 1x1 mesh losses vs unsharded {worst}")
        launches = shard_steps(smi, params, mesh, failed)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    try:
        shard_4cards(smi, tmp, plain["losses"], failed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("shard", phase_wall_s=round(time.perf_counter() - t_phase, 3))
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


DRY_B, DRY_P, DRY_C = 4, 144, 32


def phase_dryrun(smi: str) -> dict:
    """18a-18c: the dry run (`launch/dryrun.py`, a meta-device trace)
    held to the card. Returns the launch counts of the real steps."""
    import shutil
    import tempfile
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import Rules
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import model as M
    from repro_torch.models.params import abstract_params, init_params
    from repro_torch.tree import flatten
    failed = []
    t_phase = time.perf_counter()
    total = {k: 0 for k in ops.launch_counts()}

    # 18a: 15a's configuration on a (1, 1) stand-in mesh
    cfg, shape, settings, tcfg = _train_parts()
    mesh = dryrun.StandInMesh({"data": 1, "model": 1})
    want = dryrun.cell_bytes(cfg, shape, Rules.make(mesh, cfg, shape),
                             settings)
    fn, args = dryrun.cell_step(cfg, shape, settings)
    _, traced = dryrun.trace(fn, args)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    tcfg = dataclasses.replace(tcfg, ckpt_dir=tmp)
    tr = _make_trainer(cfg, shape, settings, tcfg)
    held = sum(t.numel() * t.element_size() for t in
               flatten(tr.state.params)[0] + flatten(tr.state.opt)[0])
    ops.reset_launch_counts()
    with FlopCounterMode(display=False) as fc:
        tr.train(n_steps=1)
    real_flops = fc.get_total_flops()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = _timed_steps(tr, 4)[1:]
    card_peak = torch.cuda.max_memory_allocated() - base
    for k, v in ops.launch_counts().items():
        total[k] += v
    tr.close()
    shutil.rmtree(tmp, ignore_errors=True)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    step_s = float(np.median(walls))
    compute_s = traced["flops"] / BF16_FLOP_PER_S
    say("dryrun", part="18a", arch=cfg.name, batch=shape.global_batch,
        seq=shape.seq_len, mesh="1x1",
        params_opt_bytes_dry=want["params"] + want["opt"],
        params_opt_bytes_card=held,
        traced_flops=traced["flops"], card_flops=real_flops,
        traced_bytes=traced["bytes_accessed"],
        traced_peak_live_gib=round(traced["peak_live_bytes"] / 2 ** 30, 4),
        card_step_peak_gib=round(card_peak / 2 ** 30, 4),
        median_step_ms=round(step_s * 1e3, 3),
        compute_s_ms=round(compute_s * 1e3, 3),
        compute_share_of_step=round(compute_s / step_s, 4),
        card=repr(smi))
    if want["params"] + want["opt"] != held:
        failed.append(f"18a: dry-run bytes {want['params'] + want['opt']} "
                      f"vs the Trainer's {held}")
    if traced["flops"] != real_flops:
        failed.append(f"18a: traced FLOPs {traced['flops']} vs the card's "
                      f"{real_flops}")

    # 18b / 18c: qwen's contiguous steps at full width, dense weights
    base = get_arch("qwen1.5-0.5b")
    params = init_params(dataclasses.replace(base, amc=dataclasses.replace(
        base.amc, weight_mode="normal")), seed=0, device="cuda")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, base.vocab, (DRY_B, DRY_C))
                            .astype(np.int32)).cuda()
    pos = torch.full((DRY_B,), DRY_P - 1, dtype=torch.int32, device="cuda")
    meta_params = dryrun._on_meta(abstract_params(base))

    def cfg_at(kv: str, impl: str = "kernel"):
        return dataclasses.replace(base, amc=dataclasses.replace(
            base.amc, weight_mode="normal", kv_mode=kv, kv_impl=impl))

    def steps(cfg):
        """(name, step fn, card args, meta args) of one decode step and
        one prefill chunk over a zeroed cache of DRY_P tokens."""
        from repro_torch.train import make_chunk_step, make_decode_step
        ab = M.abstract_cache(cfg, DRY_B, DRY_P)
        card = lambda: {k: torch.zeros(s.shape, dtype=s.dtype,
                                       device="cuda") for k, s in ab.items()}
        meta = lambda: dryrun._on_meta(ab)
        dec = {"tokens": toks[:, :1], "positions": pos}
        chunk = {"tokens": toks, "positions": torch.zeros_like(pos)}
        on_meta = lambda b: {k: v.to("meta") for k, v in b.items()}
        return [("decode", make_decode_step(cfg), (params, card(), dec),
                 (meta_params, meta(), on_meta(dec))),
                ("chunk", make_chunk_step(cfg), (params, card(), chunk),
                 (meta_params, meta(), on_meta(chunk)))]

    # 18b: launches predicted by the meta trace == launched on the card
    for name, fn, card_args, meta_args in steps(cfg_at("int4")):
        _, pred = dryrun.trace(fn, meta_args)
        predicted = {k: pred["kernels"].get(k, {}).get("launches", 0)
                     for k in total}
        ops.reset_launch_counts()
        with torch.no_grad():
            fn(*card_args)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        for k in total:
            total[k] += got[k]
        say("dryrun", part="18b", step=name, kv="int4",
            predicted=json.dumps({k: v for k, v in predicted.items() if v}),
            launched=json.dumps({k: v for k, v in got.items() if v}),
            card=repr(smi))
        if predicted != got:
            failed.append(f"18b {name}: predicted {predicted}, launched "
                          f"{got}")

    # 18c: no dense cache on the kernel route; the dequant route makes one
    dims = (DRY_B, DRY_P, base.n_kv_heads, base.hd)
    watch = [(dims, torch.bfloat16), (dims, torch.float32)]
    for kv, impl in (("int4", "kernel"), ("int8", "kernel"),
                     ("int4", "dequant")):
        _, fn, card_args, _ = steps(cfg_at(kv, impl))[0]
        ops.reset_launch_counts()
        with torch.no_grad(), OpAnalysis(watch) as a:
            fn(*card_args)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        for k in total:
            total[k] += got[k]
        bf16, f32 = (sum(c.values()) for c in a.shapes)
        say("dryrun", part="18c", kv=kv, kv_impl=impl,
            bf16_cache_tensors=bf16, f32_cache_tensors=f32,
            by_op=json.dumps([dict(c) for c in a.shapes]),
            kernel6=got["packed_kv_attention"], card=repr(smi))
        if impl == "kernel" and (bf16 or (kv == "int8" and f32)):
            failed.append(f"18c {kv}: the kernel route made a dense cache "
                          f"(bf16 {bf16}, f32 {f32})")
        if impl == "dequant" and not bf16 + f32:
            failed.append("18c: the dequant route made no dense cache "
                          "(the watch sees nothing)")
        if impl == "kernel" and got["packed_kv_attention"] != base.n_layers:
            failed.append(f"18c {kv}: kernel 6 launched "
                          f"{got['packed_kv_attention']} times, want "
                          f"{base.n_layers}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    say("dryrun", phase_wall_s=round(time.perf_counter() - t_phase, 3))
    if failed:
        raise AssertionError("; ".join(failed))
    return total


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
    slabs), mamba2-130m (Normal slabs), qwen3-moe-30b-a3b (dual, int4,
    full width and depth), whisper-tiny (int8, the cross KV on the
    pool's prefix band) and llama-3.2-vision-11b (int4 pages and the
    patch slab, full width and depth), minicpm-2b and minitron-8b (dual,
    int4, full width and depth): 8 decode steps of 4 rows each; a
    2-array qwen fleet (kv int4, 2 rows an array on cuda:0): 16 rounds;
    5 train steps of phase 15a's configuration (full-width qwen, batch 8
    x seq 512, AdamW, remat "nothing").
    Prints device time by kernel and the
    device's busy share of each window; full tables go to `out_dir`."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import ArrayFleet, Request, ServeEngine
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
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch("mamba2-130m")
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=256, seed=0)
    rng = np.random.default_rng(3)
    for i in range(4):                  # prefilled token by token here
        eng.add_request(Request(
            prompt=rng.integers(0, cfg.vocab, size=17).astype(np.int32),
            max_new_tokens=32, id=i))
    steps(eng, 2)()                     # warm-up
    profile_window("ssm_decode", steps(eng, 8), out_dir)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch("qwen3-moe-30b-a3b")
    eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                      prefill_chunk=32, seed=0)
    rng = np.random.default_rng(4)
    for i in range(4):
        eng.add_request(Request(
            prompt=rng.integers(0, cfg.vocab, size=129).astype(np.int32),
            max_new_tokens=64, id=i))
    steps(eng, 2)()                     # warm-up
    profile_window("moe_decode", steps(eng, 8), out_dir)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    for arch, max_seq, seed in (("whisper-tiny", 512, 5),
                                ("llama-3.2-vision-11b", 64, 6)):
        cfg = get_arch(arch)
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=max_seq,
                          seed=0)
        rng = np.random.default_rng(seed)
        for i in range(4):              # prefilled token by token here
            eng.add_request(Request(
                prompt=rng.integers(0, cfg.vocab, size=17).astype(np.int32),
                max_new_tokens=32, id=i))
        steps(eng, 2)()                 # warm-up
        profile_window(f"{cfg.family}_decode", steps(eng, 8), out_dir)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    for arch, label in (("minicpm-2b", "minicpm_decode"),
                        ("minitron-8b", "minitron_decode")):
        cfg = get_arch(arch)
        eng = ServeEngine(cfg, device="cuda", max_batch=4, max_seq=512,
                          prefill_chunk=32, seed=0)
        rng = np.random.default_rng(7)
        for i in range(4):
            eng.add_request(Request(
                prompt=rng.integers(0, cfg.vocab, size=129).astype(np.int32),
                max_new_tokens=64, id=i))
        steps(eng, 2)()                 # warm-up
        profile_window(label, steps(eng, 8), out_dir)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # the fleet: 2 arrays of 2 rows on cuda:0, a round decodes both
    cfg = get_arch("qwen1.5-0.5b")
    fleet = ArrayFleet(cfg, device="cuda", num_arrays=2, max_batch=2,
                       max_seq=512, prefill_chunk=32, kv_mode="int4", seed=0)
    rng = np.random.default_rng(0)
    for i in range(4):
        fleet.add_request(Request(
            prompt=rng.integers(0, cfg.vocab, size=129).astype(np.int32),
            max_new_tokens=128, id=i))
    steps(fleet, 2)()                   # warm-up
    profile_window("fleet_rounds", steps(fleet, 16), out_dir)
    del fleet
    gc.collect()
    torch.cuda.empty_cache()

    profile_train(out_dir)


def profile_train(out_dir: Path) -> None:
    """The train-step window: 15a's configuration (AdamW, remat
    "nothing"), 5 steps after 2 of warm-up."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tr = _make_trainer(*_train_parts(ckpt_dir=tmp, total_steps=100))
        tr.train(n_steps=2)             # warm-up

        def train_steps():
            tr.train(n_steps=5)
            return 5
        profile_window("train_step", train_steps, out_dir)
        tr.close()
        del tr
    gc.collect()
    torch.cuda.empty_cache()


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
            "paged_kv_write": check_paged_write(gen),
            "expert_matmul": check_expert(gen)}
    check_cow(gen)
    qwen = phase_main(smi)
    granite = phase_granite(smi)
    imc = phase_imc(smi, qwen, granite)
    del granite["params"]
    qparams = qwen.pop("params")
    share = phase_share(smi, qparams)
    share_golden = share.pop("share_on")
    share = share["launches"]
    hybrid = phase_hybrid(smi)
    traced = phase_obs(smi, qparams, qwen.pop("prompts"),
                       qwen.pop("spec_out"))
    del qparams
    ssm = phase_ssm(smi, hybrid)
    moe = phase_moe(smi)
    audio = phase_audio(smi, gen)
    vlm = phase_vlm(smi)
    archs = phase_archs(smi)
    fleet = phase_fleet(smi, {"out": qwen["int4_out"],
                              "wall_s": qwen["int4_wall_s"]}, share_golden)
    train = phase_train(smi)
    fullseq = phase_fullseq(smi)
    shard = phase_shard(smi)
    dry = phase_dryrun(smi)
    rows["paged_kv_attention"]["shapes"].append(audio["band"])
    rows["dense_matmul"]["shapes"].append(rows["expert_matmul"].pop("router"))
    launches = {k: qwen["launches"][k] + granite["launches"][k]
                + imc[k] + share[k] + hybrid["counts"][k] + traced[k]
                + ssm[k] + moe[k] + audio["launches"][k] + vlm[k]
                + archs[k] + fleet[k] + train[k] + fullseq[k] + shard[k]
                + dry[k] for k in qwen["launches"]}
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
