"""Serving launcher: batched greedy decoding over the augmented KV pool,
on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --requests 8 --prompt-len 48 --max-new 32 \
      --trace-out trace.json --metrics-out metrics.prom

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen1.5-0.5b --reduced --requests 4 --max-new 6

Weights are random, from seed 0; the requests are synthetic prompts from
``numpy.random.default_rng(0)``, each behind an optional common system
prompt (``--shared-prefix``). The flags are those of
`repro.launch.serve`. ``--num-arrays`` above 1 serves through an
`ArrayFleet` (one engine per logical array, sharing the cards
round-robin when there are fewer cards than arrays), placed by
``--placement``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --num-arrays 2 --placement affinity --shared-prefix 120
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.serve.engine import Request
from repro_torch.serve.fleet import ArrayFleet, make_serving


def make_requests(cfg, *, n: int, prompt_len: int, shared_prefix: int,
                  max_new: int) -> list[Request]:
    """The launcher's synthetic requests: `shared_prefix` common tokens,
    then `prompt_len` tokens of each request's own, from
    ``numpy.random.default_rng(0)`` (the JAX launcher's stream)."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab,
                          size=(shared_prefix,)).astype(np.int32)
    return [Request(prompt=np.concatenate(
                        [system, rng.integers(0, cfg.vocab,
                                              size=(prompt_len,))
                         .astype(np.int32)]),
                    max_new_tokens=max_new, id=i)
            for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' is the only "
                         "way onto the CPU)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=5,
                    help="synthetic prompt length (longer prompts build "
                         "more cold storage — pressure + fault surface)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--retention-steps", type=int, default=None,
                    help="augmented retention window override (small "
                         "windows force refresh traffic)")
    ap.add_argument("--pool-mode", default=None,
                    choices=["normal-only", "augment-on-pressure",
                             "always-augmented"],
                    help="paged-pool policy override (default: auto from "
                         "kv_mode)")
    ap.add_argument("--pool-budget-bytes", type=int, default=None,
                    help="paged-pool byte budget (the modeled SRAM array "
                         "size; small budgets exercise augmentation "
                         "pressure and preemption)")
    ap.add_argument("--matmul-impl", default=None,
                    choices=["dense", "packed", "imc"],
                    help="consumer for packed weight matmuls (imc = "
                         "bit-serial in-array dot product)")
    ap.add_argument("--imc-abits", type=int, default=None,
                    choices=[1, 4, 8],
                    help="IMC activation precision (bit-serial cycles)")
    ap.add_argument("--state-bits", type=int, default=None,
                    choices=[4, 8],
                    help="augmented recurrent-state slab width (ssm and "
                         "hybrid stores)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative window: draft spec_k-1 tokens per "
                         "round out of the cheap plane, verify them in "
                         "one packed dispatch (1 = stepwise decode)")
    ap.add_argument("--spec-draft-impl", default=None,
                    choices=["dequant", "dense", "packed", "imc1", "imc4",
                             "imc8", "same"],
                    help="representation the draft pass reads (default "
                         "dequant: gather + dense attention over "
                         "dequantized KV)")
    ap.add_argument("--fault-rate", type=float, default=None,
                    help="per-unit retention-fault probability at end of "
                         "window, 85C (0 disables injection)")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="seed of the deterministic fault sampler")
    ap.add_argument("--array-loss-rate", type=float, default=None,
                    help="per-step whole-array failure probability "
                         "(drain-and-requeue recovery)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="fault-recovery retries per request before it is "
                         "failed (never silently served)")
    ap.add_argument("--no-integrity-check", action="store_true",
                    help="disable integrity-word verification (ablation: "
                         "forfeits the zero-silent-corruption property)")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="record per-request spans and write a "
                         "perfetto-loadable Chrome trace here (implies "
                         "tracing on)")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.prom",
                    help="record latency histograms / time series and "
                         "write a Prometheus text dump here (implies "
                         "metrics on)")
    ap.add_argument("--obs-sample-every", type=int, default=None,
                    help="time-series sampling stride in engine steps "
                         "(default 1: every step)")
    ap.add_argument("--num-arrays", type=int, default=None,
                    help="logical SRAM arrays to serve across (>1 runs "
                         "an ArrayFleet: per-array budgets, refresh "
                         "clocks, fault domains and trace lanes)")
    ap.add_argument("--placement", default=None,
                    choices=["least-loaded", "budget-headroom", "affinity"],
                    help="fleet admission policy (default: "
                         "cfg.amc.placement = least-loaded)")
    ap.add_argument("--prefix-cache", type=int, default=None,
                    help="shared-prefix page-reuse entries per array "
                         "(paged stores; "
                         ">0 maps repeated prompt prefixes to the same "
                         "physical pages and prefills only the tail; 0 "
                         "disables)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common system-prompt tokens "
                         "to every synthetic request (the prefix-cache "
                         "hit workload)")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.state_bits is not None:
        cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, state_bits=args.state_bits))
    eng = make_serving(cfg, device=args.device, num_arrays=args.num_arrays,
                       placement=args.placement, max_batch=args.max_batch,
                       max_seq=args.max_seq, pool_mode=args.pool_mode,
                       pool_budget_bytes=args.pool_budget_bytes,
                       retention_steps=args.retention_steps,
                       matmul_impl=args.matmul_impl,
                       imc_abits=args.imc_abits,
                       spec_k=args.spec_k,
                       spec_draft_impl=args.spec_draft_impl,
                       fault_rate=args.fault_rate,
                       fault_seed=args.fault_seed,
                       array_loss_rate=args.array_loss_rate,
                       max_retries=args.max_retries,
                       integrity_check=(False if args.no_integrity_check
                                        else None),
                       trace=(True if args.trace_out else None),
                       metrics=(True if args.metrics_out else None),
                       obs_sample_every=args.obs_sample_every,
                       prefix_cache=args.prefix_cache)
    reqs = make_requests(cfg, n=args.requests, prompt_len=args.prompt_len,
                         shared_prefix=args.shared_prefix,
                         max_new=args.max_new)
    outs = eng.generate(reqs)
    for rid in sorted(outs):
        print(f"[serve] req {rid}: {outs[rid]}")
    if isinstance(eng, ArrayFleet):
        fleet_report(eng, args)
        return
    print(f"[serve] kv_mode={eng.cfg.amc.kv_mode} "
          f"(augmented KV capacity factor "
          f"{ {'normal':1,'int8':2,'int4':4}[eng.cfg.amc.kv_mode] }x)")
    st = eng.stats()
    imc = st["imc"]
    print(f"[serve] matmul_impl={imc['matmul_impl']} "
          f"abits={imc['imc_abits']} "
          f"modeled_energy_pj_per_token={imc['energy_pj_per_token']:.1f}")
    sp = st["spec"]
    if sp["enabled"]:
        print(f"[serve] spec_k={sp['spec_k']} draft={sp['spec_draft_impl']} "
              f"accepted/dispatch={sp['accepted_tokens_per_dispatch']:.2f} "
              f"accepted/round={sp['accepted_tokens_per_round']:.2f} "
              f"rounds={sp['spec_rounds']}")
    live = st["pool"]
    if eng.store.kind == "paged":
        occupancy = (f"pages(norm/aug)={live['pages_live_normal']}/"
                     f"{live['pages_live_augmented']}")
    elif eng.store.kind == "slab":
        occupancy = (f"slabs(norm/aug)={live['slabs_live_normal']}/"
                     f"{live['slabs_live_augmented']}")
    else:
        occupancy = f"parts={sorted(live['parts'])}"
    print(f"[serve] store={eng.store.kind} {occupancy} "
          f"augments={st['augment_events']} refreshes={st['refreshes']} "
          f"preemptions={st['preemptions']} "
          f"queue_peak={st['scheduler']['peak_queue_depth']}")
    pf = st["prefix"]
    if pf["enabled"]:
        print(f"[serve] prefix_cache entries={pf['capacity']} "
              f"hits={pf['hits']} misses={pf['misses']} "
              f"hit_rate={pf['hit_rate']:.2f} "
              f"dispatches_saved={pf['dispatches_saved']} "
              f"cow={pf['cow_events']} demotions={pf['demotions']} "
              f"evictions={pf['evictions']}")
    fl = st["faults"]
    if fl["enabled"]:
        print(f"[serve] faults injected={fl['faults_injected']} "
              f"detected={fl['faults_detected']} "
              f"masked={fl['faults_masked']} recovered={fl['recovered']} "
              f"(scrub={fl['recovered_scrub']} "
              f"recompute={fl['recovered_recompute']}) "
              f"uncorrectable={fl['uncorrectable']} "
              f"array_losses={fl['array_losses']} "
              f"zero_silent_corruption={fl['zero_silent_corruption']}")
    if args.trace_out:
        trace = eng.export_trace(args.trace_out)
        print(f"[serve] trace: {len(trace['traceEvents'])} events -> "
              f"{args.trace_out}")
    if args.metrics_out:
        eng.export_metrics(args.metrics_out)
        h = st["obs"]["histograms"]
        if "ttft_s" in h:
            print(f"[serve] obs: ttft_p50={h['ttft_s']['p50'] * 1e3:.2f}ms "
                  f"p99={h['ttft_s']['p99'] * 1e3:.2f}ms "
                  f"step_p50={h['step_wall_s']['p50'] * 1e3:.2f}ms "
                  f"-> {args.metrics_out}")


def fleet_report(fleet: ArrayFleet, args) -> None:
    """The JAX launcher's fleet lines, the merged trace and the
    fleet-wide metrics."""
    fl = fleet.stats()["fleet"]
    print(f"[serve] fleet arrays={fl['num_arrays']} "
          f"placement={fl['placement']} "
          f"peak_concurrency={fl['peak_concurrency']} "
          f"migrations={fl['migrations']} "
          f"array_losses={fl['array_losses']} "
          f"placements_per_array={fl['placements_per_array']}")
    for a in fl["per_array"]:
        print(f"[serve]   array {a['array']}: alive={a['alive']} "
              f"peak_conc={a['peak_concurrency']} "
              f"occupancy={a['occupancy']:.2f} "
              f"mode(norm/aug)={a['mode_normal']}/{a['mode_augmented']} "
              f"refresh_debt={a['refresh_debt']} "
              f"tp={a['tensor_parallel']}")
    if args.trace_out:
        trace = fleet.export_trace(args.trace_out)
        print(f"[serve] trace: {len(trace['traceEvents'])} events "
              f"({fl['num_arrays']} array lanes) -> {args.trace_out}")
    if args.metrics_out:
        fleet.export_metrics(args.metrics_out)
        print(f"[serve] metrics (fleet-wide) -> {args.metrics_out}")


if __name__ == "__main__":
    main()
