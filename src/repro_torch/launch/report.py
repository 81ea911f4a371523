"""Tables of the dry run's per-cell records (`launch/dryrun.py`): the
port of `repro.launch.report`.

  PYTHONPATH=src python -m repro_torch.launch.report \\
      --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_records(out_dir: str) -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        r["_file"] = os.path.basename(fn)
        # the file's last tag: "pod", "multipod" or a run_cell mesh's
        # axis sizes ("32x8")
        r["_layout"] = r["_file"][:-len(".json")].rsplit("_", 1)[1]
        recs.append(r)
    return recs


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _launches(kernels: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in sorted(kernels.items())) or "–"


def dryrun_table(recs: list[dict], multipod: bool) -> str:
    rows = ["| arch | shape | status | HBM/dev | fits 80 GB | kernel "
            "launches a step |",
            "|---|---|---|---|---|---|"]
    for r in recs:
        if r["_layout"] != ("multipod" if multipod else "pod"):
            continue
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP: "
                        f"{r['reason'][:46]} | – | – | – |")
            continue
        m = r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{m['total_gib_per_device']:.2f}GiB | "
            f"{'yes' if m['fits_80gb'] else 'NO'} | "
            f"{_launches(r['kernels'])} |")
    return "\n".join(rows)


def roofline_table(recs: list[dict]) -> str:
    rows = ["| arch | shape | compute | memory | dominant | MODEL/traced "
            "flops | roofline frac |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["_layout"] != "pod" or r.get("skipped"):
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {r['dominant']} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} |")
    return "\n".join(rows)


def layout_table(recs: list[dict], alt: str = "32x8") -> str:
    """Per-device bytes of each traced (16, 16) record beside its record
    at layout `alt` (`run_cell(mesh=...)`), where the arguments differ."""
    other = {(r["arch"], r["shape"]): r for r in recs
             if r["_layout"] == alt and not r.get("skipped")}
    rows = ["| arch | shape | (16, 16) GiB/dev | "
            f"({alt.replace('x', ', ')}) GiB/dev |",
            "|---|---|---|---|"]
    for r in recs:
        o = other.get((r["arch"], r["shape"]))
        if r["_layout"] != "pod" or o is None or \
                o["memory"]["argument_bytes"] == r["memory"]["argument_bytes"]:
            continue
        rows.append(f"| {r['arch']} | {r['shape']} | "
                    f"{r['memory']['total_gib_per_device']:.3f} | "
                    f"{o['memory']['total_gib_per_device']:.3f} |")
    return "\n".join(rows)


def summarize(out_dir: str) -> str:
    recs = load_records(out_dir)
    n_ok = sum(1 for r in recs if not r.get("skipped"))
    n_skip = sum(1 for r in recs if r.get("skipped"))
    differ = [f"{r['arch']} {r['shape']}" + ("" if r["_layout"] == "pod"
                                             else f" ({r['_layout']})")
              for r in recs if not r.get("skipped")
              and "inference_fsdp" in r
              and r["inference_fsdp"] != r["inference_fsdp_at_16gib"]]
    parts = [
        f"Records: {len(recs)} ({n_ok} traced, {n_skip} recorded skips)",
        "",
        "### Single-pod (16x16 = 256 cards) dry-run",
        "",
        dryrun_table(recs, multipod=False),
        "",
        "### Multi-pod (2x16x16 = 512 cards) dry-run",
        "",
        dryrun_table(recs, multipod=True),
        "",
        "### Roofline terms (single-pod, per device, per step)",
        "",
        roofline_table(recs),
        "",
        "### Per-device bytes, (16, 16) against (32, 8)",
        "",
        layout_table(recs),
        "",
        "Inference FSDP decided otherwise at 80 GB than at 16 GiB: "
        + (", ".join(differ) or "none"),
    ]
    return "\n".join(parts)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()
    print(summarize(args.out))
