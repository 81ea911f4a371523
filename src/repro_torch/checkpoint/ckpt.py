"""Fault-tolerant checkpointing: atomic, asynchronous, the JAX package's
on-disk layout.

Layout per step:
    <dir>/step_00000042.tmp/...   (written first)
    <dir>/step_00000042/          (atomic rename when complete)
        manifest.json             (tree structure, shapes, dtypes, step,
                                   data-iterator state, content digests)
        arr_<i>.npy               (one file per leaf, the full array)

The port of `repro.checkpoint.ckpt`. Leaves are numbered in the order
`jax.tree.flatten` gives them (dict keys sorted, tuple and NamedTuple
fields in order, None holding no leaf), bf16 leaves are stored as their
uint16 bits with "bfloat16" in the manifest, and the manifest has the
same keys, so a checkpoint written by either package restores into the
other. A partial checkpoint (no manifest) is invisible to `latest_step`.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import describe, flatten, unflatten


# ---------------------------------------------------------------------------
# Leaves <-> stored numpy arrays
# ---------------------------------------------------------------------------

def _encode(leaf):
    """A leaf -> (the array stored, its logical dtype name): bf16 as its
    uint16 bits, as the JAX package stores its bfloat16 leaves."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if name not in (arr.dtype.name,):
        raise TypeError(f"stored {arr.dtype.name} for a {name} leaf")
    return torch.from_numpy(np.array(arr, copy=True))


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Atomic synchronous save. Returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = flatten(tree)
    entries = []
    for i, leaf in enumerate(leaves):
        stored, dtype_name = _encode(leaf)
        fn = f"arr_{i}.npy"
        np.save(os.path.join(tmp, fn), stored, allow_pickle=False)
        entries.append({"file": fn, "shape": list(stored.shape),
                        "dtype": dtype_name,
                        "digest": hashlib.sha256(
                            stored.tobytes()[:4096]).hexdigest()[:16]})
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": describe(treedef), "entries": entries,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def host_snapshot(tree):
    """A CPU copy of every tensor leaf of `tree`: its own storage even
    where the leaf already lies on the CPU (`.cpu()` would share it), so
    the caller's in-place updates after this call do not reach it."""
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [
        l.detach().to("cpu", copy=True) if isinstance(l, torch.Tensor)
        else np.array(l, copy=True) for l in leaves])


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one write in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree, extra=None) -> None:
        # the host copy is taken now, on the caller's thread (the train
        # state is updated in place by the next step); the write is async
        tree_host = host_snapshot(tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, tree_host, extra), daemon=True)
        self._thread.start()

    def _write(self, step, tree_host, extra):
        save(self.ckpt_dir, step, tree_host, extra)
        self._gc()

    def _gc(self):
        steps = sorted(all_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree, device=None):
    """Load step `step` into the structure of `like_tree`. Each leaf lands
    on its `like_tree` leaf's device (or on `device` when given). Returns
    (tree, extra)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"tree structure changed: {manifest['n_leaves']} "
                         f"leaves stored, {len(leaves)} wanted")
    out = []
    for i, leaf in enumerate(leaves):
        arr = np.load(os.path.join(final, f"arr_{i}.npy"))
        t = _decode(arr, manifest["entries"][i]["dtype"])
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(t.to(dev))
    return unflatten(treedef, out), manifest["extra"]
