"""Deterministic synthetic token pipeline.

Production-shaped: per-step batches, a background prefetch thread, and a
checkpointable iterator state (the stream is a pure function of (seed,
step), so restoring `step` resumes bit for bit: no sample skipped or
repeated after a crash). `SyntheticLM` is `repro.data.SyntheticLM`
line for line (numpy only), so both packages draw the same batches byte
for byte.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class SyntheticLM:
    """Zipf-ish token stream with enough structure to overfit a tiny LM
    (next-token = f(current) mixtures), deterministic per (seed, step)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        # the structural map (a, b) is FIXED per seed so there is signal to
        # learn; initial tokens and noise vary per step
        srng = np.random.default_rng(np.random.SeedSequence([self.seed]))
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.vocab
        # markov-ish: tok[t+1] = (a * tok[t] + b + noise) % V with a GLOBAL
        # (a, b) so next-token is a learnable function of the current token
        a = srng.integers(2, 8, size=(1, 1))
        b = srng.integers(0, V, size=(1, 1))
        t0 = rng.integers(0, V, size=(B, 1))
        toks = [t0]
        for _ in range(S):
            nxt = (a * toks[-1] + b) % V
            flip = rng.random((B, 1)) < 0.1
            rand = rng.integers(0, V, size=(B, 1))
            toks.append(np.where(flip, rand, nxt))
        seq = np.concatenate(toks, axis=1)           # (B, S+1)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "targets": seq[:, 1:].astype(np.int32)}


def to_tensors(batch: dict, device=None) -> dict:
    """numpy batch -> tensors on `device` (the CPU when None)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class PrefetchIterator:
    """Background-thread prefetch with a checkpointable position. The
    worker thread only draws numpy batches; `put_fn` (default: CPU
    tensors) runs in `__next__`, on the caller's thread, so a device
    copy is never issued from the worker."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 prefetch: int = 2, put_fn=None):
        self.source = source
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._put = put_fn or to_tensors
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            b = self.source.batch_at(self._next_to_produce)
            try:
                self._q.put((self._next_to_produce, b), timeout=0.5)
                self._next_to_produce += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while True:
            step, b = self._q.get()
            if step == self.step:  # discard stale prefetches after restore
                self.step += 1
                return self._put(b)
            if step > self.step:
                # the thread is ahead of a restored position; restart it
                self._restart()

    def _restart(self):
        self._stop.set()
        self._thread.join(timeout=2)
        while not self._q.empty():
            self._q.get_nowait()
        self._stop = threading.Event()
        self._next_to_produce = self.step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- checkpoint interface --
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.source.seed}

    def load_state_dict(self, state: dict) -> None:
        if state["seed"] != self.source.seed:
            raise ValueError("data seed mismatch")
        self.step = int(state["step"])
        self._restart()

    def close(self):
        self._stop.set()
