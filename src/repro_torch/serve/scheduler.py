"""Continuous-batching scheduler over the paged KV pool.

Requests wait in a FIFO queue and join the running batch between decode
steps when a row AND store capacity exist (head-of-line: a big request is
never starved by smaller ones jumping the queue). A running row that
needs a new page when even augmentation cannot free room costs the
youngest-admitted row its place: that row's storage returns to the pool
and its request re-enters the queue front with prompt := prompt +
generated-so-far (greedy recompute on resume: work is lost, tokens are
not). The refresh pass drains expired Augmented pages each step.

Ported from `repro.serve.scheduler` without observability hooks and the
fault pass.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class QueueEntry:
    """A queued (or re-queued) generation request."""
    req: object                  # serve.engine.Request
    prompt: np.ndarray           # on resume: original prompt + generated
    remaining: int               # generation budget left
    base_prompt: np.ndarray = None   # the ORIGINAL prompt
    enqueue_step: int = 0

    def __post_init__(self):
        if self.base_prompt is None:
            self.base_prompt = self.prompt


class Scheduler:
    def __init__(self, store, *, max_batch: int):
        self.store = store
        self.max_batch = max_batch
        self.queue: deque[QueueEntry] = deque()
        self._admit_ticket = 0
        # per-row admission ticket: the LIFO victim order for preemption
        self.row_ticket = np.full(max_batch, -1, np.int64)
        self.stats = {
            "enqueued": 0, "requeues": 0, "admitted": 0, "preemptions": 0,
            "refresh_passes": 0, "peak_queue_depth": 0,
            "peak_concurrency": 0, "queue_wait_steps": 0,
        }

    def enqueue(self, entry: QueueEntry, *, front: bool = False) -> None:
        """`front` re-queues (preemption resume / admission race)."""
        (self.queue.appendleft if front else self.queue.append)(entry)
        self.stats["requeues" if front else "enqueued"] += 1
        self.stats["peak_queue_depth"] = max(self.stats["peak_queue_depth"],
                                             len(self.queue))

    def pop_admittable(self, step: int) -> Optional[QueueEntry]:
        """The queue head if the store could hold it right now."""
        if not self.queue or not self.store.can_admit_tokens(
                max(len(self.queue[0].prompt), 1)):
            return None
        entry = self.queue.popleft()
        self.stats["queue_wait_steps"] += step - entry.enqueue_step
        return entry

    def admit(self, row: int, n_tokens: int, step: int) -> bool:
        """Reserve the row's pages; all-or-nothing."""
        if not self.store.admit_row(row, n_tokens, step):
            return False
        self._admit_ticket += 1
        self.row_ticket[row] = self._admit_ticket
        self.stats["admitted"] += 1
        self.stats["peak_concurrency"] = max(
            self.stats["peak_concurrency"], int((self.row_ticket >= 0).sum()))
        return True

    def ensure_position(self, row: int, pos: int, step: int) -> bool:
        return self.store.ensure_position(row, pos, step)

    def ensure_window(self, row: int, start: int, count: int,
                      step: int) -> bool:
        """`ensure_position` over a speculative window: storage for every
        position in [start, start + count) must exist before the draft
        pass writes it. Idempotent: the engine's preemption loop retries
        the whole window after evicting a victim."""
        for pos in range(start, start + count):
            if not self.store.ensure_position(row, pos, step):
                return False
        return True

    def release_row(self, row: int) -> None:
        self.store.release_row(row)
        self.row_ticket[row] = -1

    def preemption_victim(self, protect: int,
                          active: np.ndarray) -> Optional[int]:
        """Youngest-admitted active row other than `protect`."""
        tickets = np.where(active, self.row_ticket, -1)
        tickets[protect] = -1
        victim = int(tickets.argmax())
        return victim if tickets[victim] >= 0 else None

    def refresh_pass(self, step: int) -> int:
        """Refresh every expired Augmented page. Returns pages refreshed."""
        due = self.store.refresh_due(step)
        for key in due:
            self.store.refresh(key, step)
        if due:
            self.stats["refresh_passes"] += 1
        return len(due)

    def describe(self) -> dict:
        return {"queue_depth": len(self.queue), **self.stats}
