"""Host-side LM data pipeline (a copy of the JAX package's ``train/data.py``, numpy
only) with the paper's pipeline modes applied.

The A³GNN insight that transfers to the LM stack (DESIGN.md
§Arch-applicability): the host data path (sample → batch-generate) and the
device step can be scheduled sequentially or overlapped with n workers —
same throughput/memory trade as §III-B.  ``PrefetchLoader`` implements
mode-1 style overlap (bounded queue = device double buffer); ``workers=0``
degrades to the sequential mode.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticTokens:
    """Deterministic synthetic LM batches (zipfian token distribution)."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 n_batches: int = 1_000_000):
        self.vocab, self.batch, self.seq = vocab_size, batch, seq
        self.seed = seed
        self.n_batches = n_batches
        ranks = np.arange(1, min(vocab_size, 65536) + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()
        self.support = len(ranks)

    def __len__(self):
        return self.n_batches

    def make(self, i: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + i)
        toks = rng.choice(self.support, size=(self.batch, self.seq + 1),
                          p=self.p).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self):
        for i in range(self.n_batches):
            yield self.make(i)


class PrefetchLoader:
    """n-worker prefetch with a bounded queue (parallel mode 1 for tokens)."""

    def __init__(self, dataset, workers: int = 2, depth: int = 4):
        self.ds = dataset
        self.workers = workers
        self.depth = depth

    def __iter__(self) -> Iterator[dict]:
        if self.workers <= 0:
            yield from self.ds
            return
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        n = len(self.ds)

        def worker(wid):
            for i in range(wid, n, self.workers):
                q.put((i, self.ds.make(i)))
            q.put((None, None))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        finished = 0
        buf = {}
        want = 0
        while finished < self.workers:
            i, b = q.get()
            if i is None:
                finished += 1
                continue
            buf[i] = b
            while want in buf:                 # restore deterministic order
                yield buf.pop(want)
                want += 1
        while want in buf:
            yield buf.pop(want)
            want += 1


def to_device(batch: dict, device) -> dict:
    """A host batch's arrays as tensors on ``device``."""
    import torch
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
