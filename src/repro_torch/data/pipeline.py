"""Deterministic, shardable data pipeline: the port's copy of the JAX
package's ``data/pipeline.py``.  It is numpy only, so the batches are the
reference's byte for byte; the trainer moves them to its device.

Real deployments stream tokenized shards from blob storage; here the
source is a seeded synthetic LM stream (plus the sparse-spectra generators
in ``repro_torch.sparse.datagen`` for join jobs).  The properties that matter
for the framework are preserved:

* **Determinism & restartability** — batch ``i`` is a pure function of
  (seed, i).  Resuming from step N replays exactly batch N; no state
  beyond the step counter needs checkpointing.
* **Shardability** — each host materializes only its slice of the global
  batch (rows ``[lo, hi)``).
* **Prefetch/double-buffering** — a background thread keeps ``depth``
  batches ready so a slow input host never stalls the step (straggler
  mitigation lever #1; see runtime/fault.py).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def make_lm_batch(
    seed: int, step: int, global_batch: int, seq_len: int, vocab_size: int,
    lo: int = 0, hi: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Batch ``step`` of the synthetic LM stream; rows [lo, hi) of the batch.

    Tokens follow a Zipf-ish distribution (more realistic logit/loss shapes
    than uniform); labels are next-token shifted with -1 padding at the end.
    """
    hi = global_batch if hi is None else hi
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # zipf over the vocab, clipped; row slice is reproducible because we
    # generate the full batch shape lazily per-row from row-keyed streams
    rows = []
    for r in range(lo, hi):
        rr = np.random.default_rng(np.random.SeedSequence([seed, step, r]))
        z = rr.zipf(1.3, size=seq_len + 1)
        rows.append(np.minimum(z - 1, vocab_size - 1).astype(np.int32))
    arr = np.stack(rows)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:].copy()}


class TokenPipeline:
    """Prefetching iterator over the synthetic stream (host-local slice)."""

    def __init__(
        self,
        seed: int,
        global_batch: int,
        seq_len: int,
        vocab_size: int,
        start_step: int = 0,
        lo: int = 0,
        hi: Optional[int] = None,
        depth: int = 2,
    ):
        self.seed = seed
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.lo, self.hi = lo, (global_batch if hi is None else hi)
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = make_lm_batch(
                self.seed, step, self.global_batch, self.seq_len,
                self.vocab_size, self.lo, self.hi,
            )
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
