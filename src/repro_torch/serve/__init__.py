"""Continuous-batching serving front-end for the port's KNN store
(DESIGN.md §8).

  KNNScheduler — async request coalescing: concurrent ``submit(rows, k,
                 deadline)`` calls pack into batches of up to r_block rows
                 (micro-batch window / block-full / deadline-pressure
                 flush), dispatch through ONE store query per batch on one
                 worker thread, and de-interleave per-request results.
  ServeConfig  — flush window, admission high-water mark, batch watchdog
                 + retry policy, batch geometry, shard-loss policy.
  ServeMetrics — rolling p50/p99 latency, queue depth, batch occupancy,
                 queries/sec, store dispatch counters.
  ServeResult  — the ``(ids, scores)`` pair ``submit`` resolves to,
                 carrying ``missing_shards`` when served degraded.
  QueueFull    — admission-control bounce carrying ``retry_after_s``.
"""
from repro_torch.serve.metrics import RollingWindow, ServeMetrics, percentiles
from repro_torch.serve.scheduler import (
    KNNScheduler,
    QueueFull,
    ServeConfig,
    ServeResult,
)

__all__ = [
    "KNNScheduler",
    "QueueFull",
    "RollingWindow",
    "ServeConfig",
    "ServeResult",
    "ServeMetrics",
    "percentiles",
]
