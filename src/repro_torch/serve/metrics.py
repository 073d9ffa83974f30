"""Serving metrics: rolling latency percentiles, queue depth, batch
occupancy, throughput, per-phase latency breakdown, and the store's
dispatch counters — all backed by one typed metric registry (the PyTorch
port's copy of ``repro.serve.metrics``; it has no device code, so the
copy differs only in the registry it imports).

The scheduler feeds every event in here (`on_submit` / `on_reject` /
`on_batch` / `on_complete` / `on_phases`); nothing in this module touches
the event loop or the device, so the same accounting runs inside tests
and on the card.  `summary()` is the JSON schema DESIGN.md §8 documents,
and its shape is frozen: the same sections and keys as the reference's
(tests/test_torch_serve.py pins it).

Every counter and gauge attribute resolves to a typed instrument in
``self.registry`` (repro_torch.obs.registry): ``m.submitted`` and
``m.retries += 1`` read/write the registry cells directly, so the JSON
summary and the OpenMetrics text exposition (``m.expose()``) can never
drift — they are two views of the same storage.  The per-phase breakdown
(queue-wait / pad / dispatch-wall / post, from the scheduler's span
timings) is reported by ``phase_summary()``.

Latency percentiles are computed over a bounded rolling window (default
8192 most-recent samples) so a long-running server's summary reflects
recent behaviour, not its whole lifetime; counters are lifetime.
``reset_window()`` restarts the window clock and rolling samples (after
warmup, say) without touching the lifetime counters.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.obs.registry import DEFAULT_TIME_BUCKETS_S, MetricRegistry


def percentiles(samples, points=(50.0, 99.0)) -> Dict[str, Optional[float]]:
    """``{"p50": ..., "p99": ...}`` over ``samples`` (None when empty).

    Shared with ``launch/serve.py``'s per-request token-serving summary —
    one definition of "p99" across both serving front-ends.
    """
    out: Dict[str, Optional[float]] = {}
    arr = np.asarray(list(samples), dtype=np.float64)
    for p in points:
        key = f"p{p:g}"
        out[key] = float(np.percentile(arr, p)) if arr.size else None
    return out


class RollingWindow:
    """Bounded sample window with percentile queries.

    ``hist`` (optional) is a registry Histogram every sample is also
    observed into — the window answers "recent p99", the histogram keeps
    the lossless lifetime distribution for the exposition.  Percentile
    callers on a hot path should ``snapshot()`` ONCE and compute from the
    array; the per-call ``percentile()``/``mean()`` remain for
    compatibility and one-off reads.
    """

    def __init__(self, maxlen: int = 8192, hist=None):
        self._samples: collections.deque = collections.deque(maxlen=maxlen)
        self.count = 0          # lifetime observations (window is bounded)
        self.hist = hist

    def record(self, value: float) -> None:
        v = float(value)
        self._samples.append(v)
        self.count += 1
        if self.hist is not None:
            self.hist.observe(v)

    def snapshot(self) -> np.ndarray:
        """Materialize the window once; compute every statistic from it."""
        return np.asarray(self._samples, dtype=np.float64)

    def reset(self) -> None:
        """Drop the window samples (lifetime ``count`` and the histogram
        keep accumulating — they are lifetime by contract)."""
        self._samples.clear()

    def percentile(self, p: float) -> Optional[float]:
        if not self._samples:
            return None
        return float(np.percentile(np.asarray(self._samples), p))

    def mean(self) -> Optional[float]:
        if not self._samples:
            return None
        return float(np.mean(np.asarray(self._samples)))


def _pct(arr: np.ndarray, p: float) -> Optional[float]:
    return float(np.percentile(arr, p)) if arr.size else None


def _mean(arr: np.ndarray) -> Optional[float]:
    return float(np.mean(arr)) if arr.size else None


_OCCUPANCY_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))


class ServeMetrics:
    """Scheduler-lifetime accounting (see module docstring for scope).

    Counter/gauge attributes are registry-backed: the class-level tables
    below map each attribute to its instrument name, ``__getattr__`` /
    ``__setattr__`` route reads and writes through the instrument, and
    the instrument is registered in ``self.registry`` — the single
    backing for the JSON summary AND the text exposition.
    """

    # attribute → (instrument name, help)
    _COUNTERS = {
        "submitted": ("serve_requests_submitted", "requests admitted"),
        "completed": ("serve_requests_completed", "requests resolved"),
        "rejected": ("serve_requests_rejected", "admission-control bounces"),
        "failed": ("serve_requests_failed", "retries exhausted, future errored"),
        "deadline_misses": ("serve_deadline_misses",
                            "delivered after their deadline"),
        "batches": ("serve_batches", "dispatched batches"),
        "batch_rows": ("serve_batch_rows", "live rows over all batches"),
        "retries": ("serve_batch_retries", "batch dispatch retries"),
        "timeouts": ("serve_batch_timeouts", "batch watchdog firings"),
        "degraded": ("serve_degraded_requests",
                     "requests answered with shards missing"),
        "shard_losses": ("serve_shard_losses", "ShardLostError observations"),
        "recoveries": ("serve_recoveries", "shard recoveries completed"),
        "recovery_s": ("serve_recovery_seconds",
                       "total wall time spent recovering"),
        "replica_failovers": ("serve_replica_failovers",
                              "dispatches served by a backup replica"),
        "resyncs": ("serve_resyncs", "replica anti-entropy passes completed"),
        "resync_s": ("serve_resync_seconds",
                     "total wall time spent resyncing"),
        "device_dispatches": ("serve_store_device_dispatches",
                              "summed store dispatches of every batch query"),
        "host_syncs": ("serve_store_host_syncs",
                       "summed store host syncs of every batch query"),
        "query_index_builds": ("serve_store_query_index_builds",
                               "MUST stay 0: build-once is the contract"),
    }
    _GAUGES = {
        "queue_depth": ("serve_queue_depth",
                        "rows currently queued (scheduler-owned)"),
        "queue_depth_peak": ("serve_queue_depth_peak", "peak queued rows"),
        "inflight": ("serve_inflight",
                     "requests admitted but not completed"),
        "inflight_peak": ("serve_inflight_peak", "peak inflight requests"),
        "ewma_batch_s": ("serve_batch_ewma_seconds",
                         "dispatch wall-time EWMA (deadline pressure)"),
    }

    def __init__(self, r_block: int = 0,
                 registry: Optional[MetricRegistry] = None):
        # _inst must exist before any delegated __setattr__ fires
        object.__setattr__(self, "_inst", {})
        reg = registry or MetricRegistry()
        self.registry = reg
        for attr, (name, hlp) in self._COUNTERS.items():
            self._inst[attr] = reg.counter(name, hlp)
        for attr, (name, hlp) in self._GAUGES.items():
            self._inst[attr] = reg.gauge(name, hlp)

        self.r_block = r_block           # batch geometry (occupancy denom)
        self.ewma_alpha = 0.25
        self.latency = RollingWindow(hist=reg.histogram(
            "serve_latency_seconds", "submit -> result latency"))
        self.batch_wall = RollingWindow(hist=reg.histogram(
            "serve_batch_wall_seconds", "per-batch dispatch wall"))
        self.occupancy = RollingWindow(hist=reg.histogram(
            "serve_batch_occupancy", "live rows / r_block per batch",
            buckets=_OCCUPANCY_BUCKETS))
        # per-phase latency breakdown (the scheduler's span timings):
        # queue-wait (submit -> batch assembly), pad (coalesce + pad),
        # dispatch (executor store.query wall incl. retries), post
        # (metrics + de-interleave + future delivery)
        self.queue_wait = RollingWindow(hist=reg.histogram(
            "serve_phase_queue_wait_seconds", "submit -> batch assembly"))
        self.pad = RollingWindow(hist=reg.histogram(
            "serve_phase_pad_seconds", "batch coalesce + pad"))
        self.dispatch_wall = RollingWindow(hist=reg.histogram(
            "serve_phase_dispatch_seconds", "store dispatch wall"))
        self.post = RollingWindow(hist=reg.histogram(
            "serve_phase_post_seconds", "de-interleave + delivery"))
        self.replica_dispatches: Dict[int, int] = {}  # replica → dispatches
        self._t0 = time.monotonic()
        # window bases: reset_window() rebases throughput on these so
        # queries_per_s measures the window, lifetime counters keep running
        self._completed0 = 0
        self._rows0 = 0

    # -- registry delegation -------------------------------------------------

    def __getattr__(self, name):
        # only called when normal lookup misses — i.e. backed attributes
        inst = object.__getattribute__(self, "__dict__").get("_inst", {}).get(name)
        if inst is not None:
            return inst.value
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}")

    def __setattr__(self, name, value):
        inst = self.__dict__.get("_inst", {}).get(name)
        if inst is not None:
            inst.set(value)
        else:
            object.__setattr__(self, name, value)

    def expose(self) -> str:
        """OpenMetrics-style text exposition of the backing registry."""
        return self.registry.expose()

    # -- scheduler hooks -----------------------------------------------------

    def on_submit(self, rows: int) -> None:
        self.submitted += 1
        self.inflight += 1
        self.inflight_peak = max(self.inflight_peak, self.inflight)
        self.queue_depth += rows
        self.queue_depth_peak = max(self.queue_depth_peak, self.queue_depth)

    def on_reject(self) -> None:
        self.rejected += 1

    def on_batch_start(self, rows: int) -> None:
        self.queue_depth -= rows

    def on_batch(self, rows: int, wall_s: float, stats=None) -> None:
        self.batches += 1
        self.batch_rows += rows
        self.batch_wall.record(wall_s)
        if self.r_block:
            self.occupancy.record(rows / self.r_block)
        if self.ewma_batch_s == 0.0:
            self.ewma_batch_s = wall_s
        else:
            a = self.ewma_alpha
            self.ewma_batch_s = (1 - a) * self.ewma_batch_s + a * wall_s
        if stats is not None:
            self.device_dispatches += stats.device_dispatches
            self.host_syncs += stats.host_syncs

    def on_phases(self, queue_wait_s, pad_s: float, dispatch_s: float,
                  post_s: float) -> None:
        """One batch's phase timings; ``queue_wait_s`` is per-request
        (a batch coalesces many), the rest are per-batch."""
        for w in queue_wait_s:
            self.queue_wait.record(w)
        self.pad.record(pad_s)
        self.dispatch_wall.record(dispatch_s)
        self.post.record(post_s)

    def on_complete(self, latency_s: float, missed_deadline: bool = False) -> None:
        self.completed += 1
        self.inflight -= 1
        self.latency.record(latency_s)
        if missed_deadline:
            self.deadline_misses += 1

    def on_fail(self, n_requests: int) -> None:
        self.failed += n_requests
        self.inflight -= n_requests

    def on_degraded(self, n_requests: int) -> None:
        """Requests delivered from a partial fan-out (shards missing)."""
        self.degraded += n_requests

    def on_shard_lost(self) -> None:
        self.shard_losses += 1

    def on_recovery(self, wall_s: float) -> None:
        self.recoveries += 1
        self.recovery_s += wall_s

    def on_routing(self, failovers: int, dispatches: Dict[int, int]) -> None:
        """One batch's replica-routing delta (replicated stores report
        which replicas served it and whether failover kicked in)."""
        self.replica_failovers += failovers
        for r, n in dispatches.items():
            self.replica_dispatches[r] = self.replica_dispatches.get(r, 0) + n

    def on_resync(self, wall_s: float) -> None:
        self.resyncs += 1
        self.resync_s += wall_s

    # -- windowing -----------------------------------------------------------

    def reset_window(self) -> None:
        """Restart the measurement window: zero the window clock, drop the
        rolling samples, and rebase gauge peaks — keep every lifetime
        counter (and the registry histograms) running.  Call it after a
        warmup so ``queries_per_s``/``elapsed_s`` measure the timed
        interval, not scheduler lifetime."""
        self._t0 = time.monotonic()
        self._completed0 = self.completed
        self._rows0 = self.batch_rows
        for w in (self.latency, self.batch_wall, self.occupancy,
                  self.queue_wait, self.pad, self.dispatch_wall, self.post):
            w.reset()
        self.queue_depth_peak = self.queue_depth
        self.inflight_peak = self.inflight

    # -- reporting -----------------------------------------------------------

    @property
    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    @property
    def queries_per_s(self) -> float:
        return (self.completed - self._completed0) / max(self.elapsed_s, 1e-9)

    def summary(self) -> dict:
        """The DESIGN.md §8 metrics schema (JSON-able).  Frozen shape —
        the per-phase breakdown lives in :meth:`phase_summary`, the text
        exposition in :meth:`expose`."""
        lat_arr = self.latency.snapshot()      # ONE materialization
        lat = {
            "p50_ms": _ms(_pct(lat_arr, 50)),
            "p99_ms": _ms(_pct(lat_arr, 99)),
            "mean_ms": _ms(_mean(lat_arr)),
        }
        return {
            "requests": {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "deadline_misses": self.deadline_misses,
                "inflight_peak": self.inflight_peak,
            },
            "latency": lat,
            "throughput": {
                "queries_per_s": round(self.queries_per_s, 2),
                "rows_per_s": round(
                    (self.batch_rows - self._rows0) / max(self.elapsed_s, 1e-9), 2
                ),
                "elapsed_s": round(self.elapsed_s, 4),
            },
            "batches": {
                "count": self.batches,
                "mean_occupancy": _r4(_mean(self.occupancy.snapshot())),
                "mean_wall_ms": _ms(_mean(self.batch_wall.snapshot())),
                "retries": self.retries,
                "timeouts": self.timeouts,
            },
            "queue": {
                "depth": self.queue_depth,
                "depth_peak": self.queue_depth_peak,
            },
            "faults": self.faults(),
            "dispatch": {
                "device_dispatches": self.device_dispatches,
                "host_syncs": self.host_syncs,
                "query_index_builds": self.query_index_builds,
            },
        }

    def faults(self) -> dict:
        """The ``summary()["faults"]`` section — THE fault-counter schema
        both serving front-ends print (``launch/serve.py`` sources its
        JSON from here too, so the shapes cannot drift)."""
        return {
            "timeouts": self.timeouts,
            "retries": self.retries,
            "rejected": self.rejected,
            "failed": self.failed,
            "degraded": self.degraded,
            "shard_losses": self.shard_losses,
            "recoveries": self.recoveries,
            "recovery_s": round(float(self.recovery_s), 4),
            "replica_failovers": self.replica_failovers,
            "resyncs": self.resyncs,
            "resync_s": round(float(self.resync_s), 4),
            "replica_dispatches": {
                str(r): n
                for r, n in sorted(self.replica_dispatches.items())
            },
        }

    def phase_summary(self) -> dict:
        """Per-phase latency breakdown over the current window: where a
        request's submit→result time went (queue-wait and the batch's
        pad/dispatch/post phases)."""
        out = {}
        for name, w in (("queue_wait", self.queue_wait), ("pad", self.pad),
                        ("dispatch", self.dispatch_wall), ("post", self.post)):
            arr = w.snapshot()
            out[name] = {
                "p50_ms": _ms(_pct(arr, 50)),
                "p99_ms": _ms(_pct(arr, 99)),
                "mean_ms": _ms(_mean(arr)),
                "count": w.count,
            }
        return out


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 3)


def _r4(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 4)


# re-exported for histogram-bucket callers (serve_load's phase record)
TIME_BUCKETS_S = DEFAULT_TIME_BUCKETS_S
