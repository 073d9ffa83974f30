"""Continuous-batching query scheduler over :class:`ShardedKNNStore` (the
PyTorch port's counterpart of ``repro.serve.scheduler``).

The store (DESIGN.md §7) answers one R block per fan-out dispatch (every
shard's walk and the tree merge, on the card), but real traffic is
millions of users each submitting a *few* sparse rows — at batch size 1
the paper's block-geometry wins (C2/C3 cost model) are wasted.  This is
the LLM-serving continuous-batching pattern (the reference's
``launch/serve.py`` token server, transplanted to the query side):

* ``submit(rows, k, deadline)`` — an awaitable that admits a request
  into a bounded queue and resolves to its ``(ids, scores)`` once a
  batch containing it completes.  Admission control: past
  ``queue_rows_hwm`` queued rows the scheduler rejects with
  :class:`QueueFull` carrying a ``retry_after_s`` estimate
  (reject-early beats queue-forever — the open-loop bench shows the
  latency cliff this prevents).

* **Coalescing** — queued requests are packed FIFO into one
  :class:`SparseBatch` of at most ``r_block`` rows (whole requests only;
  rows of one request are never split across batches).  The batch holds
  exactly its requests' rows, with no pad rows; its feature width is
  padded to a bucket with sentinel entries.  (The JAX package pads the
  rows to exactly ``r_block``, which keeps XLA to one compiled shape;
  eager PyTorch and cuBLAS compile nothing per shape, and a request of a
  few rows would otherwise pay a whole ``r_block``'s products.)  The
  batch is built on the HOST (CPU tensors): the store pulls R to the
  host at query time anyway, and the event-loop thread never touches the
  device.  Batching never changes which rows answer: rows are
  independent in every algorithm, and IIIB's batch-global MinPruneScore
  only moves *work*, not answers (Theorem 1 masks provably-safe entries
  only).  The LAST BIT of a score can
  change: a product of another shape may take another matmul kernel (on
  the CPU and on cuBLAS alike), so a request's answer is bit for bit a
  direct query of the same assembled batch, and equal within float32
  rounding to a direct query of the request's rows alone.

* **Flush policy** — a batch is dispatched when the first of these
  fires: (1) *block-full*: queued rows ≥ ``r_block``; (2) *window
  expiry*: the oldest queued request has waited ``window_s``;
  (3) *deadline pressure*: the nearest request deadline minus the
  EWMA batch service time (minus ``slack_s``) has arrived.

* **Dispatch** — one ``store.query()`` per batch, on a single-thread
  executor so the event loop (and therefore ``submit()``) never blocks
  on device work: the flush path takes requests off the queue and
  returns; the queue is open for new submissions while the batch is in
  flight (tests assert this).  Each dispatch is wrapped in
  ``runtime.fault.with_timeout`` and retried per
  ``runtime.fault.RetryPolicy`` (jittered backoff); exhausted retries
  fail only that batch's futures.

* **De-interleaving** — request i owns rows ``[off_i, off_i + n_i)`` of
  the batch; its ids/scores slice out with its own ``k`` (any
  ``k ≤ store.spec.k`` — top-k prefixes of a longer top-k are exact).
  Global store ids pass through untouched (host numpy arrays).

* **Mutations** — ``mutate(fn, *args)`` runs a store mutation
  (``add``/``delete``/``expire``/``compact``) on the same single-thread
  executor, serialized with batch dispatches: the store never sees a
  query and a stack swap concurrently.  That one worker is also the only
  thread that runs device work (queries, mutations, recovery, resync).

* **Watchdog** — ``batch_timeout_s`` runs the call on a watchdog thread
  (``runtime.fault.with_timeout``); on CUDA an abandoned call keeps
  running to its end, so a timeout bounds the caller's latency, not the
  card's work.

Everything observable lands in :class:`~repro_torch.serve.metrics.ServeMetrics`
(rolling p50/p99, queue depth, batch occupancy, queries/sec, the store's
dispatch counters); ``summary()`` has the reference's schema.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import time
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.recorder import FlightRecorder, get_recorder
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.fault import RetryPolicy, ShardLostError, with_timeout
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.sparse.format import SparseBatch, from_arrays


class QueueFull(RuntimeError):
    """Admission control bounce; retry after ``retry_after_s`` seconds."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"serve queue over high-water mark; "
                         f"retry after {retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s


class ServeResult(tuple):
    """``(ids, scores)`` — unpacks exactly like the plain tuple ``submit``
    has always resolved to — plus degraded-mode metadata: ``missing_shards``
    names the store shards absent from this answer (empty for a full
    fan-out; see DESIGN.md §9)."""

    missing_shards: Tuple[int, ...]

    def __new__(cls, ids, scores, missing_shards: Tuple[int, ...] = ()):
        self = super().__new__(cls, (ids, scores))
        self.missing_shards = tuple(missing_shards)
        return self

    @property
    def degraded(self) -> bool:
        return bool(self.missing_shards)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler knobs (DESIGN.md §8 documents the policy they drive).

    ``r_block``     — the most rows a batch holds (a batch holds just its
                      requests' rows); queued rows ≥ ``r_block`` flush a
                      batch at once.  Defaults to the store's resolved
                      plan.
    ``window_s``    — micro-batch window: max time the oldest request
                      waits before a partial batch flushes.
    ``queue_rows_hwm`` — admission high-water mark in queued ROWS
                      (requests are variable-sized; rows are the unit the
                      device cost scales with).  Default 64 × r_block.
    ``slack_s``     — safety margin subtracted when converting a request
                      deadline into a flush time.
    ``batch_timeout_s`` — per-dispatch watchdog (None = no watchdog).
    ``retry``       — RetryPolicy for failed/timed-out batch dispatches.
    ``feature_bucket`` — batch feature width is bucketed up to a multiple
                      of this so few batch shapes occur (8 keeps the
                      variant count tiny without much pad waste).
    ``allow_partial`` — shard-loss policy (sharded stores only): serve
                      DEGRADED results immediately (flagged with the
                      missing shard set) while recovery runs in the
                      background, instead of queueing behind it.
    ``recover``     — zero-arg callable that rebuilds lost shards (e.g.
                      ``lambda: store.recover(ckpt_dir)``).  With
                      ``allow_partial`` it runs in the background; without
                      it, batches that hit a lost shard await it and then
                      re-dispatch for FULL results (queued-behind-recovery).
    ``resync``      — zero-arg callable that repairs diverged replicas
                      (e.g. ``lambda: store.resync_replicas()``).  Kicked
                      in the background whenever a completed batch leaves
                      ``store.needs_resync`` true — replica failover keeps
                      serving FULL results meanwhile, so unlike ``recover``
                      nothing ever queues behind it.
    """

    r_block: Optional[int] = None
    window_s: float = 0.002
    queue_rows_hwm: Optional[int] = None
    slack_s: float = 0.0
    batch_timeout_s: Optional[float] = None
    retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(max_retries=2, backoff_s=0.01,
                                            backoff_mult=2.0, jitter=0.25)
    )
    feature_bucket: int = 8
    allow_partial: bool = False
    recover: Optional[Callable[[], Any]] = None
    resync: Optional[Callable[[], Any]] = None


@dataclasses.dataclass
class _Pending:
    rid: int
    idx: np.ndarray            # (n, f) int32, sentinel-padded
    val: np.ndarray            # (n, f) f32
    nnz: np.ndarray            # (n,) int32
    k: int
    t_submit: float
    t_deadline: Optional[float]          # absolute monotonic, or None
    accuracy: Optional[str]              # per-request override, or None (store default)
    future: asyncio.Future
    span: Any = None                     # request-root trace span (or None)


def _bucket_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


class KNNScheduler:
    """Async continuous-batching front-end for a (sharded) KNN store.

    ``store`` needs ``dim``, ``spec.k``, ``query(SparseBatch) ->
    JoinResult`` and (optionally) ``stats.index_builds`` — i.e. a
    :class:`~repro_torch.store.ShardedKNNStore` or a
    :class:`~repro_torch.core.engine.SparseKNNIndex`.

    Use as an async context manager, or call ``start()`` / ``stop()``::

        async with KNNScheduler(store, ServeConfig(r_block=64)) as sched:
            ids, scores = await sched.submit(rows, k=5)
    """

    def __init__(self, store, config: Optional[ServeConfig] = None,
                 metrics: Optional[ServeMetrics] = None,
                 tracer: Optional[Tracer] = None,
                 recorder: Optional[FlightRecorder] = None,
                 profile=None):
        self.store = store
        cfg = config or ServeConfig()
        if cfg.r_block is None:
            rb = getattr(store.spec, "r_block", None)
            if rb is None and hasattr(store, "plan_for"):
                f_mean = float(getattr(store, "_f_mean", 16.0))
                rb = store.plan_for((256, f_mean, store.dim)).r_block
            cfg = dataclasses.replace(cfg, r_block=int(rb or 64))
        if cfg.queue_rows_hwm is None:
            cfg = dataclasses.replace(cfg, queue_rows_hwm=64 * cfg.r_block)
        self.config = cfg
        self.r_block = cfg.r_block
        self.k_max = int(store.spec.k)
        self.dim = int(store.dim)
        self.metrics = metrics or ServeMetrics(r_block=self.r_block)
        self.metrics.r_block = self.r_block
        # one timeline across scheduler -> store -> engine: spans and fault
        # events land in the (shared, by default) flight recorder; `profile`
        # is an optional obs.profile.ProfileCapture armed around the next N
        # batches
        self.recorder = recorder or get_recorder()
        self.tracer = tracer or Tracer(recorder=self.recorder)
        self.profile = profile

        self._pending: Deque[_Pending] = collections.deque()
        self._queued_rows = 0
        self._next_rid = 0
        self._running = False
        self._event: Optional[asyncio.Event] = None
        self._flusher: Optional[asyncio.Task] = None
        self._dispatches: set = set()
        self._exec: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._recovering: Optional[asyncio.Task] = None
        self._resyncing: Optional[asyncio.Task] = None
        self._seen_lost: set = set()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "KNNScheduler":
        if self._running:
            return self
        self._running = True
        self._event = asyncio.Event()
        # ONE worker: batch dispatches and store mutations serialize here,
        # so the store never races a query against a stack swap (and only
        # this thread touches the device)
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="knn-serve-dispatch"
        )
        self._flusher = asyncio.create_task(self._flush_loop())
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop the scheduler; ``drain=True`` flushes and completes every
        queued request first, ``drain=False`` fails them."""
        if not self._running:
            return
        self._running = False
        if not drain:
            for req in self._pending:
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError("scheduler stopped without drain"))
                self.tracer.end(req.span, error="scheduler_stopped")
            self.metrics.on_fail(len(self._pending))
            self.metrics.queue_depth -= self._queued_rows
            self._pending.clear()
            self._queued_rows = 0
        self._event.set()
        await self._flusher
        while self._dispatches:
            await asyncio.gather(*tuple(self._dispatches))
        self._exec.shutdown(wait=True)
        if self.profile is not None:
            self.profile.stop()

    async def __aenter__(self) -> "KNNScheduler":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=True)

    # -- submission ----------------------------------------------------------

    async def submit(self, rows: SparseBatch, k: Optional[int] = None,
                     deadline: Optional[float] = None,
                     accuracy: Optional[str] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Admit one request; resolves to ``(ids, scores)`` of shape
        ``(n_rows, k)``.  ``deadline`` is a latency budget in seconds from
        now — it *pressures* the flush policy; a missed deadline is still
        delivered (and counted in ``metrics.deadline_misses``).

        ``accuracy`` is the per-request knob over an approx-built store:
        ``"approx"`` routes through the band-filtered fan-out, ``"exact"``
        through the byte-identical exact program, ``None`` takes the
        store's default.  Coalescing only packs same-accuracy requests
        into a batch (one store dispatch serves one accuracy).

        Raises :class:`QueueFull` past the high-water mark — the caller
        should back off ``retry_after_s`` and resubmit.
        """
        if not self._running:
            raise RuntimeError("scheduler is not running (use `async with`)")
        if rows.dim != self.dim:
            raise ValueError(f"dim mismatch: store has {self.dim}, got {rows.dim}")
        if accuracy not in (None, "exact", "approx"):
            raise ValueError(f"unknown accuracy {accuracy!r}")
        if accuracy == "approx" and getattr(self.store, "_lsh", None) is None:
            raise ValueError(
                "store was built without the LSH band tier; build with "
                "target_recall to serve approx requests")
        n = rows.num_vectors
        if n == 0:
            return ServeResult(np.empty((0, k or self.k_max), np.int32),
                               np.empty((0, k or self.k_max), np.float32))
        if n > self.r_block:
            raise ValueError(
                f"request has {n} rows > r_block={self.r_block}; pre-chunk it")
        k = self.k_max if k is None else int(k)
        if not 0 < k <= self.k_max:
            raise ValueError(f"k={k} not in (0, {self.k_max}] (store's k)")

        if self._queued_rows + n > self.config.queue_rows_hwm:
            self.metrics.on_reject()
            raise QueueFull(self._retry_after())

        now = time.monotonic()
        req = _Pending(
            rid=self._next_rid,     # host copies: the caller may reuse its tensors
            idx=rows.indices.cpu().numpy().astype(np.int32),
            val=rows.values.cpu().numpy().astype(np.float32),
            nnz=rows.nnz.cpu().numpy().astype(np.int32),
            k=k, t_submit=now,
            t_deadline=None if deadline is None else now + float(deadline),
            accuracy=accuracy,
            future=asyncio.get_running_loop().create_future(),
            span=self.tracer.begin("request", parent=None,
                                   rid=self._next_rid, rows=n),
        )
        self._next_rid += 1
        self._pending.append(req)
        self._queued_rows += n
        self.metrics.on_submit(n)
        self._event.set()
        return await req.future

    async def mutate(self, fn: Callable, *args, **kwargs) -> Any:
        """Run a store mutation serialized with batch dispatches."""
        if not self._running:
            raise RuntimeError("scheduler is not running")
        loop = asyncio.get_running_loop()
        name = getattr(fn, "__name__", type(fn).__name__)

        def _run():
            with self.tracer.span("mutate", op=name):
                return fn(*args, **kwargs)

        return await loop.run_in_executor(self._exec, _run)

    def _retry_after(self) -> float:
        """Drain-time estimate for a rejected caller: queued batches ×
        the EWMA batch service time (floor: one window)."""
        batches_ahead = max(1, -(-self._queued_rows // self.r_block))
        est = self.metrics.ewma_batch_s or self.config.window_s
        return max(self.config.window_s, batches_ahead * est)

    # -- flush policy --------------------------------------------------------

    def _flush_at(self) -> float:
        """Absolute monotonic time the current partial batch must flush."""
        oldest = self._pending[0].t_submit + self.config.window_s
        t = oldest
        est = self.metrics.ewma_batch_s or 0.0
        for req in self._pending:
            if req.t_deadline is not None:
                t = min(t, req.t_deadline - est - self.config.slack_s)
        return t

    async def _flush_loop(self) -> None:
        while True:
            if not self._pending:
                if not self._running:
                    return
                self._event.clear()
                if self._pending or not self._running:
                    continue  # raced with a submit()/stop() before clear()
                await self._event.wait()
                continue
            if self._queued_rows >= self.r_block or not self._running:
                self._start_batch()
                continue
            timeout = self._flush_at() - time.monotonic()
            if timeout <= 0:
                self._start_batch()
                continue
            self._event.clear()
            try:
                await asyncio.wait_for(self._event.wait(), timeout)
            except (asyncio.TimeoutError, TimeoutError):
                pass

    def _start_batch(self) -> None:
        """Take whole requests FIFO up to ``r_block`` rows and hand them to
        the dispatch executor.  No await between taking and scheduling —
        and nothing here blocks on the device — so the queue is open for
        new ``submit()``s the moment this returns."""
        taken: List[_Pending] = []
        rows = 0
        while self._pending:
            n = len(self._pending[0].nnz)
            if taken and rows + n > self.r_block:
                break  # head-of-line request starts the next batch
            if taken and self._pending[0].accuracy != taken[0].accuracy:
                break  # one dispatch serves one accuracy — next batch
            req = self._pending.popleft()
            taken.append(req)
            rows += n
        self._queued_rows -= rows
        self.metrics.on_batch_start(rows)
        task = asyncio.create_task(self._dispatch(taken, rows))
        self._dispatches.add(task)
        task.add_done_callback(self._dispatches.discard)

    # -- dispatch ------------------------------------------------------------

    def _assemble(self, reqs: Sequence[_Pending]) -> SparseBatch:
        """Coalesce requests into ONE batch of their rows and a bucketed
        feature width, as CPU tensors (sentinel pad entries are
        result-inert — see module docstring)."""
        f = _bucket_up(max(r.idx.shape[1] for r in reqs), self.config.feature_bucket)
        rows = sum(len(r.nnz) for r in reqs)
        idx = np.full((rows, f), self.dim, np.int32)
        val = np.zeros((rows, f), np.float32)
        nnz = np.zeros(rows, np.int32)
        off = 0
        for r in reqs:
            n, fr = r.idx.shape
            idx[off:off + n, :fr] = r.idx
            val[off:off + n, :fr] = r.val
            nnz[off:off + n] = r.nnz
            off += n
        return from_arrays(idx, val, nnz, self.dim)

    def _query_once(self, batch: SparseBatch, accuracy: Optional[str] = None,
                    parent_span=None, wait_span=None):
        """Executor-side: one store dispatch under the batch watchdog.
        Returns (ids, scores, JoinStats, index_builds_delta, missing_shards,
        routing) as host data; ``routing`` is this dispatch's replica-level
        delta — failovers and per-replica dispatch counts — for stores that
        track them (empty otherwise).  ``parent_span`` is the batch span the
        event loop started: the attach+span happens INSIDE the closure so
        the context lands on whichever thread actually runs the query
        (``with_timeout`` moves it to a watchdog thread when armed).
        ``wait_span`` (``serve.worker_wait``) ends there too, as the query
        starts."""
        st = getattr(self.store, "stats", None)
        builds0 = getattr(st, "index_builds", 0)
        fail0 = getattr(st, "replica_failovers", 0)
        disp0 = dict(getattr(st, "replica_dispatches", ()) or {})
        kw = {}
        if self.config.allow_partial and hasattr(self.store, "lost_shards"):
            kw["allow_partial"] = True
        if accuracy is not None:
            kw["accuracy"] = accuracy

        def _call():
            self.tracer.end(wait_span)
            with self.tracer.attach(parent_span):
                with self.tracer.span("store.dispatch",
                                      rows=batch.num_vectors,
                                      accuracy=accuracy or "default"):
                    return self.store.query(batch, **kw)

        res = with_timeout(_call, self.config.batch_timeout_s)
        ids = res.ids.cpu().numpy()
        scores = res.scores.cpu().numpy()
        builds1 = getattr(st, "index_builds", 0)
        missing = tuple(getattr(res, "missing_shards", ()))
        disp1 = dict(getattr(st, "replica_dispatches", ()) or {})
        routing = {
            "failovers": getattr(st, "replica_failovers", 0) - fail0,
            "dispatches": {
                r: disp1[r] - disp0.get(r, 0)
                for r in disp1 if disp1[r] != disp0.get(r, 0)
            },
        }
        return ids, scores, res.stats, builds1 - builds0, missing, routing

    def _kick_recovery(self) -> Optional[asyncio.Task]:
        """Start (or return the in-flight) background recovery task.  It
        runs ``config.recover`` on the dispatch executor — serialized with
        batches and mutations, so the fan-out stacks never swap mid-query —
        and is tracked in ``_dispatches`` so ``stop()`` awaits it."""
        if self._recovering is not None:
            return self._recovering
        if self.config.recover is None:
            return None

        loop = asyncio.get_running_loop()

        def _recover():
            with self.tracer.span("recover"):
                return self.config.recover()

        async def _run():
            t0 = time.monotonic()
            try:
                await loop.run_in_executor(self._exec, _recover)
                wall = time.monotonic() - t0
                self.metrics.on_recovery(wall)
                self.recorder.record("recovery_done",
                                     wall_s=round(wall, 4))
                self._seen_lost.clear()   # a later loss is a new event
            except Exception:  # noqa: BLE001 — a failed recovery leaves the
                pass           # shard lost; the retry/fail path bounds callers
            finally:
                self._recovering = None

        task = asyncio.create_task(_run())
        self._recovering = task
        self._dispatches.add(task)
        task.add_done_callback(self._dispatches.discard)
        return task

    def _kick_resync(self) -> Optional[asyncio.Task]:
        """Start (or return the in-flight) background replica resync.  Same
        discipline as ``_kick_recovery``: one slot, runs ``config.resync``
        on the dispatch executor (never concurrent with a query), tracked
        in ``_dispatches`` so ``stop()`` awaits it.  Nothing ever waits on
        this task — failover serves FULL results while it runs."""
        if self._resyncing is not None:
            return self._resyncing
        if self.config.resync is None:
            return None

        loop = asyncio.get_running_loop()

        def _resync():
            with self.tracer.span("resync_replicas"):
                return self.config.resync()

        async def _run():
            t0 = time.monotonic()
            try:
                await loop.run_in_executor(self._exec, _resync)
                wall = time.monotonic() - t0
                self.metrics.on_resync(wall)
                self.recorder.record("resync_done", wall_s=round(wall, 4))
            except Exception:  # noqa: BLE001 — a failed resync leaves the
                pass           # replica dead; the next batch re-kicks
            finally:
                self._resyncing = None

        task = asyncio.create_task(_run())
        self._resyncing = task
        self._dispatches.add(task)
        task.add_done_callback(self._dispatches.discard)
        return task

    async def _dispatch(self, reqs: List[_Pending], rows: int) -> None:
        loop = asyncio.get_running_loop()
        # the batch span parents to the FIRST (oldest) request's span: a
        # batch has many logical parents, the tree keeps the one whose
        # window expiry flushed it; the rest link via their request spans
        bspan = self.tracer.begin("batch", parent=reqs[0].span, rows=rows,
                                  requests=len(reqs),
                                  accuracy=reqs[0].accuracy or "default")
        t_pad0 = time.monotonic()
        queue_waits = [t_pad0 - r.t_submit for r in reqs]
        batch = self._assemble(reqs)
        accuracy = reqs[0].accuracy  # _start_batch packs one accuracy per batch
        t0 = time.monotonic()
        pad_s = t0 - t_pad0
        if self.profile is not None:
            self.profile.on_batch_start()
        delays = iter(self.config.retry.delays())
        recovery_waits = 0
        while True:
            # the wait for the one dispatch worker, until the query starts
            # on whichever thread runs it (a span each try)
            wait = self.tracer.begin("serve.worker_wait", parent=bspan)
            try:
                (ids, scores, stats, builds, missing,
                 routing) = await loop.run_in_executor(
                    self._exec, self._query_once, batch, accuracy, bspan, wait)
                break
            except ShardLostError as e:
                # allow_partial=False policy: queue this batch behind shard
                # recovery, then re-dispatch for FULL results.  Bounded:
                # each wait either recovers the shard (progress) or falls
                # through to the retry budget.
                self.metrics.on_shard_lost()
                self.recorder.fault("shard_lost", where="dispatch",
                                    error=str(e))
                rec = self._kick_recovery()
                if rec is not None and recovery_waits < 2:
                    recovery_waits += 1
                    try:
                        await asyncio.shield(rec)
                    except Exception:  # noqa: BLE001 — re-dispatch decides
                        pass
                    continue
                try:
                    delay = next(delays)
                except StopIteration:
                    self._fail_batch(reqs, e, bspan)
                    return
                self.metrics.retries += 1
                self.recorder.fault("retry", after="shard_lost",
                                    delay_s=round(delay, 4))
                await asyncio.sleep(delay)
            except Exception as e:  # noqa: BLE001 — timeout/device errors
                if isinstance(e, TimeoutError):
                    self.metrics.timeouts += 1
                    self.recorder.fault("batch_timeout",
                                        timeout_s=self.config.batch_timeout_s)
                try:
                    delay = next(delays)
                except StopIteration:
                    self._fail_batch(reqs, e, bspan)
                    return
                self.metrics.retries += 1
                self.recorder.fault("retry", after=type(e).__name__,
                                    delay_s=round(delay, 4))
                await asyncio.sleep(delay)
        wall = time.monotonic() - t0
        if self.profile is not None:
            self.profile.on_batch_end()
        t_post0 = time.monotonic()
        self.metrics.on_batch(rows, wall, stats)
        self.metrics.query_index_builds += builds
        self.metrics.on_routing(routing["failovers"], routing["dispatches"])
        if getattr(self.store, "needs_resync", False):
            # a replica diverged (failover absorbed the failure — the batch
            # above still completed FULL); repair it behind the traffic
            self._kick_resync()
        if missing:
            # degraded delivery: flag every request in the batch and start
            # rebuilding the lost shards behind the traffic
            self.metrics.on_degraded(len(reqs))
            self.recorder.fault("degraded_serve", requests=len(reqs),
                                missing_shards=sorted(missing))
            for shard in set(missing) - self._seen_lost:
                self._seen_lost.add(shard)
                self.metrics.on_shard_lost()
            self._kick_recovery()
        now = time.monotonic()
        off = 0
        for req in reqs:
            n = len(req.nnz)
            out = ServeResult(ids[off:off + n, :req.k].copy(),
                              scores[off:off + n, :req.k].copy(),
                              missing_shards=missing)
            off += n
            if not req.future.done():
                req.future.set_result(out)
            self.metrics.on_complete(
                now - req.t_submit,
                missed_deadline=(req.t_deadline is not None
                                 and now > req.t_deadline),
            )
            self.tracer.end(req.span)
        post_s = time.monotonic() - t_post0
        self.metrics.on_phases(queue_waits, pad_s, wall, post_s)
        self.tracer.end(bspan, wall_ms=round(wall * 1e3, 3))

    def _fail_batch(self, reqs: List[_Pending], e: BaseException,
                    bspan=None) -> None:
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError(f"batch dispatch failed: {e!r}"))
            self.tracer.end(req.span, error=type(e).__name__)
        self.metrics.on_fail(len(reqs))
        self.recorder.fault("batch_failed", requests=len(reqs),
                            error=f"{type(e).__name__}: {e}")
        self.tracer.end(bspan, error=type(e).__name__)
