"""The port's serving front-end (src/repro_torch/serve: KNNScheduler,
ServeMetrics) and its profile hooks (src/repro_torch/obs/profile.py), on
the CPU.

First the counterparts of tests/test_serve_scheduler.py's stub-store cases
(flush on block-full, window and deadline; head of line never split;
backpressure; submit while a batch is in flight; retry; batch timeout;
stop without drain; the summary; validation) and of tests/test_obs.py's
scheduler and metrics cases (the summary's schema frozen to the JAX
``ServeMetrics.summary()`` keys, registry cells, reset_window, phases, span
parenting across the dispatch thread, mutate spans), and the port's
``serve.worker_wait`` span: a batch's wait for the one dispatch worker.
The port's ``_assemble`` makes a batch of just its requests' rows (the
JAX scheduler pads the rows to exactly ``r_block``): held here over live
rows and r_block.

Then the port's store behind the scheduler: de-interleaving with ragged
request sizes and per-request k, before and after mutations through
``mutate``.  Each answer is held bit for bit against a direct query of
THE SAME ASSEMBLED BATCH (rebuilt with ``sched._assemble`` on the same
requests), and within tolerance (scores rtol=1e-5, atol=1e-6, ids equal
outside tie groups) against a direct query of the request's rows alone:
a batch of another row count makes a product of another shape, which may
take another matmul kernel and move a score's last bit.

Last, the two shard-loss policies with ``recover`` from a ``tmp_path``
checkpoint: degraded answers, then recovery behind the traffic, then full
answers; and a batch queued behind recovery.  The reference's own two
tests of these policies (tests/test_store_durability.py
``::test_scheduler_degraded_serving_and_background_recovery`` and
``::test_scheduler_queued_behind_recovery``) fail for that padding
effect, not for recovery: they hold the scheduler's answer bit for bit
against a direct ``store.query(R)`` of R's 24 rows, while the scheduler
dispatched R padded to r_block = 32 rows, and XLA's product of the other
shape differs from the direct one by 1 f32 ulp in one score (row 19:
2.2478364 against 2.2478366, ids equal).  These tests compare against the
same assembled batch instead."""
import asyncio
import dataclasses
import json
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.metrics import ServeMetrics as JaxServeMetrics  # noqa: E402
from repro_torch.core.engine import JoinSpec, JoinStats  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    FlightRecorder,
    get_recorder,
    parse_exposition,
    set_recorder,
)
from repro_torch.obs.profile import ProfileCapture, fanout_report  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.runtime.fault import FaultPlan, FaultSpec, RetryPolicy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    KNNScheduler,
    QueueFull,
    ServeConfig,
    ServeMetrics,
    ServeResult,
)
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import SparseBatch, from_arrays  # noqa: E402
from repro_torch.store import ShardedKNNStore  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """Each test gets its own process-global flight recorder."""
    old = get_recorder()
    rec = FlightRecorder()
    set_recorder(rec)
    yield rec
    set_recorder(old)


def tiny_rows(n: int, f: int = 3, dim: int = 32) -> SparseBatch:
    idx = np.tile(np.arange(f, dtype=np.int32), (n, 1))
    return from_arrays(idx, np.ones((n, f), np.float32), np.full(n, f, np.int32), dim)


# ---------------------------------------------------------------------------
# stub store: scheduler behaviour without device work
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _StubSpec:
    k: int = 4


class _StubStats:
    index_builds = 0


class _StubResult:
    def __init__(self, ids, scores, stats):
        self.ids, self.scores, self.stats = ids, scores, stats


class StubStore:
    """Deterministic per-row results: id row r = nnz[r]*10 + [0..k)."""

    dim = 32
    spec = _StubSpec()
    stats = _StubStats()

    def __init__(self, sleep_s: float = 0.0, fail_first: int = 0):
        self.sleep_s = sleep_s
        self.fail_first = fail_first
        self.calls = 0
        self.batch_rows = []
        self.batch_devices = []
        self.threads = set()
        self.started = threading.Event()

    def query(self, R: SparseBatch):
        self.started.set()
        self.calls += 1
        self.threads.add(threading.current_thread().name)
        if self.calls <= self.fail_first:
            raise RuntimeError("injected dispatch failure")
        if self.sleep_s:
            time.sleep(self.sleep_s)
        self.batch_rows.append(R.num_vectors)
        self.batch_devices.append(R.indices.device.type)
        ids = R.nnz[:, None].to(torch.int32) * 10 + torch.arange(self.spec.k,
                                                                 dtype=torch.int32)
        st = JoinStats()
        st.device_dispatches = 1
        st.host_syncs = 1
        return _StubResult(ids, ids.to(torch.float32) / 100.0, st)


def test_flush_on_block_full_before_window():
    """queued rows == r_block flushes at once, not at window expiry; the
    batch is CPU tensors, dispatched on the one worker thread."""
    store = StubStore()

    async def main():
        t0 = time.monotonic()
        async with KNNScheduler(store, ServeConfig(r_block=4, window_s=30.0)) as sched:
            await asyncio.gather(*[sched.submit(tiny_rows(1)) for _ in range(4)])
        assert time.monotonic() - t0 < 5.0
        assert store.calls == 1 and store.batch_rows == [4]
        assert store.batch_devices == ["cpu"]
        assert len(store.threads) == 1 and next(iter(store.threads)).startswith(
            "knn-serve-dispatch")

    asyncio.run(main())


def test_flush_on_window_expiry():
    store = StubStore()

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=64, window_s=0.02)) as sched:
            t0 = time.monotonic()
            await sched.submit(tiny_rows(2))
            waited = time.monotonic() - t0
        assert store.batch_rows == [2]      # its rows, not padded to r_block
        assert waited >= 0.015

    asyncio.run(main())


ASSEMBLE_CASES = [(rows, rb) for rb in (4, 48, 64, 2048)
                  for rows in sorted({1, 7, 8, 9, 33, 64, 65, rb - 1, rb}) if 0 < rows <= rb]


@pytest.mark.parametrize("rows,r_block", ASSEMBLE_CASES)
def test_assemble_sizes_a_batch_to_its_rows(rows, r_block):
    """A batch of ``rows`` live rows, from ragged requests of ragged
    widths, has ``rows`` rows, whatever r_block; each row is its request's
    bytes, and the columns past a request's width are empty with sentinel
    indices."""
    sched = KNNScheduler(StubStore(), ServeConfig(r_block=r_block))
    rng = np.random.default_rng(rows * 7919 + r_block)
    sizes, left = [], rows
    while left:
        sizes.append(int(rng.integers(1, min(left, 20) + 1)))
        left -= sizes[-1]
    reqs = []
    for n in sizes:
        f = int(rng.integers(1, 12))
        nnz = rng.integers(0, f + 1, size=n).astype(np.int32)
        idx = np.full((n, f), StubStore.dim, np.int32)
        val = np.zeros((n, f), np.float32)
        for i, m in enumerate(nnz):
            idx[i, :m] = np.sort(rng.choice(StubStore.dim, size=m, replace=False))
            val[i, :m] = rng.standard_normal(m)
        reqs.append(types.SimpleNamespace(idx=idx, val=val, nnz=nnz))
    batch = sched._assemble(reqs)
    assert batch.num_vectors == rows
    assert batch.indices.shape[1] % sched.config.feature_bucket == 0
    idx, val, nnz = batch.indices.numpy(), batch.values.numpy(), batch.nnz.numpy()
    off = 0
    for r in reqs:
        n, f = r.idx.shape
        assert idx[off:off + n, :f].tobytes() == r.idx.tobytes()
        assert val[off:off + n, :f].tobytes() == r.val.tobytes()
        assert nnz[off:off + n].tobytes() == r.nnz.tobytes()
        assert (idx[off:off + n, f:] == StubStore.dim).all() and (val[off:off + n, f:] == 0).all()
        off += n


def test_flush_on_deadline_pressure():
    store = StubStore()

    async def main():
        t0 = time.monotonic()
        async with KNNScheduler(store, ServeConfig(r_block=64, window_s=30.0)) as sched:
            await sched.submit(tiny_rows(1), deadline=0.05)
        assert time.monotonic() - t0 < 5.0
        assert store.calls == 1

    asyncio.run(main())


def test_head_of_line_request_never_splits():
    store = StubStore()

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=4, window_s=0.01)) as sched:
            await asyncio.gather(sched.submit(tiny_rows(3)), sched.submit(tiny_rows(3)))
        assert store.calls == 2
        assert store.batch_rows == [3, 3]   # 3 | 3, never 4|2

    asyncio.run(main())


def test_backpressure_rejects_with_retry_after():
    store = StubStore(sleep_s=0.2)

    async def main():
        cfg = ServeConfig(r_block=4, window_s=0.001, queue_rows_hwm=6)
        async with KNNScheduler(store, cfg) as sched:
            t1 = asyncio.create_task(sched.submit(tiny_rows(4)))
            await asyncio.sleep(0.05)            # first batch now in flight
            t2 = asyncio.create_task(sched.submit(tiny_rows(4)))
            await asyncio.sleep(0)               # t2 queued: 4 rows
            with pytest.raises(QueueFull) as exc:
                await sched.submit(tiny_rows(4))  # 4 + 4 > hwm=6 → bounce
            assert exc.value.retry_after_s > 0
            await asyncio.gather(t1, t2)
            await sched.submit(tiny_rows(4))     # drained: the retry succeeds
        assert sched.metrics.rejected == 1
        assert sched.metrics.completed == 3

    asyncio.run(main())


def test_submit_returns_while_batch_in_flight():
    store = StubStore(sleep_s=0.4)

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=2, window_s=0.001)) as sched:
            a = asyncio.create_task(sched.submit(tiny_rows(2)))
            while not store.started.is_set():     # batch A inside query()
                await asyncio.sleep(0.001)
            t0 = time.monotonic()
            b = asyncio.create_task(sched.submit(tiny_rows(1)))
            await asyncio.sleep(0)
            admit_wall = time.monotonic() - t0
            assert sched.metrics.submitted == 2   # B admitted mid-flight
            assert not a.done() and not b.done()
            assert admit_wall < 0.1               # ≪ the 0.4 s dispatch
            await asyncio.gather(a, b)
        assert store.calls == 2

    asyncio.run(main())


def test_dispatch_retry_then_success():
    store = StubStore(fail_first=1)

    async def main():
        cfg = ServeConfig(r_block=2, window_s=0.001,
                          retry=RetryPolicy(max_retries=2, backoff_s=0.001, jitter=0.5))
        async with KNNScheduler(store, cfg) as sched:
            ids, scores = await sched.submit(tiny_rows(1))
        assert ids.shape == (1, 4) and isinstance(ids, np.ndarray)
        assert sched.metrics.retries == 1
        assert sched.metrics.failed == 0

    asyncio.run(main())


def test_batch_timeout_exhausts_and_fails_futures():
    store = StubStore(sleep_s=0.5)

    async def main():
        cfg = ServeConfig(r_block=2, window_s=0.001, batch_timeout_s=0.02,
                          retry=RetryPolicy(max_retries=1, backoff_s=0.001))
        async with KNNScheduler(store, cfg) as sched:
            with pytest.raises(RuntimeError, match="batch dispatch failed"):
                await sched.submit(tiny_rows(1))
        assert sched.metrics.timeouts >= 1
        assert sched.metrics.failed == 1
        assert sched.metrics.completed == 0

    asyncio.run(main())


def test_stop_without_drain_fails_queued_but_completes_inflight():
    store = StubStore(sleep_s=0.3)

    async def main():
        sched = await KNNScheduler(store, ServeConfig(r_block=2, window_s=5.0)).start()
        a = asyncio.create_task(sched.submit(tiny_rows(2)))  # block-full flush
        while not store.started.is_set():
            await asyncio.sleep(0.001)
        b = asyncio.create_task(sched.submit(tiny_rows(1)))  # queued only
        await asyncio.sleep(0.01)
        assert sched.metrics.submitted == 2
        await sched.stop(drain=False)
        ids, scores = await a                 # the in-flight batch delivered
        assert ids.shape == (2, 4)
        with pytest.raises(RuntimeError, match="stopped without drain"):
            await b
        assert store.calls == 1
        assert sched.metrics.failed == 1
        assert sched.metrics.completed == 1
        assert sched.metrics.queue_depth == 0
        assert sched.metrics.inflight == 0

    asyncio.run(main())


def test_metrics_summary_of_a_run():
    store = StubStore()

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=4, window_s=0.005)) as sched:
            await asyncio.gather(*[sched.submit(tiny_rows(2)) for _ in range(6)])
        s = sched.metrics.summary()
        assert s["requests"]["submitted"] == s["requests"]["completed"] == 6
        assert s["requests"]["inflight_peak"] >= 1
        assert s["latency"]["p50_ms"] is not None
        assert s["latency"]["p99_ms"] >= s["latency"]["p50_ms"]
        assert s["throughput"]["queries_per_s"] > 0
        assert 0 < s["batches"]["mean_occupancy"] <= 1.0
        assert s["batches"]["count"] == store.calls
        assert s["dispatch"]["device_dispatches"] == store.calls
        assert s["dispatch"]["query_index_builds"] == 0
        assert s["queue"]["depth"] == 0

    asyncio.run(main())


def test_submit_validation():
    store = StubStore()

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=4)) as sched:
            with pytest.raises(ValueError, match="rows > r_block"):
                await sched.submit(tiny_rows(5))
            with pytest.raises(ValueError, match="k="):
                await sched.submit(tiny_rows(1), k=9)
            with pytest.raises(ValueError, match="dim mismatch"):
                await sched.submit(tiny_rows(1, dim=64))
            with pytest.raises(ValueError, match="accuracy"):
                await sched.submit(tiny_rows(1), accuracy="fast")
            with pytest.raises(ValueError, match="LSH band tier"):
                await sched.submit(tiny_rows(1), accuracy="approx")
            empty = await sched.submit(tiny_rows(0), k=2)
            assert empty[0].shape == (0, 2) and not empty.degraded
        with pytest.raises(RuntimeError, match="not running"):
            await sched.submit(tiny_rows(1))

    asyncio.run(main())


# ---------------------------------------------------------------------------
# ServeMetrics: the reference's schema, registry cells, windows, phases
# ---------------------------------------------------------------------------

def _schema(summary):
    return {section: list(keys) for section, keys in summary.items()}


def test_summary_schema_frozen_to_the_reference():
    """Same sections, same keys, same order, same zero-state values and
    types as the JAX ServeMetrics.summary()."""
    got, want = ServeMetrics(r_block=8).summary(), JaxServeMetrics(r_block=8).summary()
    assert list(got) == list(want)
    assert _schema(got) == _schema(want)
    for s in (got, want):                  # a clock: the two were made apart
        s["throughput"]["elapsed_s"] = round(s["throughput"]["elapsed_s"], 0)
    assert json.dumps(got) == json.dumps(want)
    assert isinstance(got["faults"]["recovery_s"], float)


def test_metrics_match_the_reference_on_a_scripted_sequence():
    """The same events fed to both copies give the same counters, registry
    exposition (timestamps aside) and phase counts."""
    def script(m):
        m.on_submit(3)
        m.on_submit(2)
        m.on_batch_start(5)
        m.on_batch(5, wall_s=0.01)
        m.on_complete(0.02)
        m.on_complete(0.03, missed_deadline=True)
        m.on_reject()
        m.on_fail(1)
        m.on_degraded(2)
        m.on_shard_lost()
        m.on_recovery(0.5)
        m.on_routing(1, {0: 2, 1: 1})
        m.on_resync(0.25)
        m.on_phases([0.001, 0.002], 0.0005, 0.01, 0.0002)
        m.retries += 1
        s = m.summary()
        return ({k: v for k, v in s.items() if k not in ("throughput", "latency")},
                s["latency"], {k: v["count"] for k, v in m.phase_summary().items()})

    assert script(ServeMetrics(r_block=8)) == script(JaxServeMetrics(r_block=8))


def test_metrics_attributes_are_registry_cells():
    m = ServeMetrics(r_block=4)
    m.on_submit(2)
    m.on_batch(2, wall_s=0.01)
    m.on_complete(0.02)
    m.retries += 1
    parsed = parse_exposition(m.expose())
    assert parsed["serve_requests_submitted"]["value"] == m.submitted == 1
    assert parsed["serve_batch_retries"]["value"] == m.retries == 1
    assert parsed["serve_batches"]["value"] == 1
    assert parsed["serve_inflight"]["value"] == 0
    assert parsed["serve_inflight_peak"]["value"] == 1
    assert parsed["serve_latency_seconds"]["count"] == 1


def test_reset_window_rebases_window_not_lifetime():
    m = ServeMetrics(r_block=4)
    for _ in range(5):
        m.on_submit(1)
        m.on_complete(1.0)
    m.on_phases([0.5], 0.5, 0.5, 0.5)
    assert m.summary()["latency"]["p50_ms"] == pytest.approx(1000.0)
    m.reset_window()
    assert m.completed == 5
    s = m.summary()
    assert s["requests"]["completed"] == 5
    assert s["latency"]["p50_ms"] is None
    assert s["throughput"]["queries_per_s"] == 0.0
    for ph in m.phase_summary().values():
        assert ph["p50_ms"] is None
    m.on_submit(1)
    m.on_complete(0.002)
    assert m.summary()["latency"]["p50_ms"] == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# the port's store behind the scheduler
# ---------------------------------------------------------------------------

DIM = 256


def _requests(R, sizes):
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [R.rows(int(bounds[i]), int(bounds[i + 1])) for i in range(len(sizes))]


def _recording(sched):
    """Record each batch the scheduler assembles: (request ids, batch)."""
    seen, real = [], sched._assemble

    def assemble(reqs):
        batch = real(reqs)
        seen.append(([r.rid for r in reqs], batch))
        return batch

    sched._assemble = assemble
    return seen, real


def _pending(rows):
    """A request as ``_assemble`` reads it (host arrays)."""
    return types.SimpleNamespace(idx=rows.indices.numpy(), val=rows.values.numpy(),
                                 nnz=rows.nnz.numpy())


def check_deinterleaved(store, assemble, seen, reqs, ks, outs, rid0=0):
    """Every answer equals its rows of a direct query of the same batch,
    rebuilt with ``assemble`` on the same requests, bit for bit; and a
    direct query of its rows alone within tolerance.  Returns the count of
    batches checked."""
    for rids, batch in seen:
        if not rids or rids[0] < rid0:
            continue
        rebuilt = assemble([_pending(reqs[r - rid0]) for r in rids])
        assert all(torch.equal(getattr(rebuilt, f), getattr(batch, f))
                   for f in ("indices", "values", "nnz"))
        direct = store.query(rebuilt)
        off = 0
        for r in rids:
            n, k = reqs[r - rid0].num_vectors, ks[r - rid0]
            ids, scores = outs[r - rid0]
            assert np.array_equal(ids, direct.ids[off:off + n, :k].numpy())
            assert np.array_equal(scores, direct.scores[off:off + n, :k].numpy())
            off += n
    for rows, k, (ids, scores) in zip(reqs, ks, outs):
        alone = store.query(rows)
        assert ids.shape == (rows.num_vectors, k)
        assert_topk_close(scores, ids, alone.scores[:, :k].numpy(), alone.ids[:, :k].numpy(),
                          RTOL, ATOL)
    return sum(1 for rids, _ in seen if rids and rids[0] >= rid0)


@pytest.mark.parametrize("algorithm", ["iib", "iiib"])
def test_deinterleave_parity_ragged_sizes_and_k(algorithm):
    """Ragged request sizes and per-request k on a 4-shard store, before
    and after add (TTL) / delete / expire through ``mutate``: bit for bit
    the same assembled batch, within tolerance of each request alone."""
    S = synthetic_sparse(96, dim=DIM, nnz_mean=12, seed=1)
    R = synthetic_sparse(36, dim=DIM, nnz_mean=10, seed=2)
    store = ShardedKNNStore.build(S, JoinSpec(k=5, algorithm=algorithm, r_block=8, s_block=32),
                                  num_shards=4, device="cpu")
    sizes = [1, 3, 2, 5, 4, 1, 2, 6]
    ks = [5, 2, 4, 5, 1, 3, 5, 2]
    reqs = _requests(R, sizes)

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=8, window_s=0.02)) as sched:
            seen, assemble = _recording(sched)

            async def round_(rid0):
                outs = await asyncio.gather(*[sched.submit(q, k=k) for q, k in zip(reqs, ks)])
                assert check_deinterleaved(store, assemble, seen, reqs, ks, outs, rid0) >= 3

            await round_(0)
            gids = await sched.mutate(store.add, R.rows(24, 36), ttl=5.0, now=0.0)
            assert len(gids) == 12
            await sched.mutate(store.delete, [0, 1])
            await round_(len(reqs))
            await sched.mutate(store.expire, 10.0)     # the TTL batch tombstones
            await round_(2 * len(reqs))
            assert sched.metrics.query_index_builds == 0
            assert sched.metrics.completed == 3 * len(sizes)
            assert sched.metrics.failed == 0

    asyncio.run(main())


def test_deinterleave_parity_bf_index_across_row_counts():
    """A BF ``SparseKNNIndex`` behind the scheduler, requests of 3, 9, 30
    and 40 rows: alone each is a batch of its own rows, and together they
    coalesce (into batches of up to 64 rows); every answer bit for bit its
    rows of the same assembled batch, within tolerance of its rows alone."""
    from repro_torch.core.engine import SparseKNNIndex

    S = synthetic_sparse(120, dim=DIM, nnz_mean=12, seed=5)
    R = synthetic_sparse(82, dim=DIM, nnz_mean=10, seed=6)
    index = SparseKNNIndex.build(S, JoinSpec(k=5, algorithm="bf", r_block=64, s_block=32),
                                 device="cpu")
    sizes, ks = [3, 9, 30, 40], [5, 3, 5, 1]
    reqs = _requests(R, sizes)

    async def main():
        async with KNNScheduler(index, ServeConfig(r_block=64, window_s=0.02)) as sched:
            seen, assemble = _recording(sched)
            outs = [await sched.submit(q, k=k) for q, k in zip(reqs, ks)]
            assert [b.num_vectors for _, b in seen] == [3, 9, 30, 40]
            assert check_deinterleaved(index, assemble, seen, reqs, ks, outs) == 4
            outs = await asyncio.gather(*[sched.submit(q, k=k) for q, k in zip(reqs, ks)])
            assert check_deinterleaved(index, assemble, seen, reqs, ks, outs, len(reqs)) >= 2
            assert sched.metrics.failed == 0

    asyncio.run(main())


def test_store_ids_are_global():
    S = synthetic_sparse(64, dim=128, nnz_mean=8, seed=3)
    store = ShardedKNNStore.build(S, JoinSpec(k=3, algorithm="iib", r_block=8, s_block=16),
                                  num_shards=2, device="cpu")
    R = synthetic_sparse(8, dim=128, nnz_mean=8, seed=4)

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=8)) as sched:
            outs = await asyncio.gather(*[sched.submit(R.rows(i, i + 1)) for i in range(8)])
        for ids, scores in outs:
            valid = scores > -np.inf
            assert ((ids[valid] >= 0) & (ids[valid] < 64)).all()

    asyncio.run(main())


def test_span_parenting_across_threads(_fresh_recorder):
    """request → batch → store.dispatch → store.r_block form one parented
    tree although the dispatch hops from the event loop to the worker."""
    S = synthetic_sparse(48, dim=64, nnz_mean=8, seed=0)
    store = ShardedKNNStore.build(S, JoinSpec(k=3, algorithm="iib", r_block=4, s_block=16),
                                  num_shards=2, device="cpu")
    R = synthetic_sparse(2, dim=64, nnz_mean=8, seed=1)

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=4, window_s=0.005)) as sched:
            await sched.submit(R)
            await sched.mutate(store.delete, [0])

    asyncio.run(main())
    spans = [e for e in _fresh_recorder.events() if e.get("kind") == "span"]
    by_id = {e["span_id"]: e for e in spans}
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert {"request", "batch", "store.dispatch", "store.r_block", "mutate"} <= set(by_name)
    req = by_name["request"][0]
    assert req["parent_id"] is None
    assert by_name["batch"][0]["parent_id"] == req["span_id"]
    dispatch = by_name["store.dispatch"][0]
    assert by_id[dispatch["parent_id"]]["name"] == "batch"
    for rb in by_name["store.r_block"]:
        assert by_id[rb["parent_id"]]["name"] == "store.dispatch"


def _worker_waits(rec):
    """{batch span id: [its serve.worker_wait spans]}, batches in start order."""
    spans = [e for e in rec.events() if e.get("kind") == "span"]
    batches = sorted((e for e in spans if e["name"] == "batch"), key=lambda e: e["t_start"])
    waits = [e for e in spans if e["name"] == "serve.worker_wait"]
    return [(b, [w for w in waits if w["parent_id"] == b["span_id"]]) for b in batches]


def test_worker_wait_spans_the_wait_for_the_one_worker(_fresh_recorder):
    """Two batches flushed back to back: the second waits for the worker
    about one service time in ``serve.worker_wait``, while its queue-wait
    phase (submit -> assembly) stays under a window plus the assembly."""
    service = 0.3
    store = StubStore(sleep_s=service)
    cfg = ServeConfig(r_block=2, window_s=0.05)

    async def main():
        async with KNNScheduler(store, cfg) as sched:
            await asyncio.gather(sched.submit(tiny_rows(2)), sched.submit(tiny_rows(2)))
        return sched.metrics

    m = asyncio.run(main())
    (first, w1), (second, w2) = _worker_waits(_fresh_recorder)
    assert len(w1) == len(w2) == 1
    assert w1[0]["dur_ms"] < 0.3 * service * 1e3
    assert 0.8 * service * 1e3 <= w2[0]["dur_ms"] <= (service + 0.2) * 1e3
    assert first["t_start"] <= w1[0]["t_start"] and w2[0]["t_end"] <= second["t_end"]
    assert max(m.queue_wait.snapshot()) < cfg.window_s + max(m.pad.snapshot())


def test_worker_wait_span_for_each_try(_fresh_recorder):
    """A batch retried after a failed dispatch has a ``serve.worker_wait``
    span for each try; a tracer that is off records none."""
    store = StubStore(fail_first=1)
    cfg = ServeConfig(r_block=2, window_s=0.001,
                      retry=RetryPolicy(max_retries=2, backoff_s=0.001, jitter=0.5))

    async def main(tracer=None):
        async with KNNScheduler(store, cfg, tracer=tracer) as sched:
            await sched.submit(tiny_rows(1))

    asyncio.run(main())
    ((_, waits),) = _worker_waits(_fresh_recorder)
    assert len(waits) == 2 and waits[0]["t_end"] <= waits[1]["t_start"]
    _fresh_recorder.clear()
    asyncio.run(main(Tracer(enabled=False)))
    assert _fresh_recorder.events("span") == []


# ---------------------------------------------------------------------------
# shard loss: degraded serving and queueing behind recovery
# ---------------------------------------------------------------------------

def _durable_store(tmp_path):
    S = synthetic_sparse(160, dim=1024, nnz_mean=16, seed=0)
    store = ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="iib", r_block=32, s_block=48),
                                  num_shards=4, device="cpu")
    store.save(str(tmp_path))
    return store, synthetic_sparse(24, dim=1024, nnz_mean=16, seed=9)


def _bits_of_batch(store, assemble, R, res, k=5):
    """``res`` is bit for bit R's rows of a direct query of R's assembled
    batch (and within tolerance of a direct query of R)."""
    direct = store.query(assemble([_pending(R)]))
    assert np.array_equal(res[0], direct.ids[:R.num_vectors, :k].numpy())
    assert np.array_equal(res[1], direct.scores[:R.num_vectors, :k].numpy())
    alone = store.query(R)
    assert_topk_close(res[1], res[0], alone.scores.numpy(), alone.ids.numpy(), RTOL, ATOL)


def test_scheduler_degraded_serving_and_background_recovery(tmp_path):
    """allow_partial: a shard loss mid-traffic gives degraded answers at
    once (missing_shards (1,), no id of shard 1), recovery runs behind the
    traffic from the checkpoint, and answers are full again."""
    store, R = _durable_store(tmp_path)
    full = store.query(R)
    lo, hi = 40, 80                                    # shard 1's global ids

    async def main():
        cfg = ServeConfig(r_block=32, window_s=0.002, allow_partial=True,
                          recover=lambda: store.recover(str(tmp_path)))
        async with KNNScheduler(store, cfg) as sched:
            _, assemble = _recording(sched)
            store.fault_plan = FaultPlan([FaultSpec("shard_error", shard=1, at_dispatch=0)])
            res = await sched.submit(R, k=5)
            assert isinstance(res, ServeResult)
            assert res.degraded and res.missing_shards == (1,)
            ids, scores = res
            assert ids.shape == (24, 5)
            assert not ((ids >= lo) & (ids < hi)).any()
            for _ in range(500):                       # recovery is async; poll
                if not store.lost_shards:
                    break
                await asyncio.sleep(0.01)
            assert store.lost_shards == (), "recovery never completed"
            res2 = await sched.submit(R, k=5)
            assert not res2.degraded
            _bits_of_batch(store, assemble, R, res2)
            assert_topk_close(res2[1], res2[0], full.scores.numpy(), full.ids.numpy(),
                              RTOL, ATOL)
            m = sched.metrics
        assert m.failed == 0
        assert m.shard_losses >= 1 and m.degraded >= 1 and m.recoveries == 1
        s = m.summary()["faults"]
        assert s["shard_losses"] >= 1 and s["recoveries"] == 1 and s["recovery_s"] > 0
        assert store.stats.recoveries == 1

    asyncio.run(main())


def test_scheduler_queued_behind_recovery(tmp_path):
    """allow_partial=False with a recover hook: the batch that hits the
    lost shard waits for the rebuild and re-dispatches; callers see only
    full answers."""
    store, R = _durable_store(tmp_path)

    async def main():
        cfg = ServeConfig(r_block=32, window_s=0.002, allow_partial=False,
                          recover=lambda: store.recover(str(tmp_path)))
        async with KNNScheduler(store, cfg) as sched:
            _, assemble = _recording(sched)
            store.fault_plan = FaultPlan([FaultSpec("shard_error", shard=2, at_dispatch=0)])
            res = await sched.submit(R, k=5)
            assert res.missing_shards == ()
            _bits_of_batch(store, assemble, R, res)
            m = sched.metrics
        assert m.failed == 0 and m.degraded == 0
        assert m.shard_losses >= 1 and m.recoveries == 1
        assert store.lost_shards == ()

    asyncio.run(main())


def test_lost_shard_without_recover_fails_the_batch(tmp_path):
    """No recover hook and no allow_partial: the retries run out and the
    batch's futures fail (nothing hangs)."""
    store, R = _durable_store(tmp_path)

    async def main():
        cfg = ServeConfig(r_block=32, window_s=0.002,
                          retry=RetryPolicy(max_retries=1, backoff_s=0.001))
        async with KNNScheduler(store, cfg) as sched:
            store.fault_plan = FaultPlan([FaultSpec("shard_error", shard=0, at_dispatch=0)])
            with pytest.raises(RuntimeError, match="batch dispatch failed"):
                await sched.submit(R, k=5)
        assert sched.metrics.failed == 1 and sched.metrics.retries == 1

    asyncio.run(main())


# ---------------------------------------------------------------------------
# profile hooks
# ---------------------------------------------------------------------------

def test_profile_capture_over_two_batches(tmp_path):
    """ProfileCapture armed by the scheduler writes a Chrome trace over the
    next 2 batches; ops run on the dispatch worker appear in it."""
    S = synthetic_sparse(96, dim=DIM, nnz_mean=12, seed=1)
    R = synthetic_sparse(16, dim=DIM, nnz_mean=10, seed=2)
    store = ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="bf", r_block=8, s_block=32),
                                  num_shards=2, device="cpu")
    cap = ProfileCapture(str(tmp_path / "prof"), n_batches=2)

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=8, window_s=0.001),
                                profile=cap) as sched:
            for i in range(4):
                await sched.submit(R.rows(4 * i, 4 * i + 4))

    asyncio.run(main())
    s = cap.summary()
    assert s["error"] is None and s["done"] and s["batches"] == 2
    with open(s["trace"]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
    with pytest.raises(ValueError):
        ProfileCapture(str(tmp_path), n_batches=0)


def test_fanout_report_on_the_cpu():
    """One store query under the profiler: no device kernels on the CPU,
    the FLOPs the profiler counts for the products, and the device name."""
    S = synthetic_sparse(96, dim=DIM, nnz_mean=12, seed=1)
    R = synthetic_sparse(16, dim=DIM, nnz_mean=10, seed=2)
    store = ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="iib", r_block=8, s_block=32),
                                  num_shards=2, device="cpu")
    rep = fanout_report(store, R)
    assert rep["device"] == "cpu" and rep["kernels"] == {} and rep["launches"] == 0
    assert rep["flops"] and rep["flops"] > 0 and rep["wall_s"] > 0
    json.dumps(rep)
