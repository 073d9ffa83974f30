"""Traffic kind ``open_loop_serve``: a stream of query requests on a schedule.

Independent clients each send a few spectra and wait for their k best
library matches, as in peptide identification: an open loop, where a
request is sent when it is due whether or not earlier ones have been
answered.  The requests go through ``KNNScheduler.submit`` over one
``SparseKNNIndex`` of S built in set-up.

Mix parameters (``traffic/<name>.json``):

* ``spec`` — the index's ``JoinSpec`` fields besides the configuration's;
* ``rate_per_s`` — requests a second, fixed;
* ``rows`` — [least, most] R rows a request, uniform;
* ``serve_r_block``, ``window_ms`` — the scheduler's batch rows and
  micro-batch window (``ServeConfig``);
* ``shape_seed`` — the seed of the arrival times and request sizes.

Every run of a given length sends the same requests at the same times:
the arrival times are a Poisson stream's given its count (sorted uniform
draws over the window) and the sizes uniform draws, both from
``shape_seed``; the run's seed picks each request's spectra from R, the
pool of experimental spectra (and makes R and S).  Below the knee a
request's wait is the work queued ahead of it, so the tail follows the
arrivals' clusters: with ~94 requests in a window, arrivals drawn from
each seed (or one set of gaps put in each seed's order) move the p95 by
some 40% from seed to seed (an M/D/1 queue at 4/5 of its capacity), far
more than a bound can hold.  So the seed changes what is asked, not
when or how much.

Each request is timed from when it was due to when its answer arrived,
so a stall counts against every request it delays.  End-to-end:
``query_p95_ms``, the 95th percentile of every answered request's
latency.  A refused or failed request counts in ``failed``; one
unanswered a minute after the window closes makes the run not correct.
"""
from __future__ import annotations

import asyncio
import sys
import time

import numpy as np

LATE_WAIT_S = 60.0


def schedule(mix: dict, seconds: float, seed: int, pool: int):
    """(due offsets in seconds (n,), [rows of R for each request])."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    shape = np.random.default_rng(mix["shape_seed"])
    due = np.sort(shape.uniform(0.0, seconds, size=n))
    lo, hi = mix["rows"]
    sizes = shape.integers(lo, hi + 1, size=n)
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    rows = [np.sort(rng.choice(pool, size=int(s), replace=False)) for s in sizes]
    return due, rows


def compared_rows(run, seconds: float):
    """The R rows whose answers a run of ``seconds`` compares: every row
    of every request of its schedule."""
    _, rows = schedule(run.mix, seconds, run.seed, len(run.R[0]))
    return np.unique(np.concatenate(rows))


def _bucket_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


class Traffic:
    def __init__(self, run):
        from repro_torch.core.engine import JoinSpec, SparseKNNIndex
        from repro_torch.obs.trace import Tracer
        from repro_torch.serve.scheduler import KNNScheduler, ServeConfig
        from repro_torch.sparse.format import from_arrays

        cfg, mix = run.config, run.mix
        self.run = run
        self.k = cfg["k"]
        dim = cfg["dim"]
        (ri, rv, rn), (si, sv, sn) = run.R, run.S
        spec = JoinSpec(k=cfg["k"], tile=cfg["tile"], r_block=cfg["r_block"],
                        s_block=cfg["s_block"], **mix["spec"])
        self.index = SparseKNNIndex.build(from_arrays(si, sv, sn, dim), spec, device=run.device)
        self.plan(mix, run.seconds)
        serve_cfg = ServeConfig(r_block=mix["serve_r_block"], window_s=mix["window_ms"] * 1e-3)
        self.sched = KNNScheduler(self.index, serve_cfg,
                                  tracer=None if run.tracing else Tracer(enabled=False))
        self.loop = asyncio.new_event_loop()
        self.loop.run_until_complete(self.sched.start())
        # one batch of each feature width the traffic's batches can take
        bucket = serve_cfg.feature_bucket
        first = {}
        for i, req in enumerate(self.requests):
            first.setdefault(_bucket_up(req.max_features, bucket), i)
        for i in sorted(first.values()):
            self.loop.run_until_complete(self.sched.submit(self.requests[i], k=self.k))
        run.sync()

    def plan(self, mix: dict, seconds: float) -> None:
        """The requests of a window of ``seconds`` under ``mix``, each as
        its client sends it: its rows, cut to their widest."""
        from repro_torch.sparse.format import from_arrays

        (ri, rv, rn), dim = self.run.R, self.run.config["dim"]
        self.due, self.rows = schedule(mix, seconds, self.run.seed, len(ri))
        self.requests = []
        for rows in self.rows:
            w = max(int(rn[rows].max()), 1)
            self.requests.append(from_arrays(ri[rows, :w], rv[rows, :w], rn[rows], dim))

    async def _stream(self, t0: float, seconds: float):
        from repro_torch.serve.scheduler import QueueFull

        n = len(self.due)
        latency = np.full(n, np.nan)
        late = np.zeros(n)
        answers = [None] * n
        refused, errors = 0, []

        async def one(i):
            nonlocal refused
            try:
                ids, scores = await self.sched.submit(self.requests[i], k=self.k)
            except QueueFull:
                refused += 1
                return
            except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
                errors.append(f"{type(e).__name__}: {e}")
                return
            latency[i] = time.monotonic() - (t0 + self.due[i])
            answers[i] = (self.rows[i], np.asarray(ids), np.asarray(scores))

        tasks = []
        for i in range(n):
            delay = t0 + self.due[i] - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            late[i] = time.monotonic() - (t0 + self.due[i])
            tasks.append(asyncio.create_task(one(i)))
        t_sent = time.monotonic()
        _, pending = await asyncio.wait(tasks, timeout=LATE_WAIT_S + seconds - (t_sent - t0))
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        return latency, late, answers, refused, errors, len(pending)

    def measure(self, seconds: float) -> dict:
        sched = self.sched
        sched.metrics.reset_window()
        with self.run.window():
            t0 = time.monotonic()
            latency, late, answers, refused, errors, unanswered = self.loop.run_until_complete(
                self._stream(t0, seconds))
            elapsed = time.monotonic() - t0
        done = ~np.isnan(latency)
        for e in errors[:5]:
            print(f"request failed: {e}", file=sys.stderr)
        print(f"generator: {len(late)} requests due over {seconds:.1f} s, late by p50 "
              f"{np.percentile(late, 50) * 1e3:.3f} ms, p99 {np.percentile(late, 99) * 1e3:.3f} "
              f"ms, max {late.max() * 1e3:.3f} ms; answered {int(done.sum())}, refused {refused}, "
              f"failed {len(errors)}, unanswered {unanswered}, last answer at {elapsed:.3f} s",
              file=sys.stderr)
        m = sched.metrics
        fill, wait = m.occupancy.snapshot(), m.queue_wait.snapshot()
        counters = {
            "fill_mean": float(np.mean(fill)) if len(fill) else None,
            "queue_wait_mean_s": float(np.mean(wait)) if len(wait) else None,
        }
        end_to_end = {}
        if done.any():
            end_to_end["query_p95_ms"] = float(np.percentile(latency[done], 95)) * 1e3
        return {
            "end_to_end": end_to_end,
            "attempted": len(late),
            "failed": refused + len(errors),
            "unanswered": unanswered,
            "counters": counters,
            "answers": [a for a in answers if a is not None],
        }

    def release(self) -> None:
        self.loop.run_until_complete(self.sched.stop(drain=True))
        self.loop.close()
        self.sched = self.index = None
