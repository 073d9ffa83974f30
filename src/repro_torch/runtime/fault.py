"""Fault tolerance runtime: supervised step loop, retry policy, straggler
mitigation (the PyTorch port's copy of ``repro.runtime.fault``).

At 1000+ nodes the failure model is: (a) a host dies (coordinator raises a
distributed-runtime error on the next collective), (b) a device wedges
(the runtime raises), (c) a host straggles (slow input or slow NIC).  The
mitigations implemented here:

* ``Supervisor.run`` wraps the step loop.  On a retryable exception it
  re-initializes the training state from the last valid checkpoint (the
  manifest-verified ``latest_step``) and replays.  Because the data
  pipeline is a pure function of (seed, step), replay is exact: no batch
  is skipped or double-counted.  The restore path uses the elastic
  ``shard_fn``, so recovery onto a *smaller* surviving mesh (lost pod) is
  the same code path as same-size restart.
* ``RetryPolicy`` bounds retries with (optionally jittered) exponential
  backoff; a non-retryable error (assertion, NaN guard) propagates
  immediately.  ``with_timeout`` is the reusable call-level watchdog
  (the serve scheduler wraps each batch dispatch in it).
* **Straggler levers** (documented here, wired where they act):
  1. input prefetch depth ≥ 2 (data/pipeline.py) — a slow input host
     overlaps with compute;
  2. the ring join's threshold tightening is monotone, so a late shard
     only ever *over*-prunes later, never corrupts (core/ring.py);
  3. step-time watchdog: ``Supervisor.step_timeout`` aborts a wedged step
     so the retry path takes over instead of hanging the whole job
     (bounded staleness: the step is dropped and replayed after restore).
* **NaN guard** — ``guard_finite`` turns a non-finite loss into an
  immediate non-retryable error (bad data/overflow should fail loudly,
  not silently corrupt the run).

The port's differences: ``guard_finite`` reads a tensor (or anything numpy
takes) instead of a jax array, fault injections announce themselves to the
port's flight recorder (``repro_torch.obs.recorder``), and the checkpoint
corrupter ``corrupt_checkpoint_leaf`` acts on the port's checkpoint
module (``repro_torch.checkpoint.ckpt``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import numpy as np


class NonRetryableError(RuntimeError):
    pass


class ShardLostError(RuntimeError):
    """A store shard failed mid-dispatch.  Carries the shard index so the
    store/scheduler can mark exactly that shard lost and either serve
    degraded (``allow_partial``) or rebuild it from its checkpoint slice.
    On a replicated store the loss is scoped to the dispatching replica's
    COPY of the shard — the query fails over to another replica."""

    def __init__(self, shard: int, message: Optional[str] = None):
        super().__init__(message or f"shard {shard} lost")
        self.shard = shard


class ReplicaLostError(RuntimeError):
    """A whole store replica failed mid-dispatch (host down, device reset):
    every shard copy it held is gone.  Carries the replica index so the
    store's health tracker can mark it dead, fail the query over to a
    healthy replica, and queue a full anti-entropy resync."""

    def __init__(self, replica: int, message: Optional[str] = None):
        super().__init__(message or f"replica {replica} lost")
        self.replica = replica


def guard_finite(name: str, value) -> None:
    if hasattr(value, "detach"):         # a torch tensor, on any device
        value = value.detach().cpu().numpy()
    v = np.asarray(value)
    if not np.all(np.isfinite(v)):
        raise NonRetryableError(f"non-finite {name}: {v!r}")


@dataclasses.dataclass
class RetryPolicy:
    """Bounded exponential backoff, optionally jittered.

    ``jitter`` is a fraction: each delay is scaled by ``1 + U(0, jitter)``
    so a fleet of retriers (e.g. the serve scheduler's batch dispatches)
    doesn't thundering-herd the same instant.  ``delays()`` returns a
    materialized list — safe to iterate more than once (the old generator
    silently yielded nothing on a second pass) and cheap to log.
    """

    max_retries: int = 3
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    jitter: float = 0.0

    def delays(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        out = []
        d = self.backoff_s
        for _ in range(self.max_retries):
            scale = 1.0 + (rng.uniform(0.0, self.jitter) if self.jitter else 0.0)
            out.append(d * scale)
            d *= self.backoff_mult
        return out


def with_timeout(fn: Callable, timeout_s: Optional[float], *args, **kwargs):
    """Run ``fn(*args, **kwargs)``, raising ``TimeoutError`` after
    ``timeout_s`` seconds (None = no watchdog, call inline).

    The serve scheduler's per-batch watchdog: a wedged device dispatch
    must not hang the whole serving loop — the caller's RetryPolicy takes
    over instead.  The abandoned call keeps running on its daemon thread
    (a device dispatch is not interruptible); this bounds *caller* latency,
    the same trade ``Supervisor.step_timeout`` makes for training steps.
    """
    if timeout_s is None:
        return fn(*args, **kwargs)
    box: dict = {}

    def _run():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise TimeoutError(f"{getattr(fn, '__name__', fn)!s} exceeded {timeout_s}s")
    if "error" in box:
        raise box["error"]
    return box.get("value")


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultSpec:
    """One injected fault.

    kind:
      * ``"shard_error"`` — raise :class:`ShardLostError` (for ``shard``)
        when the store's dispatch counter reaches ``at_dispatch``;
      * ``"wedge"`` — sleep ``wedge_s`` inside the dispatch at
        ``at_dispatch`` (drives the caller's ``with_timeout`` watchdog);
      * ``"replica_error"`` — raise :class:`ReplicaLostError` for
        ``replica``: ARMS at ``at_dispatch`` and fires on the first
        armed dispatch actually ROUTED to that replica (a dead host
        kills whatever lands on it next, not a dispatch that went
        elsewhere);
      * ``"replica_wedge"`` — sleep ``wedge_s`` on the first armed
        dispatch routed to ``replica`` (a straggling replica);
      * ``"corrupt_leaf"`` — not dispatch-triggered; use
        :func:`corrupt_checkpoint_leaf` directly (kept here so a plan can
        be described declaratively).
    Each spec fires at most once.
    """

    kind: str
    at_dispatch: int = 0
    shard: int = 0
    replica: int = 0
    wedge_s: float = 0.0
    path: Optional[str] = None

    def __post_init__(self):
        if self.kind not in ("shard_error", "wedge", "replica_error",
                             "replica_wedge", "corrupt_leaf"):
            raise ValueError(f"unknown fault kind: {self.kind!r}")


class FaultPlan:
    """A scripted set of faults a store consults on every device dispatch.

    Attach via ``store.fault_plan = FaultPlan([...])``; the store calls
    :meth:`on_dispatch` immediately before each fan-out.  Deterministic —
    tests and benches replay identical fault sequences.
    """

    def __init__(self, specs, recorder=None):
        self.specs = list(specs)
        self.dispatches = 0
        self.fired: list = []
        # flight recorder the injections announce themselves to (default:
        # the process-wide one) — the dumped timeline shows the CAUSE next
        # to the failover/recovery effects the store records
        self.recorder = recorder

    def _recorder(self):
        if self.recorder is not None:
            return self.recorder
        from repro_torch.obs.recorder import get_recorder

        return get_recorder()

    def _note(self, spec, n: int) -> None:
        self._recorder().fault(
            "fault_injected", fault_kind=spec.kind, at_dispatch=n,
            shard=getattr(spec, "shard", None),
            replica=getattr(spec, "replica", None))

    def on_dispatch(self, replica: Optional[int] = None) -> None:
        """``replica`` is the replica the store routed this dispatch to
        (None on an unreplicated store).  shard_error/wedge fire exactly AT
        their dispatch index; replica kinds arm at it and fire on the first
        armed dispatch that actually lands on their target replica."""
        n = self.dispatches
        self.dispatches += 1
        for spec in self.specs:
            if spec in self.fired:
                continue
            if spec.kind in ("shard_error", "wedge"):
                if spec.at_dispatch != n:
                    continue
                self.fired.append(spec)
                self._note(spec, n)
                if spec.kind == "shard_error":
                    raise ShardLostError(spec.shard, f"injected at dispatch {n}")
                time.sleep(spec.wedge_s)
            elif spec.kind in ("replica_error", "replica_wedge"):
                if n < spec.at_dispatch or replica != spec.replica:
                    continue
                self.fired.append(spec)
                self._note(spec, n)
                if spec.kind == "replica_error":
                    raise ReplicaLostError(
                        spec.replica, f"injected at dispatch {n}")
                time.sleep(spec.wedge_s)


class ReplicaHealth:
    """Per-replica health state machine for the replicated store's router.

    States (the classic circuit-breaker shape, DESIGN.md §10):

    ``live`` ──(``fail_threshold`` CONSECUTIVE dispatch failures, or an
    explicit ``mark_dead`` on data loss)──► ``dead`` ──(anti-entropy
    resync re-placed its state: ``mark_resynced``)──► ``half_open``
    ──(one successful probe dispatch: ``record_success``)──► ``live``;
    a failed probe drops straight back to ``dead``.

    A transient failure below the threshold keeps the replica live (its
    consecutive counter resets on the next success); data-loss failures
    (``ReplicaLostError``) bypass the threshold — a replica whose device
    state is gone must not be routed to until resynced.  The tracker is
    pure bookkeeping: the store decides what counts as a failure and when
    a resync has happened.
    """

    LIVE, DEAD, HALF_OPEN = "live", "dead", "half_open"

    def __init__(self, n: int, fail_threshold: int = 1):
        if n < 1:
            raise ValueError("need at least one replica")
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.n = n
        self.fail_threshold = int(fail_threshold)
        self._state = [self.LIVE] * n
        self._consecutive = [0] * n

    def state(self, r: int) -> str:
        return self._state[r]

    def live(self):
        return [r for r in range(self.n) if self._state[r] == self.LIVE]

    def dead(self):
        return [r for r in range(self.n) if self._state[r] == self.DEAD]

    def half_open(self):
        return [r for r in range(self.n) if self._state[r] == self.HALF_OPEN]

    def record_failure(self, r: int) -> bool:
        """One dispatch failure on replica ``r``.  Returns True when this
        failure transitioned it to dead (threshold crossed, or a half-open
        probe failed)."""
        if self._state[r] == self.DEAD:
            return False
        self._consecutive[r] += 1
        if (self._state[r] == self.HALF_OPEN
                or self._consecutive[r] >= self.fail_threshold):
            self._state[r] = self.DEAD
            return True
        return False

    def mark_dead(self, r: int) -> bool:
        """Unconditional kill (data loss).  Returns True if it was not
        already dead."""
        was = self._state[r] != self.DEAD
        self._state[r] = self.DEAD
        self._consecutive[r] = max(self._consecutive[r], self.fail_threshold)
        return was

    def mark_resynced(self, r: int) -> None:
        """The replica's state has been re-placed; admit one probe."""
        if self._state[r] == self.DEAD:
            self._state[r] = self.HALF_OPEN

    def record_success(self, r: int) -> None:
        """A dispatch on ``r`` completed: clear the consecutive counter and
        re-admit a half-open replica (the probe passed)."""
        self._consecutive[r] = 0
        if self._state[r] == self.HALF_OPEN:
            self._state[r] = self.LIVE


def corrupt_checkpoint_leaf(directory: str, step: Optional[int] = None,
                            leaf: int = 0) -> str:
    """Flip bytes in one committed leaf file (fault injection for restore
    paths).  Returns the corrupted file's path.  ``step`` defaults to the
    newest committed step; ``leaf`` indexes into the manifest order."""
    import json
    import os

    from repro_torch.checkpoint import ckpt as _ckpt

    if step is None:
        step = _ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    fp = os.path.join(ckpt_dir, manifest["leaves"][leaf]["file"])
    # Copy-on-write: incremental saves hard-link unchanged leaves across
    # steps, and in-place writes would corrupt every step sharing the inode
    # (defeating the fall-back-to-previous-step path under test).
    with open(fp, "rb") as f:
        data = bytearray(f.read())
    mid = max(0, len(data) // 2)
    data[mid:mid + 4] = b"\xde\xad\xbe\xef"
    os.unlink(fp)
    with open(fp, "wb") as f:
        f.write(bytes(data))
    return fp


class _Watchdog:
    """Raises in the main thread flow by flagging; checked between steps."""

    def __init__(self, timeout_s: Optional[float]):
        self.timeout_s = timeout_s
        self._armed_at: Optional[float] = None
        self._lock = threading.Lock()

    def arm(self):
        with self._lock:
            self._armed_at = time.monotonic()

    def disarm(self):
        with self._lock:
            self._armed_at = None

    def expired(self) -> bool:
        if self.timeout_s is None:
            return False
        with self._lock:
            return (
                self._armed_at is not None
                and time.monotonic() - self._armed_at > self.timeout_s
            )


class Supervisor:
    """Run ``step_fn`` from ``start_step`` to ``num_steps`` with restart-on-failure.

    step_fn(step) -> metrics (host-visible after the call).
    restore_fn(reason) -> new start step (reloads state from checkpoint).
    """

    def __init__(
        self,
        step_fn: Callable[[int], Any],
        restore_fn: Callable[[str], int],
        policy: RetryPolicy = RetryPolicy(),
        step_timeout_s: Optional[float] = None,
        on_metrics: Optional[Callable[[int, Any], None]] = None,
    ):
        self.step_fn = step_fn
        self.restore_fn = restore_fn
        self.policy = policy
        self.watchdog = _Watchdog(step_timeout_s)
        self.on_metrics = on_metrics
        self.failures = 0

    def run(self, start_step: int, num_steps: int) -> int:
        step = start_step
        # The retry budget is per-INCIDENT, not per-run: a successful step
        # resets it, so two unrelated failures hours apart each get the
        # full backoff schedule instead of exhausting a shared global one.
        delays = None
        while step < num_steps:
            try:
                self.watchdog.arm()
                metrics = self.step_fn(step)
                self.watchdog.disarm()
                if self.on_metrics is not None:
                    self.on_metrics(step, metrics)
                step += 1
                delays = None
            except NonRetryableError:
                raise
            except Exception as e:  # noqa: BLE001 — device/runtime errors
                self.failures += 1
                if delays is None:
                    delays = iter(self.policy.delays())
                try:
                    delay = next(delays)
                except StopIteration:
                    raise RuntimeError(
                        f"step {step}: retries exhausted after {self.failures} failures"
                    ) from e
                time.sleep(delay)
                step = self.restore_fn(f"{type(e).__name__}: {e}")
        return step
