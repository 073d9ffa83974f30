"""The port's fault runtime (src/repro_torch/runtime/fault.py) on the
cases of tests/test_fault.py that do not touch checkpoints, and against
the JAX package's ``repro.runtime.fault`` on the same scripted sequences:
the supervisor's retries, the NaN guard (here on tensors too), retry
delays, the call watchdog, FaultPlan's firing rules, the replica health
circuit breaker, and the injections' flight-recorder events (the port's
recorder)."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import fault as jax_fault  # noqa: E402
from repro_torch import runtime as port_runtime  # noqa: E402
from repro_torch.obs import recorder as obs_recorder  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.runtime.fault import (  # noqa: E402
    FaultPlan,
    FaultSpec,
    NonRetryableError,
    ReplicaHealth,
    ReplicaLostError,
    RetryPolicy,
    ShardLostError,
    Supervisor,
    guard_finite,
    with_timeout,
)


def test_supervisor_happy_path():
    seen = []
    sup = Supervisor(lambda i: seen.append(i), lambda r: 0,
                     RetryPolicy(max_retries=0, backoff_s=0))
    assert sup.run(0, 5) == 5
    assert seen == [0, 1, 2, 3, 4]


def test_supervisor_retries_and_restores():
    calls = {"n": 0}
    restores = []

    def step(i):
        calls["n"] += 1
        if i == 3 and not restores:
            raise RuntimeError("simulated device failure")

    def restore_fn(reason):
        restores.append(reason)
        return 2

    sup = Supervisor(step, restore_fn, RetryPolicy(max_retries=2, backoff_s=0.01))
    assert sup.run(0, 6) == 6
    assert len(restores) == 1 and "simulated device failure" in restores[0]
    assert sup.failures == 1
    assert calls["n"] == 6 + 2


def test_supervisor_exhausts_retries_and_budget_is_per_incident():
    def always(i):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="retries exhausted"):
        Supervisor(always, lambda r: 0, RetryPolicy(max_retries=2, backoff_s=0.0)).run(0, 3)

    fail_at = {2: 1, 4: 1}

    def step(i):
        if fail_at.get(i, 0):
            fail_at[i] -= 1
            raise RuntimeError(f"incident@{i}")

    restores = []

    def restore_fn(reason):
        restores.append(reason)
        return int(reason.rsplit("@", 1)[1])

    sup = Supervisor(step, restore_fn, RetryPolicy(max_retries=1, backoff_s=0.0))
    assert sup.run(0, 6) == 6
    assert sup.failures == 2 and len(restores) == 2


def test_nonretryable_propagates():
    def step(i):
        raise NonRetryableError("NaN loss")

    with pytest.raises(NonRetryableError):
        Supervisor(step, lambda r: 0, RetryPolicy(max_retries=5, backoff_s=0.0)).run(0, 3)


@pytest.mark.parametrize("value,finite", [
    (np.float32(1.0), True), (np.float32(np.nan), False), (np.array([1.0, np.inf]), False),
    (torch.tensor([1.0, 2.0]), True), (torch.tensor(float("nan")), False),
    (torch.tensor([0.0, float("-inf")], requires_grad=True), False),
])
def test_guard_finite_reads_arrays_and_tensors(value, finite):
    if finite:
        guard_finite("ok", value)
    else:
        with pytest.raises(NonRetryableError, match="non-finite bad"):
            guard_finite("bad", value)


def test_retry_policy_delays_match_the_reference():
    for kw in ({"max_retries": 3, "backoff_s": 1.0, "backoff_mult": 2.0},
               {"max_retries": 4, "backoff_s": 0.5, "backoff_mult": 3.0, "jitter": 0.5}):
        for seed in (0, 1, 2):
            assert RetryPolicy(**kw).delays(seed=seed) == jax_fault.RetryPolicy(**kw).delays(
                seed=seed)
    p = RetryPolicy(max_retries=3, backoff_s=1.0, backoff_mult=2.0)
    assert p.delays() == [1.0, 2.0, 4.0] == p.delays()
    jit = RetryPolicy(max_retries=4, backoff_s=0.5, backoff_mult=3.0, jitter=0.5)
    for got, b in zip(jit.delays(seed=0), RetryPolicy(4, 0.5, 3.0).delays()):
        assert b <= got <= b * 1.5
    assert jit.delays(seed=1) != jit.delays(seed=2)


def test_with_timeout_passthrough_timeout_and_exceptions():
    assert with_timeout(lambda a, b: a + b, None, 1, b=2) == 3
    assert with_timeout(lambda: "ok", 5.0) == "ok"
    with pytest.raises(TimeoutError, match="exceeded"):
        with_timeout(time.sleep, 0.02, 1.0)

    def boom():
        raise ValueError("inner failure")

    with pytest.raises(ValueError, match="inner failure"):
        with_timeout(boom, 5.0)


def test_errors_carry_their_shard_and_replica():
    e = ShardLostError(3)
    assert e.shard == 3 and "shard 3" in str(e) and isinstance(e, RuntimeError)
    assert ShardLostError(1, "custom").args == ("custom",)
    r = ReplicaLostError(1)
    assert r.replica == 1 and "replica 1" in str(r) and isinstance(r, RuntimeError)


def test_fault_plan_kinds_and_wedges():
    plan = FaultPlan([FaultSpec("shard_error", shard=2, at_dispatch=1)])
    plan.on_dispatch()
    with pytest.raises(ShardLostError) as ei:
        plan.on_dispatch()
    assert ei.value.shard == 2
    plan.on_dispatch()
    assert plan.dispatches == 3 and len(plan.fired) == 1
    for spec in (FaultSpec("wedge", at_dispatch=0, wedge_s=0.02),
                 FaultSpec("replica_wedge", replica=0, wedge_s=0.02)):
        t0 = time.monotonic()
        FaultPlan([spec]).on_dispatch(replica=0)
        assert time.monotonic() - t0 >= 0.02
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("meteor_strike")
    FaultSpec("corrupt_leaf")        # declarative kind, as in the reference


def _script(mod, specs, routes):
    """Drive ``mod``'s FaultPlan with ``specs`` over dispatches routed to
    ``routes``; the outcome of each dispatch."""
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs],
                         recorder=obs_recorder.FlightRecorder())
    out = []
    for r in routes:
        try:
            plan.on_dispatch(replica=r)
            out.append("ok")
        except mod.ShardLostError as e:
            out.append(("shard", e.shard))
        except mod.ReplicaLostError as e:
            out.append(("replica", e.replica))
    return out, plan.dispatches, len(plan.fired)


SCRIPTS = {
    "shard_once": ([{"kind": "shard_error", "shard": 2, "at_dispatch": 1}], [None] * 4),
    "replica_arms": ([{"kind": "replica_error", "replica": 1, "at_dispatch": 2}],
                     [1, 1, 0, 1, 1]),
    "mixed": ([{"kind": "shard_error", "shard": 0, "at_dispatch": 0},
               {"kind": "replica_error", "replica": 0, "at_dispatch": 0},
               {"kind": "shard_error", "shard": 3, "at_dispatch": 3}], [0, 0, 1, 1, 0]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_fault_plan_fires_as_the_reference(name):
    specs, routes = SCRIPTS[name]
    assert _script(fault, specs, routes) == _script(jax_fault, specs, routes)


def test_fault_plan_announces_to_the_port_recorder():
    rec = obs_recorder.FlightRecorder()
    obs_recorder.set_recorder(rec)
    try:
        plan = FaultPlan([FaultSpec("replica_error", replica=1)])
        with pytest.raises(ReplicaLostError):
            plan.on_dispatch(replica=1)
    finally:
        obs_recorder.set_recorder(None)
    (ev,) = rec.events("fault_injected")
    assert ev["fault_kind"] == "replica_error" and ev["replica"] == 1 and ev["at_dispatch"] == 0
    assert rec.faults == 1


HEALTH_OPS = [("record_failure", 0), ("record_failure", 0), ("record_failure", 0),
              ("mark_resynced", 0), ("record_success", 0), ("mark_dead", 1), ("mark_dead", 1),
              ("mark_resynced", 1), ("record_failure", 1), ("mark_resynced", 1),
              ("record_success", 1), ("record_failure", 2), ("record_success", 2),
              ("record_failure", 2), ("mark_resynced", 2)]


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_replica_health_steps_as_the_reference(threshold):
    """The same operations on both trackers: every return value and every
    replica's state after each step equal."""
    ours, ref = ReplicaHealth(3, threshold), jax_fault.ReplicaHealth(3, threshold)
    for op, r in HEALTH_OPS:
        assert getattr(ours, op)(r) == getattr(ref, op)(r), (op, r)
        assert [ours.state(i) for i in range(3)] == [ref.state(i) for i in range(3)]
        assert (ours.live(), ours.dead(), ours.half_open()) == (ref.live(), ref.dead(),
                                                                ref.half_open())


def test_replica_health_threshold_probe_and_validation():
    h = ReplicaHealth(2, fail_threshold=2)
    assert not h.record_failure(0) and h.record_failure(0)
    assert h.state(0) == ReplicaHealth.DEAD and h.live() == [1]
    h = ReplicaHealth(2, fail_threshold=1)
    assert h.mark_dead(1) and not h.mark_dead(1)
    h.mark_resynced(1)
    assert h.half_open() == [1] and h.live() == [0]
    h.record_success(1)
    assert h.state(1) == ReplicaHealth.LIVE
    with pytest.raises(ValueError):
        ReplicaHealth(0)
    with pytest.raises(ValueError):
        ReplicaHealth(2, fail_threshold=0)


def test_runtime_package_exports():
    assert set(port_runtime.__dict__) >= {"FaultPlan", "FaultSpec", "RetryPolicy",
                                           "ShardLostError", "Supervisor",
                                           "corrupt_checkpoint_leaf"}
