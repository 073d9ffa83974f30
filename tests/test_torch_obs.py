"""The port's observability copies (src/repro_torch/obs: registry, trace,
recorder) against the JAX package's ``repro.obs`` on one scripted
sequence: the same exposition text and parse, the same span tree, the
same recorder dump and summary (timestamps and span ids aside, which are
clocks and a process counter).  Then the engine's instruments: one
``engine.r_block`` span per R block under the caller's span, and an IIIB
query through the port filling ``knn_min_prune_threshold`` with the JAX
engine's bucket counts (sums within rtol=1e-5).  Last, the port's own
spans: the three phases that tile each R block on every path, IIIB's
``iiib.scatter`` tile counts, nothing made with tracing off, and
``trace.profiler_ns`` against ``torch.profiler``'s clock.  The card's
``device_ms`` is held in ``tests/test_torch_cuda.py``."""
import json
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jax_obs  # noqa: E402
from repro.core.engine import JoinSpec as JaxSpec  # noqa: E402
from repro.core.engine import SparseKNNIndex as JaxIndex  # noqa: E402
from repro.obs import recorder as jax_recorder  # noqa: E402
from repro.obs import registry as jax_registry  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.engine import JoinSpec, SparseKNNIndex  # noqa: E402
from repro_torch.obs import recorder, registry, trace  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402


def _port(batch):
    return from_arrays(np.asarray(batch.indices), np.asarray(batch.values),
                       np.asarray(batch.nnz), batch.dim)


def _script_registry(mod):
    """One scripted use of a registry module; returns (registry, text)."""
    reg = mod.MetricRegistry()
    c = reg.counter("requests", "requests served")
    c.inc()
    c.inc(4)
    g = reg.gauge("queue_depth", "waiting requests")
    g.set(7)
    g.dec(2)
    g.inc(0.5)
    h = reg.histogram("latency_s", "request latency")
    for v in (0.0001, 0.003, 0.003, 0.2, 12.0, float("-inf"), float("nan"), 0.05):
        h.observe(v)
    h2 = reg.histogram("thr", buckets=(1.0, 0.1, 0.5))
    for v in (0.0, 0.1, 0.3, 2.0):
        h2.observe(v)
    box = {"n": 3}
    reg.bind("bound_gauge", lambda: box["n"], help="a bound value")
    reg.bind("bound_total", lambda: 2.5, kind="counter")
    box["n"] = 9
    assert reg.counter("requests") is c
    with pytest.raises(ValueError):
        reg.gauge("requests")
    with pytest.raises(ValueError):
        mod.Counter("bad name")
    return reg, reg.expose()


def test_registry_exposition_equals_reference():
    reg, text = _script_registry(registry)
    jreg, jtext = _script_registry(jax_registry)
    assert text == jtext
    assert registry.parse_exposition(text) == jax_registry.parse_exposition(jtext)
    assert reg.collect() == jreg.collect()
    assert reg.names() == jreg.names()
    with pytest.raises(ValueError):
        registry.parse_exposition(text.replace("# EOF\n", ""))


def test_default_registry_swaps_as_reference():
    old = registry.get_registry()
    try:
        fresh = registry.MetricRegistry()
        registry.set_registry(fresh)
        assert registry.get_registry() is fresh
        registry.set_registry(None)
        assert registry.get_registry() is not fresh
    finally:
        registry.set_registry(old)


def _script_trace(trace_mod, recorder_mod, path):
    """Spans (nested, attached across a 'thread', an error), fault events
    and a dump; returns (recorder, dump lines)."""
    rec = recorder_mod.FlightRecorder(capacity=8)
    tracer = trace_mod.Tracer(recorder=rec)
    with tracer.span("request", rid=1) as req:
        with tracer.span("batch", size=2):
            s = trace_mod.start_span("engine.r_block", r0=0, algorithm="iiib")
            trace_mod.end_span(s)
        leaf = tracer.begin("store.dispatch", shard=3)
        tracer.end(leaf, ok=True)
        tracer.end(leaf)                          # idempotent
    with tracer.attach(req):
        with tracer.span("resync"):
            pass
    with pytest.raises(RuntimeError):
        with tracer.span("checkpoint"):
            raise RuntimeError("disk")
    off = trace_mod.Tracer(recorder=rec, enabled=False)
    with off.span("ignored") as none_span:
        assert none_span is None
    rec.record("note", where="test")
    rec.fault("shard_lost", shard=1)
    for i in range(6):                            # past capacity: eviction
        rec.record("tick", i=i)
    rec.dump(str(path))
    return rec, path.read_text().splitlines()


def _normalised(lines):
    """Dump events without clock fields, span ids as first-seen order."""
    ids, out = {}, []
    for line in lines:
        ev = json.loads(line)
        for key in ("t_wall", "t_mono", "t_start", "t_end", "dur_ms"):
            ev.pop(key, None)
        for key in ("span_id", "parent_id"):
            if ev.get(key) is not None:
                ev[key] = ids.setdefault(ev[key], len(ids))
        out.append(ev)
    return out


def test_trace_and_recorder_equal_reference(tmp_path):
    rec, lines = _script_trace(trace, recorder, tmp_path / "port.jsonl")
    jrec, jlines = _script_trace(jax_trace, jax_recorder, tmp_path / "jax.jsonl")
    assert _normalised(lines) == _normalised(jlines)
    assert rec.summary() == jrec.summary()
    assert [e["kind"] for e in rec.events()] == [e["kind"] for e in jrec.events()]
    assert len(rec.events("tick")) == len(jrec.events("tick"))
    spans = [e for e in rec.events("span")]
    assert all(e["dur_ms"] is not None and e["dur_ms"] >= 0 for e in spans)
    with pytest.raises(ValueError):
        recorder.FlightRecorder(capacity=0)
    with pytest.raises(ValueError):
        recorder.FlightRecorder().dump()


def test_package_exports_the_reference_names_but_profile():
    # profile's HLO report has no counterpart (the port compiles no program)
    want = set(jax_obs.__all__) - {"compiled_report"}
    assert set(obs.__all__) == want


@pytest.fixture
def fresh_obs():
    """A fresh process registry and default recorder for both packages."""
    saved = (registry.get_registry(), recorder.get_recorder(),
             jax_registry.get_registry(), jax_recorder.get_recorder())
    registry.set_registry(registry.MetricRegistry())
    recorder.set_recorder(recorder.FlightRecorder())
    jax_registry.set_registry(jax_registry.MetricRegistry())
    jax_recorder.set_recorder(jax_recorder.FlightRecorder())
    yield
    registry.set_registry(saved[0])
    recorder.set_recorder(saved[1])
    jax_registry.set_registry(saved[2])
    jax_recorder.set_recorder(saved[3])


@pytest.mark.parametrize("cached", [True, False])
def test_engine_r_block_spans_under_the_callers_span(small_rs, fresh_obs, cached):
    """One ``engine.r_block`` span per R block, each a child of the span
    active on the caller's thread, with the reference's attributes."""
    R, S = small_rs
    spec = dict(k=5, algorithm="iiib", r_block=20, s_block=32)
    index = SparseKNNIndex.build(_port(S), JoinSpec(**spec), cache_device_blocks=cached,
                                 device="cpu")
    tracer = trace.Tracer()
    with tracer.span("request") as req:
        index.query(_port(R))
    jindex = JaxIndex.build(S, JaxSpec(**spec), cache_device_blocks=cached)
    jtracer = jax_trace.Tracer()
    with jtracer.span("request"):
        jindex.query(R)
    got = [e for e in recorder.get_recorder().events("span") if e["name"] == "engine.r_block"]
    want = [e for e in jax_recorder.get_recorder().events("span")
            if e["name"] == "engine.r_block"]
    assert [e["attrs"] for e in got] == [e["attrs"] for e in want] == [
        {"r0": r0, "algorithm": "iiib"} for r0 in (0, 20, 40)]
    assert {e["parent_id"] for e in got} == {req.span_id}


def test_tracing_off_records_no_span(small_rs, fresh_obs):
    R, S = small_rs
    index = SparseKNNIndex.build(_port(S), JoinSpec(k=5, algorithm="bf", r_block=24),
                                 device="cpu")
    trace.set_tracing(False)
    try:
        index.query(_port(R))
    finally:
        trace.set_tracing(True)
    assert recorder.get_recorder().events("span") == []


@pytest.mark.parametrize("warm_start", [0.0, 0.2])
def test_iiib_threshold_histogram_equals_jax_engine(small_rs, fresh_obs, warm_start):
    """An IIIB query feeds every R block's MinPruneScore trace into the
    process registry's ``knn_min_prune_threshold``: the JAX engine's bucket
    counts and observation count, its sum within rtol=1e-5; streaming
    mode records none, as in the reference."""
    R, S = small_rs
    spec = dict(k=5, algorithm="iiib", r_block=20, s_block=20, warm_start=warm_start)
    for cached in (True, False):
        SparseKNNIndex.build(_port(S), JoinSpec(**spec), cache_device_blocks=cached,
                             device="cpu").query(_port(R))
        JaxIndex.build(S, JaxSpec(**spec), cache_device_blocks=cached).query(R)
    h = registry.get_registry().get("knn_min_prune_threshold")
    jh = jax_registry.get_registry().get("knn_min_prune_threshold")
    assert h.buckets == jh.buckets
    assert h.counts == jh.counts and h.count == jh.count > 0
    assert math.isclose(h.sum, jh.sum, rel_tol=1e-5)
    text = registry.get_registry().expose()
    assert "knn_min_prune_threshold_bucket" in text and text.endswith("# EOF\n")


# the phases of an R block, in the order they tile it
PHASES = ("engine.prep", "engine.launch", "engine.pull")
# the query paths: (algorithm, use_kernel, cached)
PATHS = [("bf", False, True), ("iib", False, True), ("iiib", False, True),
         ("iib", True, True), ("iiib", False, False)]


def _spans(name=None):
    evs = recorder.get_recorder().events("span")
    return [e for e in evs if name is None or e["name"] == name]


@pytest.mark.parametrize("algorithm,use_kernel,cached", PATHS)
def test_r_block_phases_tile_each_block_in_order(small_rs, fresh_obs, monkeypatch, algorithm,
                                                  use_kernel, cached):
    """Each R block's ``engine.r_block`` span has one ``engine.prep``,
    ``engine.launch`` and ``engine.pull`` child, which follow each other
    inside it; the padding falls under the prep (slowed here by 5 ms)."""
    import repro_torch.core.engine as engine

    R, S = small_rs
    spec = JoinSpec(k=5, algorithm=algorithm, use_kernel=use_kernel, r_block=20, s_block=32)
    index = SparseKNNIndex.build(_port(S), spec, cache_device_blocks=cached, device="cpu")
    pad = engine._pad_rows_np

    def slow_pad(*a, **kw):
        time.sleep(5e-3)
        return pad(*a, **kw)

    monkeypatch.setattr(engine, "_pad_rows_np", slow_pad)
    index.query(_port(R))
    blocks = _spans("engine.r_block")
    assert [b["attrs"]["r0"] for b in blocks] == [0, 20, 40]
    children = {}
    for e in _spans():
        if e["name"] in PHASES:
            children.setdefault(e["parent_id"], []).append(e)
    assert set(children) == {b["span_id"] for b in blocks}
    for b in blocks:
        kids = sorted(children[b["span_id"]], key=lambda e: e["t_start"])
        assert [e["name"] for e in kids] == list(PHASES)
        edges = [b["t_start"]] + [t for e in kids for t in (e["t_start"], e["t_end"])]
        edges.append(b["t_end"])
        assert edges == sorted(edges)
        assert kids[0]["dur_ms"] >= 5.0
        assert "device_ms" not in b["attrs"]                # no CUDA events on the CPU


@pytest.mark.parametrize("cached", [True, False])
def test_iiib_scatter_spans_count_the_active_tiles(small_rs, fresh_obs, cached):
    """One ``iiib.scatter`` span per S block under each ``engine.launch``,
    its ``tiles`` the tiles the R block touches in the index's permuted dim
    space, counted here from R's own indices."""
    R, S = small_rs
    rb, tile = 20, 128
    index = SparseKNNIndex.build(
        _port(S), JoinSpec(k=5, algorithm="iiib", r_block=rb, s_block=32, tile=tile),
        cache_device_blocks=cached, device="cpu")
    index.query(_port(R))
    r_idx = np.asarray(R.indices)
    launches = _spans("engine.launch")
    scatters = _spans("iiib.scatter")
    assert len(launches) == 3 and len(scatters) == 3 * index.num_blocks
    for i, launch in enumerate(launches):
        dims = r_idx[i * rb:(i + 1) * rb]
        dims = dims[dims < R.dim]
        want = np.unique(index._rank_np[dims] // tile).size
        mine = [e for e in scatters if e["parent_id"] == launch["span_id"]]
        assert [e["attrs"]["tiles"] for e in mine] == [want] * index.num_blocks
        assert all(launch["t_start"] <= e["t_start"] <= e["t_end"] <= launch["t_end"]
                   for e in mine)


class _NoEvent:
    """Stands in for ``torch.cuda.Event``: counts what the engine makes."""

    made = 0

    def __init__(self, *a, **kw):
        type(self).made += 1


@pytest.mark.parametrize("algorithm", ["bf", "iib", "iiib"])
def test_tracing_off_no_span_no_event_and_one_sync_a_block(small_rs, fresh_obs, monkeypatch,
                                                          algorithm):
    """Tracing off: no span (the phases and IIIB's scatter included), no
    timing event, and ``host_syncs`` one per R block, as with tracing on."""
    from repro_torch.core.engine import JoinStats

    R, S = small_rs
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    _NoEvent.made = 0
    index = SparseKNNIndex.build(_port(S), JoinSpec(k=5, algorithm=algorithm, r_block=20,
                                                    s_block=32), device="cpu")
    syncs = []
    for on in (False, True):
        trace.set_tracing(on)
        try:
            stats = JoinStats()
            index.query(_port(R), stats=stats)
        finally:
            trace.set_tracing(True)
        syncs.append(stats.host_syncs)
        if not on:
            assert _spans() == []
    assert syncs == [3, 3]
    assert _NoEvent.made == 0
    assert not any("device_ms" in e["attrs"] for e in _spans())


def test_profiler_ns_puts_profiled_ops_inside_their_span():
    """A span mapped onto the profiler's clock holds the kineto interval of
    every op run inside it (``start_ns()``, ``duration_ns()``, read as
    ``portbench/devtrace.py`` reads them), within 50 us; an op run after it
    falls outside."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    assert abs(trace.profiler_ns(time.monotonic()) - time.time_ns()) < 1_000_000
    tracer = trace.Tracer(recorder=recorder.FlightRecorder())
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("work") as s:
            for _ in range(3):
                a = torch.tanh(a @ a)
        after = trace.profiler_ns(tracer.begin("after").t_start)
        torch.relu(a)
    lo, hi = trace.profiler_ns(s.t_start), trace.profiler_ns(s.t_end)
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() != DeviceType.CUDA]
    # on kineto's own clock: the relu and its children came after the span
    t_relu = min(st for name, st, _ in ops if name == "aten::relu")
    inside = [o for o in ops if o[1] < t_relu]
    later = [o for o in ops if o[1] >= t_relu]
    assert len(inside) >= 6 and any(o[0] == "aten::mm" for o in inside)
    slack = 50_000
    assert all(lo - slack <= st and en <= hi + slack for _, st, en in inside), (lo, hi, inside)
    assert all(st >= after - slack for _, st, _ in later), (after, later)


def test_a_failed_launch_ends_its_span_with_the_error(small_rs, fresh_obs, monkeypatch):
    """A driver that raises inside ``engine.launch`` leaves the span ended
    with ``error`` recorded and the thread's context back at the caller's
    span, so later spans do not parent under the failed launch."""
    R, S = small_rs
    index = SparseKNNIndex.build(_port(S), JoinSpec(k=5, algorithm="bf", r_block=20,
                                                    s_block=32), device="cpu")

    def fail(*a, **kw):
        raise RuntimeError("driver down")

    monkeypatch.setattr(index, "_query_bf_scanned", fail)
    with trace.span("request") as req:
        with pytest.raises(RuntimeError, match="driver down"):
            index.query(_port(R))
        assert trace.current_span() is req
    (launch,) = _spans("engine.launch")
    assert launch["attrs"]["error"] == "RuntimeError: driver down"
    assert launch["t_end"] is not None and _spans("engine.pull") == []
