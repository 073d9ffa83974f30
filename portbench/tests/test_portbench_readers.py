"""The readers of the program's phase spans, IIIB's scatter span and the
worker wait (``metrics/engine.prep_ms.py``, ``engine.launch_ms.py``,
``engine.device_ms.py``, ``serve.worker_wait_ms.py``, ``engine.pull_ms.py``,
``iiib.scatter_us_per_tile.py``): on spans made up here, on a program
without those spans, and in a traced run of each cell on the CPU."""
import types

import pytest

from portbench.run import load_module, reader_path, run_cell
from portbench.tests.small import BENCH, CELLS, seconds_for, small_config

NEW = ("engine.prep_ms.join", "engine.launch_ms.join", "engine.device_ms.join",
       "serve.worker_wait_ms", "engine.pull_ms.join", "iiib.scatter_us_per_tile")
JOIN_PHASES = ("engine.prep_ms.join", "engine.launch_ms.join", "engine.pull_ms.join")
JOIN_CELLS = [c for c in CELLS if not c.endswith("-serve")]


def _span(name, dur_ms, **attrs):
    return {"name": name, "dur_ms": dur_ms, "attrs": attrs, "t_start": 0.0}


def _read(metric, spans):
    return load_module(reader_path(metric)).read(types.SimpleNamespace(spans=spans))


SPANS = [
    _span("engine.r_block", 10.0, device_ms=6.0), _span("engine.r_block", 20.0, device_ms=8.0),
    _span("engine.prep", 3.0), _span("engine.prep", 5.0),
    _span("engine.launch", 1.0), _span("engine.launch", 2.0),
    _span("engine.pull", 6.0), _span("serve.worker_wait", 100.0),
    _span("serve.worker_wait", 300.0), _span("serve.worker_wait", None),
    _span("iiib.scatter", 1.5, tiles=10), _span("iiib.scatter", 2.5, tiles=30),
    _span("iiib.scatter", None, tiles=50),
]


@pytest.mark.parametrize("metric,want", [("engine.prep_ms.join", 4.0),
                                         ("engine.launch_ms.join", 1.5),
                                         ("engine.device_ms.join", 7.0),
                                         ("serve.worker_wait_ms", 200.0),
                                         ("engine.pull_ms.join", 6.0),
                                         ("iiib.scatter_us_per_tile", 100.0)])
def test_reader_means_its_spans(metric, want):
    assert _read(metric, SPANS) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW)
def test_reader_finds_nothing_without_its_spans(metric):
    # the program before these spans: one engine.r_block span, no device_ms
    assert _read(metric, [_span("engine.r_block", 10.0, r0=0, algorithm="bf")]) is None


def test_the_new_entries_and_their_readers():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"][-len(NEW):]] == list(NEW)
    for name in JOIN_PHASES + ("engine.device_ms.join",):
        assert per[name]["workloads"] == JOIN_CELLS and per[name]["moves"] == "join_rows_per_s"
    assert per["serve.worker_wait_ms"]["workloads"] == ["yeastworm-bf-serve"]
    assert per["iiib.scatter_us_per_tile"]["workloads"] == ["synth10k-iiib-join"]
    assert [per[n]["layer"] for n in NEW] == ["join entry", "drivers", "drivers",
                                               "serving front end", "join entry", "drivers"]
    assert reader_path("engine.device_ms.join").name == "engine.device_ms.py"
    assert reader_path("engine.pull_ms.join").name == "engine.pull_ms.py"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_cpu_reads_the_new_spans(cell):
    result, _ = run_cell(BENCH, cell, 2**31 + 77, seconds_for(cell), True, "cpu",
                         config=small_config(cell))
    got = set(result["metrics"]) & set(NEW)
    # the CPU makes no CUDA event: device_ms is left out
    want = {"serve.worker_wait_ms"} if cell.endswith("-serve") else set(JOIN_PHASES)
    if cell == "synth10k-iiib-join":
        want.add("iiib.scatter_us_per_tile")
    assert got == want, result["metrics"]
    assert all(result["metrics"][n]["value"] >= 0 for n in got)
