"""The reader of IIIB's list fill (``metrics/iiib.list_fill.py``): on spans
made up here, on a program whose spans lack the counts, and in a traced
run of each IIIB cell on the CPU."""
import types

import pytest

from portbench.run import load_module, reader_path, run_cell
from portbench.tests.small import BENCH, seconds_for, small_config

IIIB_CELLS = ["synth10k-iiib-join", "yeastworm-iiib-join"]


def _span(name, **attrs):
    return {"name": name, "dur_ms": 1.0, "attrs": attrs, "t_start": 0.0}


def _read(spans):
    return load_module(reader_path("iiib.list_fill")).read(types.SimpleNamespace(spans=spans))


def test_list_fill_sums_entries_over_slots():
    spans = [_span("iiib.scatter", tiles=2, slots=256, entries=64),
             _span("iiib.scatter", tiles=6, slots=768, entries=448),
             _span("iiib.scatter", tiles=4, slots=512),      # no host lengths: left out
             _span("engine.r_block", slots=1000, entries=1000)]
    assert _read(spans) == pytest.approx(100.0 * 512 / 1024)


@pytest.mark.parametrize("spans", [[], [_span("iiib.scatter", tiles=79)],
                                   [_span("iiib.scatter", tiles=79, slots=141568)]],
                         ids=["no_span", "parent_span", "no_lengths"])
def test_list_fill_finds_nothing_without_its_counts(spans):
    assert _read(spans) is None


def test_list_fill_entry():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    m = per["iiib.list_fill"]
    assert m["workloads"] == IIIB_CELLS and m["moves"] == "join_rows_per_s"
    assert (m["unit"], m["better"], m["source"], m["layer"]) == ("%", "higher", "program_span",
                                                                 "drivers")


@pytest.mark.parametrize("cell", IIIB_CELLS)
def test_traced_run_on_the_cpu_reads_the_list_fill(cell):
    result, _ = run_cell(BENCH, cell, 2**31 + 79, seconds_for(cell), True, "cpu",
                         config=small_config(cell))
    assert 0 < result["metrics"]["iiib.list_fill"]["value"] < 100
