"""BENCHMARK.json against the benchmark's contract, and its files."""
import re

import pytest

from portbench.run import load_json, reader_path
from portbench.tests.small import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = ROOT / "portbench"


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and len(BENCH["command"]) <= 32
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits into 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in _metrics()] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in _metrics()}) == len(_metrics())
    assert all(UNIT.match(m["unit"]) for m in _metrics())
    assert all(m["better"] in ("lower", "higher") for m in _metrics())
    texts = [w["why"] for w in BENCH["workloads"] + BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in _cells_of(m)]
        per = [m["name"] for m in BENCH["per_layer"] if w["name"] in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per, w["name"]
        assert w["chips"] == 1


def test_moves_names_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: set(_cells_of(m)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(_cells_of(m)) <= e2e[m["moves"]], m["name"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        cfg = load_json(ROOT / c["file"])
        assert c["file"].startswith("portbench/") and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        mix = load_json(PB / "traffic" / f"{w['traffic']}.json")
        assert (PB / "traffic" / f"{mix['kind']}.py").exists()
        assert (PB / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["per_layer"]:
        assert reader_path(m["name"]).exists(), m["name"]
    # every reader is some metric's
    read = {reader_path(m["name"]).name for m in BENCH["per_layer"]}
    assert read == {p.name for p in (PB / "metrics").glob("*.py")}


def test_a_variant_without_a_file_is_read_by_its_base():
    assert reader_path("engine.r_block_ms.serve") == PB / "metrics" / "engine.r_block_ms.py"
    assert reader_path("device_idle_share.join") == PB / "metrics" / "device_idle_share.py"
    assert reader_path("iiib.kept_share") == PB / "metrics" / "iiib.kept_share.py"
    assert not reader_path("no_such_metric.join").exists()
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


@pytest.mark.parametrize("path", sorted(p for p in PB.rglob("*") if p.is_file()
                                        and "__pycache__" not in p.parts))
def test_file_names_use_name_characters(path):
    rel = path.relative_to(ROOT).as_posix()
    assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
