"""Shared test helpers: the benchmark's cells at a size a CPU test holds."""
from __future__ import annotations

import pathlib

from portbench.run import load_json

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = load_json(ROOT / "BENCHMARK.json")

SMALL = {
    "synthetic-10k": dict(n_r=300, n_s=600, dim=2000, k=5, tile=128, r_block=128, s_block=128,
                          generator={"kind": "synthetic", "nnz_mean": 40, "nnz_std": 10, "max_features": 96}),
    "yeast-worm": dict(n_r=300, n_s=1000, dim=2000, k=5, tile=128, r_block=128, s_block=128,
                       generator={"kind": "spectra", "peaks_mean": 30, "max_features": 60}),
}
CELLS = [w["name"] for w in BENCH["workloads"]]
SECONDS = {"open_loop_serve": 1.5}


def small_config(cell: str) -> dict:
    return SMALL[{w["name"]: w["config"] for w in BENCH["workloads"]}[cell]]


def seconds_for(cell: str) -> float:
    traffic = {w["name"]: w["traffic"] for w in BENCH["workloads"]}[cell]
    kind = load_json(ROOT / "portbench" / "traffic" / f"{traffic}.json")["kind"]
    return SECONDS.get(kind, 0.3)
