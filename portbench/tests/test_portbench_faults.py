"""A run with its timed path broken underneath comes out not correct.

Each cell runs here on the CPU at a small size (the program's plain
kernels), through the harness's own path from set-up to the comparison;
only the look for a chip is skipped.  Faults, planted in the program:

* ``unchanged`` — a step returns its state unchanged (a driver's merge,
  or the fused kernel, hands back the state it was given);
* ``half`` — half of each batch left out: every other row keeps the
  empty state (a served batch's real rows are its first few);
* ``altered`` — one answer altered where it is produced: the first row's
  best id of every R block is another row's.

The exchange between chips has no fault to plant: every cell runs on one
chip.
"""
import pytest
import torch

from portbench.run import run_cell
from portbench.tests.small import BENCH, CELLS, seconds_for, small_config

SEED = 2**31 + 101


def _plant(monkeypatch, fault):
    import repro_torch.core.bf as bf
    import repro_torch.core.engine as engine
    import repro_torch.core.iiib as iiib

    if fault == "unchanged":
        monkeypatch.setattr(bf, "merge_step", lambda state, scores, ids: state)
        monkeypatch.setattr(iiib, "merge_step", lambda state, scores, ids: state)
        monkeypatch.setattr(engine, "join_topk", lambda *a, **kw: (a[5].clone(), a[6].clone()))
        return
    query = engine.SparseKNNIndex.query

    def broken(self, R, *a, **kw):
        res = query(self, R, *a, **kw)
        rb = self.spec.r_block
        rows = torch.arange(res.ids.shape[0], device=res.ids.device)
        if fault == "half":
            gone = rows % 2 == 1
            res.ids[gone] = -1
            res.scores[gone] = float("-inf")
        else:
            first = (rows % rb) == 0
            res.ids[first, 0] = (res.ids[first, 0] + 1) % self.n_s
        return res

    monkeypatch.setattr(engine.SparseKNNIndex, "query", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, lines = run_cell(BENCH, cell, SEED, seconds_for(cell), False, "cpu",
                             config=small_config(cell))
    assert result["correct"] is True, lines
    assert list(result)[-1] == "checks" and result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "device_peak_gib"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    _plant(monkeypatch, fault)
    result, lines = run_cell(BENCH, cell, SEED, seconds_for(cell), False, "cpu",
                             config=small_config(cell))
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_layers(cell):
    result, _ = run_cell(BENCH, cell, SEED + 1, seconds_for(cell), True, "cpu",
                         config=small_config(cell))
    names = {m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])}
    got = set(result["metrics"])
    assert got <= names and got, got
    # the CPU has no device trace: the readers of device time find nothing
    assert not any(n.startswith("device_idle_share") for n in got)
