"""The port's IIIB on spectra-shaped data, where the superset lists are
uneven (a spectrum's peaks cluster around its precursor), held to the
benchmark's own float64 reference (``portbench/reference.py``) within the
limits of the ``yeastworm-iiib-join`` cell, cached and streaming; then
the ``iiib.scatter`` span's ``slots`` and ``entries`` and the
``iiib.list_fill`` reader against a count made here from the host
arrays, and the one host sync an R block with tracing on and off."""
import json
import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import datagen, reference  # noqa: E402
from portbench.run import load_module, reader_path  # noqa: E402
from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex  # noqa: E402
from repro_torch.obs import recorder, trace  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402

DIM, TILE, K = 2560, 128, 5            # 20 tiles
R_BLOCK, S_BLOCK = 32, 64
N_R, N_S = 48, 4 * S_BLOCK + 37        # two R blocks, five S blocks: both last ones partial
LIMITS = json.loads((ROOT / "portbench" / "limits" / "yeastworm-iiib-join.json").read_text())


@pytest.fixture(scope="module")
def spectra():
    """(R, S) host arrays ``(idx, val, nnz)`` from the benchmark's generator."""
    def draw(n, stream):
        return datagen.spectra(n, dim=DIM, peaks_mean=30, max_features=60,
                               seed=[2**31 + 5, stream])
    return draw(N_R, 0), draw(N_S, 1)


@pytest.fixture
def traced():
    """A fresh default recorder and tracing on; the process's state after."""
    saved = recorder.get_recorder(), trace.default_tracer().enabled
    recorder.set_recorder(recorder.FlightRecorder())
    trace.set_tracing(True)
    yield
    recorder.set_recorder(saved[0])
    trace.set_tracing(saved[1])


def _index(spectra, cached):
    _, (si, sv, sn) = spectra
    spec = JoinSpec(k=K, algorithm="iiib", tile=TILE, r_block=R_BLOCK, s_block=S_BLOCK)
    return SparseKNNIndex.build(from_arrays(si, sv, sn, DIM), spec, cache_device_blocks=cached,
                                device="cpu")


def _query(spectra, index, stats=None):
    (ri, rv, rn), _ = spectra
    return index.query(from_arrays(ri, rv, rn, DIM), stats=stats)


def _lengths_here(spectra):
    """(blocks, T) list length of each superset tile, counted here: the S
    rows of a block with any feature in the tile, dims ranked by S's own
    frequency (most frequent first, ties by dim)."""
    _, (si, _, _) = spectra
    freq = np.bincount(si[si < DIM], minlength=DIM)
    rank = np.empty(DIM, np.int64)
    rank[np.argsort(-freq, kind="stable")] = np.arange(DIM)
    t_total = DIM // TILE
    out = np.zeros((-(-N_S // S_BLOCK), t_total), np.int64)
    for s, row in enumerate(si):
        for t in np.unique(rank[row[row < DIM]] // TILE):
            out[s // S_BLOCK, t] += 1
    return out, rank


def _walked_here(spectra, rank):
    """The tiles each R block walks: those its rows touch, in ranked dims."""
    (ri, _, _), _ = spectra
    blocks = [ri[r0:r0 + R_BLOCK] for r0 in range(0, N_R, R_BLOCK)]
    return [np.unique(rank[b[b < DIM]] // TILE) for b in blocks]


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
def test_iiib_on_spectra_within_the_cells_limits(spectra, cached):
    """Every row's k answers against the float64 top-k: the numbers that
    decide the cell's ``correct``, each within its limit."""
    (ri, rv, _), (si, sv, _) = spectra
    res = _query(spectra, _index(spectra, cached))
    ids, scores = res.ids.numpy(), res.scores.numpy()
    ref_s, _ = reference.topk((ri, rv), (si, sv), K, DIM, "cpu")
    id_s = reference.pair_scores((ri, rv), (si, sv), ids, DIM, "cpu")
    got = reference.compare(ids, scores, ref_s, id_s, N_S)
    assert set(LIMITS) <= set(got)
    assert all(got[n] <= lim for n, lim in LIMITS.items()), got
    assert (ids >= 0).all() and np.isfinite(scores).all()


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
def test_scatter_span_counts_slots_and_entries(spectra, traced, cached):
    """One ``iiib.scatter`` span an (R block, S block) pair: ``slots`` the
    tiles walked times the list width M, ``entries`` the real list entries
    of those tiles, both as counted here from the host arrays and equal to
    the device index's own counts; ``iiib.list_fill`` is their ratio."""
    index = _index(spectra, cached)
    _query(spectra, index)
    lengths, rank = _lengths_here(spectra)
    walked = _walked_here(spectra, rank)
    n_blocks = lengths.shape[0]
    # M: the stack's common width, or each streamed block's own bound
    widths = ([index._iib_stack.max_rows] * n_blocks if cached
              else [blk.bound for blk in index._blocks])
    assert np.array_equal(index._rank_np, rank)
    spans = [e for e in recorder.get_recorder().events("span") if e["name"] == "iiib.scatter"]
    assert len(spans) == len(walked) * n_blocks
    for j, e in enumerate(spans):
        tiles, b = walked[j // n_blocks], j % n_blocks
        assert e["attrs"]["tiles"] == len(tiles)
        assert e["attrs"]["slots"] == len(tiles) * widths[b]
        assert e["attrs"]["entries"] == int(lengths[b, tiles].sum())
        if cached:
            assert e["attrs"]["entries"] == int(index._iib_stack.counts[b, tiles].sum())
    entries = sum(int(lengths[:, t].sum()) for t in walked)
    slots = sum(len(t) * sum(widths) for t in walked)
    assert 0 < entries < slots
    fill = load_module(reader_path("iiib.list_fill")).read(types.SimpleNamespace(spans=spans))
    assert fill == pytest.approx(100.0 * entries / slots, rel=1e-12)


@pytest.mark.parametrize("tracing", [True, False], ids=["tracing_on", "tracing_off"])
def test_one_host_sync_an_r_block(spectra, traced, tracing):
    """The counts come from the build's host copy: a cached query syncs once
    an R block whether tracing is on or off, and off records no span."""
    index = _index(spectra, True)
    trace.set_tracing(tracing)
    stats = JoinStats()
    _query(spectra, index, stats)
    assert stats.host_syncs == -(-N_R // R_BLOCK)
    spans = recorder.get_recorder().events("span")
    assert bool(spans) == tracing
