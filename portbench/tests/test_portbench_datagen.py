"""The benchmark's bulk generators draw the program's distributions."""
import numpy as np
import pytest

from portbench import datagen
from repro_torch.sparse import datagen as program_datagen


def _valid(idx, val, nnz, dim):
    live = idx < dim
    assert (live.sum(1) == nnz).all()
    assert (np.diff(idx, axis=1)[live[:, 1:]] > 0).all()       # ascending, distinct
    assert (val[~live] == 0).all() and (val[live] > 0).all()


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 11])
def test_synthetic_matches_the_programs_distribution(seed):
    idx, val, nnz = datagen.synthetic(3000, 10_000, 120, 30, 288, seed)
    assert idx.shape == (3000, nnz.max()) and nnz.max() < 288    # as wide as its widest row
    _valid(idx, val, nnz, 10_000)
    prog = program_datagen.synthetic_sparse(3000, seed=seed % 2**32)
    p_nnz = prog.nnz.numpy()
    assert abs(nnz.mean() - p_nnz.mean()) < 3.0 and abs(nnz.std() - p_nnz.std()) < 3.0
    v = val[idx < 10_000]
    assert 1e-3 <= v.min() and v.max() < 1.0 and abs(v.mean() - 0.5) < 0.01
    cols = np.bincount(idx[idx < 10_000], minlength=10_000)
    assert cols.std() / cols.mean() < 0.35                     # uniform positions


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11])
def test_spectra_matches_the_programs_distribution(seed):
    idx, val, nnz = datagen.spectra(3000, 20_000, 80, 160, seed)
    # as wide as the most peaks drawn for a spectrum: binning merges a few
    assert idx.shape[0] == 3000 and 0 <= idx.shape[1] - nnz.max() <= 0.1 * idx.shape[1] < 16
    _valid(idx, val, nnz, 20_000)
    prog = program_datagen.spectra_like(3000, seed=seed % 2**32)
    p_nnz = prog.nnz.numpy()
    assert abs(nnz.mean() - p_nnz.mean()) < 1.5 and abs(nnz.std() - p_nnz.std()) < 1.5
    assert np.allclose(val.max(1), 1.0)
    p_live = prog.indices.numpy()[prog.indices.numpy() < 20_000]
    assert abs(idx[idx < 20_000].mean() - p_live.mean()) < 200
    assert abs(idx[idx < 20_000].std() - p_live.std()) < 200


def test_inputs_are_a_function_of_the_seed():
    cfg = {"n_r": 50, "n_s": 70, "dim": 500,
           "generator": {"kind": "synthetic", "nnz_mean": 20, "nnz_std": 5, "max_features": 40}}
    (ra, sa), (rb, sb) = datagen.inputs(cfg, 2**31 + 5), datagen.inputs(cfg, 2**31 + 5)
    for x, y in zip(ra + sa, rb + sb):
        assert np.array_equal(x, y)
    rc, _ = datagen.inputs(cfg, 2**31 + 6)
    assert not np.array_equal(ra[0], rc[0]) and not np.array_equal(ra[0], sa[0][:50])
    assert ra[0].shape[0] == 50 and sa[0].shape[0] == 70


@pytest.mark.parametrize("kind", ["synthetic", "spectra"])
def test_every_seed_draws_the_same_sizes_in_its_own_order(kind):
    cfg = {"n_r": 400, "n_s": 900, "dim": 3000,
           "generator": {"kind": kind, "nnz_mean": 60, "nnz_std": 15, "max_features": 200}
           if kind == "synthetic" else {"kind": kind, "peaks_mean": 40, "max_features": 200}}
    (ra, sa), (rb, sb) = datagen.inputs(cfg, 2**31 + 5), datagen.inputs(cfg, 17)
    assert ra[0].shape == rb[0].shape and sa[0].shape == sb[0].shape
    assert not np.array_equal(ra[2], rb[2])                        # another order
    if kind == "synthetic":                                        # the same sizes
        assert np.array_equal(np.sort(ra[2]), np.sort(rb[2]))
        assert ra[0].shape[1] == ra[2].max() and sa[0].shape[1] == sa[2].max()
    else:                                                          # up to binning
        assert abs(int(ra[2].sum()) - int(rb[2].sum())) < 0.01 * ra[2].sum()
        assert ra[0].shape[1] - ra[2].max() <= 0.1 * ra[0].shape[1]


def test_rows_past_the_width_keep_their_lowest_columns():
    idx, val, nnz = datagen.synthetic(500, 1000, 60, 10, 50, 3)
    assert idx.shape == (500, 50) and nnz.max() == 50 and (nnz >= 1).all()
    idx, val, nnz = datagen.spectra(500, 1000, 80, 20, 3)     # ~60 distinct bins a row
    assert idx.shape == (500, 20) and (nnz == 20).mean() > 0.9
    _valid(idx, val, nnz, 1000)
