"""The port's sparse format and tile plumbing (src/repro_torch) against the
JAX package's, byte for byte, on the same seeded inputs; and the port's
import boundary."""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.knn_score.ops import active_lists as jax_active_lists  # noqa: E402
from repro.kernels.knn_score.ops import dense_tiles_with_sentinel as jax_dense_tiles  # noqa: E402
from repro.sparse import format as jax_format  # noqa: E402
from repro.sparse.datagen import spectra_like as jax_spectra  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import SparseBatch as JaxBatch  # noqa: E402
from repro.sparse.format import tile_occupancy as jax_occupancy  # noqa: E402
from repro_torch.core.index import dense_r_tiles  # noqa: E402
from repro_torch.kernels.knn_score.ops import active_lists, dense_tiles_with_sentinel  # noqa: E402
from repro_torch.sparse.datagen import spectra_like, synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import (  # noqa: E402
    SparseBatch,
    dim_frequency,
    frequency_permutation,
    from_arrays,
    max_weight_per_dim,
    num_tiles,
    reorder_dims,
    tile_occupancy,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [  # num_vectors, dim, nnz_mean, nnz_std, seed
    (48, 512, 20, 5, 0),
    (70, 640, 15, 4, 160),
    (33, 1000, 40, 10, 7),
]


def _same(port: SparseBatch, ref: JaxBatch):
    assert port.dim == ref.dim
    for name in ("indices", "values", "nnz"):
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("n,dim,nnz,std,seed", SHAPES)
def test_synthetic_sparse_byte_identical(n, dim, nnz, std, seed):
    _same(synthetic_sparse(n, dim=dim, nnz_mean=nnz, nnz_std=std, seed=seed),
          jax_synthetic(n, dim=dim, nnz_mean=nnz, nnz_std=std, seed=seed))


def test_synthetic_sparse_max_features_cut():
    _same(synthetic_sparse(40, dim=300, nnz_mean=30, seed=3, max_features=16),
          jax_synthetic(40, dim=300, nnz_mean=30, seed=3, max_features=16))


def test_from_coo_matches_reference():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 12, size=60)
    cols = rng.integers(0, 200, size=60)
    keep = np.unique(rows * 1000 + cols, return_index=True)[1]   # no duplicate (row, dim)
    rows, cols = rows[keep], cols[keep]
    vals = rng.random(rows.size).astype(np.float32)
    _same(SparseBatch.from_coo(rows, cols, vals, 12, 200, max_features=7),
          JaxBatch.from_coo(rows, cols, vals, 12, 200, max_features=7))


def test_from_arrays_carries_reference_batch():
    ref = jax_synthetic(20, dim=256, nnz_mean=10, seed=2)
    port = from_arrays(np.asarray(ref.indices), np.asarray(ref.values),
                       np.asarray(ref.nnz), ref.dim)
    _same(port, ref)
    assert port.device.type == "cpu" and port.num_vectors == 20
    assert port.rows(3, 9).indices.shape == (6, port.max_features)


@pytest.mark.parametrize("dim,tile,want", [(10_000, 128, 79), (512, 128, 4), (513, 128, 5)])
def test_num_tiles(dim, tile, want):
    assert num_tiles(dim, tile) == want


@pytest.mark.parametrize("n,dim,nnz,std,seed", SHAPES)
def test_tile_occupancy_byte_identical(n, dim, nnz, std, seed):
    ref = jax_synthetic(n, dim=dim, nnz_mean=nnz, nnz_std=std, seed=seed)
    port = synthetic_sparse(n, dim=dim, nnz_mean=nnz, nnz_std=std, seed=seed)
    for tile in (64, 128):
        got = tile_occupancy(port, tile).numpy()
        want = np.asarray(jax_occupancy(ref, tile))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,dim,nnz,std,seed", SHAPES)
def test_dense_tiles_with_sentinel_byte_identical(n, dim, nnz, std, seed):
    ref = jax_synthetic(n, dim=dim, nnz_mean=nnz, nnz_std=std, seed=seed)
    port = synthetic_sparse(n, dim=dim, nnz_mean=nnz, nnz_std=std, seed=seed)
    got = dense_tiles_with_sentinel(port, 128).numpy()
    want = np.asarray(jax_dense_tiles(ref, 128))
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    assert not got[-1].any()   # the sentinel tile is all zeros


@pytest.mark.parametrize("tile", [100, 126, 127])
def test_dense_tiles_pad_to_a_multiple_of_4(tile):
    """Tiles whose width is not a multiple of 4 get zero dims up to one:
    the real dims are dense_r_tiles' own, the rest and the sentinel zero."""
    port = synthetic_sparse(40, dim=700, nnz_mean=20, nnz_std=5, seed=tile)
    got = dense_tiles_with_sentinel(port, tile)
    assert got.shape == (num_tiles(700, tile) + 1, 40, -(-tile // 4) * 4)
    assert torch.equal(got[:-1, :, :tile], dense_r_tiles(port, tile))
    assert not got[..., tile:].any() and not got[-1].any()


@pytest.mark.parametrize("br,bs", [(16, 32), (64, 64), (24, 7)])
def test_active_lists_byte_identical(br, bs):
    R = jax_synthetic(70, dim=640, nnz_mean=15, nnz_std=4, seed=160)
    S = jax_synthetic(90, dim=640, nnz_mean=15, nnz_std=4, seed=6300)
    r_occ, s_occ = np.asarray(jax_occupancy(R)), np.asarray(jax_occupancy(S))
    got = active_lists(r_occ, s_occ, br, bs)
    want = jax_active_lists(r_occ, s_occ, br, bs)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,dim,peaks,seed", [(30, 2000, 80, 0), (50, 2000, 80, 1),
                                              (12, 20_000, 80, 5), (40, 500, 20, 9)])
def test_spectra_like_byte_identical(n, dim, peaks, seed):
    _same(spectra_like(n, dim=dim, peaks_mean=peaks, seed=seed),
          jax_spectra(n, dim=dim, peaks_mean=peaks, seed=seed))


def test_spectra_like_max_features_cut():
    _same(spectra_like(20, dim=1000, peaks_mean=40, seed=2, max_features=16),
          jax_spectra(20, dim=1000, peaks_mean=40, seed=2, max_features=16))


@pytest.mark.parametrize("max_features", [None, 5])
def test_from_dense_matches_reference(max_features):
    rng = np.random.default_rng(11)
    dense = np.where(rng.random((15, 60)) < 0.15, rng.random((15, 60)), 0.0).astype(np.float32)
    dense[3] = 0.0                                  # an empty row
    _same(SparseBatch.from_dense(dense, max_features=max_features),
          JaxBatch.from_dense(dense, max_features=max_features))


def _both(kind, seed):
    """The same batch in both packages: synthetic or spectra-shaped."""
    if kind == "synthetic":
        ref = jax_synthetic(60, dim=700, nnz_mean=25, nnz_std=6, seed=seed)
    else:
        ref = jax_spectra(40, dim=2000, seed=seed)
    port = from_arrays(np.asarray(ref.indices), np.asarray(ref.values), np.asarray(ref.nnz),
                       ref.dim)
    return ref, port


def _equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,seed", [("synthetic", 0), ("synthetic", 3), ("spectra", 1)])
def test_dim_statistics_equal_reference(kind, seed):
    """dim_frequency, max_weight_per_dim, frequency_permutation (stable:
    ties keep dim order) and reorder_dims equal the reference's exactly."""
    ref, port = _both(kind, seed)
    freq = dim_frequency(port)
    _equal(freq, jax_format.dim_frequency(ref))
    _equal(max_weight_per_dim(port), jax_format.max_weight_per_dim(ref))
    perm, inv = frequency_permutation(freq)
    jperm, jinv = jax_format.frequency_permutation(jax_format.dim_frequency(ref))
    _equal(perm, jperm)
    _equal(inv, np.asarray(jinv).astype(np.int64))
    got = reorder_dims(port, perm)
    want = jax_format.reorder_dims(ref, jperm)
    _equal(got.indices, want.indices)
    assert got.values is port.values and got.dim == port.dim


def test_port_imports_neither_jax_nor_repro():
    """src/repro_torch and chip_smoke.py stand alone: no jax, no repro."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:[.\s,]|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
