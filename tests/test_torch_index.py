"""The port's tile index (src/repro_torch/core/index.py) and IIIB's
build-time structures (core/iiib.py) against the JAX package's, on the
same seeded inputs: the index arrays, the bounds, the dense tiles and the
tile mass equal exactly; scores from the JAX-built index (carried over
with ``TileIndex.from_arrays``) agree within rtol=1e-5, atol=1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import iiib as jax_iiib  # noqa: E402
from repro.core import index as jax_index  # noqa: E402
from repro.sparse.datagen import spectra_like as jax_spectra  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import dim_frequency as jax_dim_frequency  # noqa: E402
from repro.sparse.format import max_weight_per_dim as jax_max_weight  # noqa: E402
from repro_torch.core import iiib  # noqa: E402
from repro_torch.core.index import (  # noqa: E402
    TileIndex,
    build_tile_index,
    dense_r_tiles,
    masked_tile_scores,
    max_rows_bound,
    tile_scores,
)
from repro_torch.sparse.format import dim_frequency, from_arrays, num_tiles  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
TILE = 64


def _port(batch):
    return from_arrays(np.asarray(batch.indices), np.asarray(batch.values),
                       np.asarray(batch.nnz), batch.dim)


def _data(kind):
    """(R, S) in both packages: synthetic_sparse or spectra_like."""
    if kind == "synthetic":
        R = jax_synthetic(40, dim=1000, nnz_mean=30, nnz_std=8, seed=2)
        S = jax_synthetic(70, dim=1000, nnz_mean=30, nnz_std=8, seed=3)
    else:
        R, S = jax_spectra(30, dim=2000, seed=0), jax_spectra(50, dim=2000, seed=1)
    return R, S, _port(R), _port(S)


def _rank(S):
    return iiib.s_frequency_rank(np.asarray(jax_dim_frequency(S)))


def _assert_same_index(got: TileIndex, want):
    """rows, counts, vals (copies) and crossing (a tile id) equal; pref_ub,
    a prefix sum that XLA adds in another order (an associative scan),
    within the float32 tolerance."""
    for name in ("rows", "counts", "vals", "pref_ub", "crossing"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "pref_ub":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.tile, got.num_s) == (want.tile, want.num_s)


MODES = ["iib", "superset", "crossing", "uniform"]


def _build_both(kind, mode):
    """The port's and the reference's index of S in one mode: IIB
    (identity dims), the superset (S-frequency rank), the IIIB crossing
    walk (R's rank and maxWeight, a live threshold), or that walk with a
    uniform crossing."""
    R, S, pR, pS = _data(kind)
    rank = maxw = thr = None
    if mode != "iib":
        rank = _rank(S)
    if mode in ("crossing", "uniform"):
        rank = np.asarray(jax_iiib.prepare_r_block(R, TILE)[0])
        maxw = np.asarray(jax_max_weight(R))
        # uniform: high enough that every row's crossing lies past tile 0
        thr = np.float32({("synthetic", "crossing"): 1.5, ("spectra", "crossing"): 0.8,
                          ("synthetic", "uniform"): 4.0, ("spectra", "uniform"): 4.0}[kind, mode])
    uniform = mode == "uniform"
    bound = max_rows_bound(pS, TILE, rank=rank, maxw=maxw,
                           min_prune_score=-np.inf if thr is None else float(thr))
    want_bound = jax_index.max_rows_bound(S, TILE, rank=rank, maxw=maxw,
                                          min_prune_score=-np.inf if thr is None else float(thr))
    assert bound == want_bound
    t = lambda x: None if x is None else torch.tensor(x)  # noqa: E731
    got = build_tile_index(pS, max_rows=bound, tile=TILE, rank=t(rank), maxw=t(maxw),
                           min_prune_score=t(thr), uniform=uniform)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    want = jax_index.build_tile_index(S, max_rows=bound, tile=TILE, rank=j(rank), maxw=j(maxw),
                                      min_prune_score=j(thr), uniform=uniform)
    return got, want, (R, S, pR, pS, rank)


@pytest.mark.parametrize("kind", ["synthetic", "spectra"])
@pytest.mark.parametrize("mode", MODES)
def test_build_tile_index_equals_reference(kind, mode):
    got, want, _ = _build_both(kind, mode)
    _assert_same_index(got, want)
    if mode in ("crossing", "uniform"):
        # the walk left a prefix unindexed somewhere: the case is not trivial
        assert bool((got.pref_ub > 0).any()) and int(got.crossing.max()) > 0


def test_build_tile_index_short_list_bound():
    """A max_rows below the longest list cuts the lists as the reference
    does (rows past the bound are dropped, counts still count them)."""
    _, _, pR, pS = _data("synthetic")
    S = jax_synthetic(70, dim=1000, nnz_mean=30, nnz_std=8, seed=3)
    _assert_same_index(build_tile_index(pS, max_rows=8, tile=TILE),
                       jax_index.build_tile_index(S, max_rows=8, tile=TILE))


@pytest.mark.parametrize("kind", ["synthetic", "spectra"])
@pytest.mark.parametrize("ranked", [False, True])
def test_dense_r_tiles_equal_reference(kind, ranked):
    R, S, pR, _ = _data(kind)
    rank = _rank(S) if ranked else None
    got = dense_r_tiles(pR, TILE, rank=None if rank is None else torch.as_tensor(rank))
    want = jax_index.dense_r_tiles(R, None if rank is None else jnp.asarray(rank), TILE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["synthetic", "spectra"])
@pytest.mark.parametrize("mode", ["iib", "superset"])
def test_tile_scores_on_reference_index(kind, mode):
    """The port's scoring on the JAX-built index, carried over as arrays."""
    _, want, (R, S, pR, pS, rank) = _build_both(kind, mode)
    index = TileIndex.from_arrays(*(np.asarray(getattr(want, f)) for f in
                                    ("rows", "vals", "counts", "pref_ub", "crossing")),
                                  tile=want.tile, num_s=want.num_s)
    jr = None if rank is None else jnp.asarray(rank)
    r_np = np.asarray(jax_index.dense_r_tiles(R, jr, TILE))
    r_tiles = torch.tensor(r_np)
    t_total = num_tiles(R.dim, TILE)
    active = jax_index.active_tile_list(np.abs(r_np).sum(axis=(1, 2)) > 0)
    assert active[-1] == t_total or len(active) % 8 == 0
    got = tile_scores(r_tiles, index, active)
    ref = jax_index.tile_scores(jnp.asarray(r_np), want, jnp.asarray(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    rng = np.random.default_rng(4)
    keep = rng.random((want.num_s, t_total)) < 0.6
    kept, full = masked_tile_scores(r_tiles, index, active, torch.as_tensor(keep))
    jkept, jfull = jax_index.masked_tile_scores(jnp.asarray(r_np), want, jnp.asarray(active),
                                                jnp.asarray(keep))
    np.testing.assert_allclose(kept.numpy(), np.asarray(jkept), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(full.numpy(), got.numpy(), rtol=RTOL, atol=ATOL)


def test_scores_of_port_index_equal_dense_product():
    """The port's own index scores every pair as the dense product does."""
    _, _, pR, pS = _data("spectra")
    rank = torch.as_tensor(_rank(jax_spectra(50, dim=2000, seed=1)))
    index = build_tile_index(pS, max_rows=max_rows_bound(pS, TILE, rank=rank.numpy()),
                             tile=TILE, rank=rank)
    r_tiles = dense_r_tiles(pR, TILE, rank=rank)
    got = tile_scores(r_tiles, index, np.arange(num_tiles(2000, TILE) + 1, dtype=np.int32))
    dense_r = dense_r_tiles(pR, TILE).transpose(0, 1).reshape(pR.num_vectors, -1)
    dense_s = dense_r_tiles(pS, TILE).transpose(0, 1).reshape(pS.num_vectors, -1)
    np.testing.assert_allclose(got.numpy(), (dense_r.double() @ dense_s.double().T).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["synthetic", "spectra"])
def test_iiib_build_structures_equal_reference(kind):
    """s_frequency_rank, tile_mass_host, maxw_tiles and prepare_r_block."""
    R, S, pR, pS = _data(kind)
    freq = dim_frequency(pS).numpy().astype(np.int64)
    rank = iiib.s_frequency_rank(freq)
    np.testing.assert_array_equal(rank, jax_iiib.s_frequency_rank(np.asarray(jax_dim_frequency(S))))
    idx, val = np.asarray(S.indices), np.asarray(S.values)
    np.testing.assert_array_equal(iiib.tile_mass_host(idx, val, S.dim, rank, TILE),
                                  jax_iiib.tile_mass_host(idx, val, S.dim, rank, TILE))
    got = iiib.maxw_tiles(pR, torch.as_tensor(rank), TILE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_iiib.maxw_tiles(R, jnp.asarray(rank),
                                                                              TILE)))
    for g, w in zip(iiib.prepare_r_block(pR, TILE), jax_iiib.prepare_r_block(R, TILE)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_from_arrays_carries_the_reference_index():
    _, want, _ = _build_both("synthetic", "superset")
    got = TileIndex.from_arrays(*(np.asarray(getattr(want, f)) for f in
                                  ("rows", "vals", "counts", "pref_ub", "crossing")),
                                tile=want.tile, num_s=want.num_s)
    _assert_same_index(got, want)
    assert got.n_tiles == want.n_tiles and got.max_rows == want.max_rows
