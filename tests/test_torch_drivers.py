"""The port's three join drivers (src/repro_torch/core/bf.py, iib.py,
iiib.py) against the JAX package's, on the same inputs: the stacked
S-block walks (``bf_scan_join``, ``iib_scan_join``, ``iiib_scan_join``,
the counterparts of the reference's ``lax.scan``) and their block steps.
States agree within rtol=1e-5, atol=1e-6 with ids equal outside tie
groups; IIIB's threshold traces agree within the same tolerance and its
kept-entry counts are equal.  The index arrays both packages walk are
the reference's own (``TileIndex.from_arrays``), or the port's own
build, which test_torch_index.py holds equal to them."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bf as jax_bf  # noqa: E402
from repro.core import iib as jax_iib  # noqa: E402
from repro.core import iiib as jax_iiib  # noqa: E402
from repro.core.index import build_tile_index as jax_build  # noqa: E402
from repro.core.index import dense_r_tiles as jax_dense_r_tiles  # noqa: E402
from repro.core.topk import init_topk as jax_init_topk  # noqa: E402
from repro.sparse.datagen import spectra_like as jax_spectra  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import SparseBatch as JaxBatch  # noqa: E402
from repro.sparse.format import dim_frequency as jax_dim_frequency  # noqa: E402
from repro_torch.core import bf, iib, iiib  # noqa: E402
from repro_torch.core.index import (  # noqa: E402
    active_tile_list,
    build_tile_index,
    dense_r_tiles,
    max_rows_bound,
)
from repro_torch.core.topk import init_topk, merge_step, topk_update  # noqa: E402
from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("rows", "vals", "counts", "pref_ub", "crossing")


def _port(batch):
    return from_arrays(np.asarray(batch.indices), np.asarray(batch.values),
                       np.asarray(batch.nnz), batch.dim)


def _data(kind):
    if kind == "small":
        R = jax_synthetic(48, dim=512, nnz_mean=20, nnz_std=5, seed=0)
        S = jax_synthetic(80, dim=512, nnz_mean=20, nnz_std=5, seed=1)
        return R, S, 5, 32, 128
    if kind == "prune":   # the reference's test_iiib_mask_prunes_entries data
        R = jax_synthetic(64, dim=4096, nnz_mean=24, nnz_std=6, seed=0)
        S = jax_synthetic(256, dim=4096, nnz_mean=24, nnz_std=6, seed=1)
        return R, S, 3, 64, 128
    R, S = jax_spectra(30, dim=2000, seed=0), jax_spectra(50, dim=2000, seed=1)
    return R, S, 5, 16, 128


def _blocks(S, sb):
    """S's padded blocks as (B, sb, F) host arrays, their ids and valid mask."""
    n, f = S.indices.shape
    b = -(-n // sb)
    idx = np.full((b * sb, f), S.dim, np.int32)
    val = np.zeros((b * sb, f), np.float32)
    nnz = np.zeros(b * sb, np.int32)
    idx[:n], val[:n], nnz[:n] = np.asarray(S.indices), np.asarray(S.values), np.asarray(S.nnz)
    ids = np.arange(b * sb, dtype=np.int32).reshape(b, sb)
    valid = (np.arange(b * sb) < n).reshape(b, sb)
    return idx.reshape(b, sb, f), val.reshape(b, sb, f), nnz.reshape(b, sb), ids, valid


def _index_stack(S, sb, tile, rank=None):
    """The reference's tile index of every block, one common max_rows."""
    idx, val, nnz, ids, valid = _blocks(S, sb)
    blocks = [JaxBatch(indices=jnp.asarray(i), values=jnp.asarray(v), nnz=jnp.asarray(z),
                       dim=S.dim) for i, v, z in zip(idx, val, nnz)]
    m = max(max_rows_bound(_port(b), tile, rank=rank) for b in blocks)
    jr = None if rank is None else jnp.asarray(rank)
    built = [jax_build(b, max_rows=m, tile=tile, rank=jr) for b in blocks]
    stack = {f: np.stack([np.asarray(getattr(ti, f)) for ti in built]) for f in FIELDS}
    return stack, ids, valid, (idx, val)


def _close(got_state, want_state):
    return assert_topk_close(got_state.scores.numpy(), got_state.ids.numpy(),
                             np.asarray(want_state.scores), np.asarray(want_state.ids),
                             RTOL, ATOL)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("kind", ["small", "prune", "spectra"])
def test_bf_scan_join_matches_reference(kind):
    R, S, k, sb, _ = _data(kind)
    idx, val, nnz, ids, valid = _blocks(S, sb)
    got = bf.bf_scan_join(init_topk(R.num_vectors, k, device="cpu"), _port(R), _t(idx), _t(val),
                          _t(nnz), _t(ids), _t(valid), dim=S.dim)
    want = jax_bf.bf_scan_join(jax_init_topk(R.num_vectors, k), R, jnp.asarray(idx),
                               jnp.asarray(val), jnp.asarray(nnz), jnp.asarray(ids),
                               jnp.asarray(valid), dim=S.dim)
    _close(got, want)


@pytest.mark.parametrize("kind", ["small", "prune", "spectra"])
def test_iib_scan_join_matches_reference(kind):
    R, S, k, sb, tile = _data(kind)
    stack, ids, valid, _ = _index_stack(S, sb, tile)
    r_np = np.asarray(jax_dense_r_tiles(R, None, tile))
    tiles = active_tile_list(np.abs(r_np).sum(axis=(1, 2)) > 0)
    got = iib.iib_scan_join(init_topk(R.num_vectors, k, device="cpu"), _t(r_np), tiles,
                            _t(stack["rows"]), _t(stack["vals"]), _t(stack["counts"]), _t(ids),
                            _t(valid), tile=tile, num_s=sb)
    want = jax_iib.iib_scan_join(jax_init_topk(R.num_vectors, k), jnp.asarray(r_np),
                                 jnp.asarray(tiles), jnp.asarray(stack["rows"]),
                                 jnp.asarray(stack["vals"]), jnp.asarray(stack["counts"]),
                                 jnp.asarray(ids), jnp.asarray(valid), tile=tile, num_s=sb)
    _close(got, want)


def _iiib_inputs(kind, ragged):
    """Both packages' IIIB walk inputs; ``ragged`` pads the R block with 5
    empty rows that ``r_valid`` masks out of the threshold."""
    R, S, k, sb, tile = _data(kind)
    rank = iiib.s_frequency_rank(np.asarray(jax_dim_frequency(S)))
    stack, ids, valid, (idx, val) = _index_stack(S, sb, tile, rank)
    mass = np.stack([iiib.tile_mass_host(i, v, S.dim, rank, tile) for i, v in zip(idx, val)])
    n = R.num_vectors
    pad = 5 if ragged else 0
    r_idx = np.concatenate([np.asarray(R.indices), np.full((pad, R.indices.shape[1]), R.dim,
                                                           np.int32)])
    r_val = np.concatenate([np.asarray(R.values), np.zeros((pad, R.indices.shape[1]),
                                                           np.float32)])
    r_nnz = np.concatenate([np.asarray(R.nnz), np.zeros(pad, np.int32)])
    jR = JaxBatch(indices=jnp.asarray(r_idx), values=jnp.asarray(r_val), nnz=jnp.asarray(r_nnz),
                  dim=R.dim)
    pR = from_arrays(r_idx, r_val, r_nnz, R.dim)
    r_valid = np.arange(n + pad) < n
    return jR, pR, k, sb, tile, rank, stack, ids, valid, mass, r_valid


@pytest.mark.parametrize("kind,ragged", [("small", False), ("small", True), ("prune", False),
                                         ("spectra", True)])
def test_iiib_scan_join_matches_reference(kind, ragged):
    """States, the threshold trace and the kept-entry counts; the trace is
    monotone and (ragged R block included) leaves -inf."""
    jR, pR, k, sb, tile, rank, stack, ids, valid, mass, r_valid = _iiib_inputs(kind, ragged)
    n = pR.num_vectors
    r_tiles = dense_r_tiles(pR, tile, rank=_t(rank))
    mwt = iiib.maxw_tiles(pR, _t(rank), tile)
    tiles = active_tile_list(np.abs(r_tiles.numpy()).sum(axis=(1, 2)) > 0)
    state0 = init_topk(n, k, device="cpu")
    thr0 = torch.tensor(float("-inf"))
    got, thr, trace, kept = iiib.iiib_scan_join(
        state0, thr0, r_tiles, mwt, tiles, _t(stack["rows"]), _t(stack["vals"]),
        _t(stack["counts"]), _t(mass), _t(ids), _t(valid), _t(r_valid), tile=tile, num_s=sb)
    want, jthr, jtrace, jkept = jax_iiib.iiib_scan_join(
        jax_init_topk(n, k), jnp.float32(-jnp.inf), jnp.asarray(r_tiles.numpy()),
        jnp.asarray(mwt.numpy()), jnp.asarray(tiles), jnp.asarray(stack["rows"]),
        jnp.asarray(stack["vals"]), jnp.asarray(stack["counts"]), jnp.asarray(mass),
        jnp.asarray(ids), jnp.asarray(valid), jnp.asarray(r_valid), tile=tile, num_s=sb)
    _close(got, want)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    assert float(thr) == float(trace[-1])
    assert np.all(np.diff(trace.numpy()) >= 0) and float(trace[-1]) > float("-inf")
    assert int(kept.sum()) <= int(stack["counts"].sum())


def test_iiib_mask_prunes_on_its_data():
    """On the reference's pruning data the mask keeps fewer entries than the
    superset holds."""
    _, pR, k, sb, tile, rank, stack, ids, valid, mass, r_valid = _iiib_inputs("prune", False)
    r_tiles = dense_r_tiles(pR, tile, rank=_t(rank))
    tiles = active_tile_list(np.abs(r_tiles.numpy()).sum(axis=(1, 2)) > 0)
    *_, kept = iiib.iiib_scan_join(
        init_topk(pR.num_vectors, k, device="cpu"), torch.tensor(float("-inf")), r_tiles,
        iiib.maxw_tiles(pR, _t(rank), tile), tiles, _t(stack["rows"]), _t(stack["vals"]),
        _t(stack["counts"]), _t(mass), _t(ids), _t(valid), _t(r_valid), tile=tile, num_s=sb)
    assert int(kept.sum()) < int(stack["counts"].sum())


@pytest.mark.parametrize("kind", ["small", "spectra"])
def test_block_steps_match_reference(kind):
    """One (B_r, B_s) step of each driver on the port's own index of the
    first S block, from a warm state (the reference's first step)."""
    R, S, k, sb, tile = _data(kind)
    pR, pS = _port(R), _port(S)
    s_blk = pS.rows(0, sb)
    jS = JaxBatch(indices=S.indices[:sb], values=S.values[:sb], nnz=S.nnz[:sb], dim=S.dim)
    valid = np.ones(sb, bool)
    valid[3] = False
    warm = bf.bf_join_block(init_topk(R.num_vectors, k, device="cpu"), pR, pS.rows(sb, 2 * sb),
                            sb)
    jwarm = jax_bf.bf_join_block(jax_init_topk(R.num_vectors, k), R,
                                 JaxBatch(indices=S.indices[sb:2 * sb],
                                          values=S.values[sb:2 * sb],
                                          nnz=S.nnz[sb:2 * sb], dim=S.dim), sb)
    _close(warm, jwarm)

    got = bf.bf_join_block(warm, pR, s_blk, 0, _t(valid))
    want = jax_bf.bf_join_block(jwarm, R, jS, 0, jnp.asarray(valid))
    _close(got, want)

    index = build_tile_index(s_blk, max_rows=max_rows_bound(s_blk, tile), tile=tile)
    r_tiles = dense_r_tiles(pR, tile)
    tiles = active_tile_list(np.abs(r_tiles.numpy()).sum(axis=(1, 2)) > 0)
    got = iib.iib_join_block(warm, r_tiles, index, tiles, 0, _t(valid))
    jindex = jax_build(jS, max_rows=index.max_rows, tile=tile)
    want = jax_iib.iib_join_block(jwarm, jnp.asarray(r_tiles.numpy()), jindex, jnp.asarray(tiles),
                                  jnp.int32(0), jnp.asarray(valid))
    _close(got, want)

    rank = iiib.s_frequency_rank(np.asarray(jax_dim_frequency(S)))
    sindex = build_tile_index(s_blk, max_rows=max_rows_bound(s_blk, tile, rank=rank), tile=tile,
                              rank=_t(rank))
    mass = iiib.tile_mass_host(s_blk.indices.numpy(), s_blk.values.numpy(), S.dim, rank, tile)
    pr_tiles = dense_r_tiles(pR, tile, rank=_t(rank))
    mwt = iiib.maxw_tiles(pR, _t(rank), tile)
    ptiles = active_tile_list(np.abs(pr_tiles.numpy()).sum(axis=(1, 2)) > 0)
    rv = torch.ones(R.num_vectors, dtype=torch.bool)
    thr = warm.scores[:, -1].min()
    got, gthr, gkept = iiib.iiib_masked_block(warm, thr, pr_tiles, sindex, _t(mass), mwt, ptiles,
                                              0, _t(valid), rv)
    jsindex = jax_build(jS, max_rows=sindex.max_rows, tile=tile, rank=jnp.asarray(rank))
    want, wthr, wkept = jax_iiib.iiib_masked_block(
        jwarm, jnp.float32(float(thr)), jnp.asarray(pr_tiles.numpy()), jsindex, jnp.asarray(mass),
        jnp.asarray(mwt.numpy()), jnp.asarray(ptiles), jnp.int32(0), jnp.asarray(valid),
        jnp.asarray(rv.numpy()))
    _close(got, want)
    np.testing.assert_allclose(float(gthr), float(wthr), rtol=RTOL, atol=ATOL)
    assert int(gkept) == int(wkept)


def test_merge_step_is_topk_update_and_the_kernel_wrapper(monkeypatch):
    """A driver step merges through topk_merge_cuda (its plain version on
    the CPU), which equals topk_update's stable sort bit for bit."""
    rng = np.random.default_rng(0)
    state = init_topk(6, 4, device="cpu")
    scores = torch.tensor(np.round(rng.random((6, 40)), 1).astype(np.float32))
    scores[2] = float("-inf")
    ids = torch.arange(100, 140, dtype=torch.int32)
    want = topk_update(state, scores, ids)
    calls = []

    def counting(*args):
        calls.append(args[2].shape)
        return topk_merge_cuda(*args)

    monkeypatch.setattr("repro_torch.core.topk.topk_merge_cuda", counting)
    got = merge_step(state, scores, ids)
    assert calls == [(6, 40)]
    assert torch.equal(got.scores, want.scores) and torch.equal(got.ids, want.ids)


def test_block_ids():
    assert torch.equal(bf.block_ids(5, 3, device="cpu"),
                       torch.tensor([5, 6, 7], dtype=torch.int32))
    per_row = torch.tensor([9, 2, 4], dtype=torch.int32)
    assert torch.equal(bf.block_ids(per_row, 3), per_row)
