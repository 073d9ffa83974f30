"""The port's top-k merges and fused score→top-k (src/repro_torch) against
the JAX package's on the same seeded inputs: the merges bit for bit, ties
included; ``knn_topk_plain`` against ``repro.kernels.knn_topk.ref.knn_topk_ref``
within rtol=1e-5, atol=1e-6 on scores (the two sum the tile products in
different orders), ids equal outside tie groups."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.topk import init_topk as jax_init_topk  # noqa: E402
from repro.core.topk import topk_update as jax_topk_update  # noqa: E402
from repro.kernels.knn_topk.ref import knn_topk_ref  # noqa: E402
from repro.kernels.topk_merge.kernel import insert_candidates as jax_insert  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import densify  # noqa: E402
from repro_torch.core.topk import (  # noqa: E402
    TopKState,
    init_topk,
    min_prune_score,
    pad_topk_state,
    topk_update,
)
from repro_torch.kernels.knn_score.ops import (  # noqa: E402
    _pad_rows,
    active_lists,
    dense_tiles_with_sentinel,
)
from repro_torch.kernels.knn_score.ref import knn_score_plain  # noqa: E402
from repro_torch.kernels.knn_topk.kernel import knn_topk_fused, split_ranges  # noqa: E402
from repro_torch.kernels.knn_topk.ops import column_meta, knn_topk, pad_state  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_plain  # noqa: E402
from repro_torch.kernels.topk_merge.kernel import insert_candidates  # noqa: E402
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import tile_occupancy  # noqa: E402
from repro_torch.testing import assert_topk_close, doubled, with_zero_rows  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _tied_candidates(seed, n=16, k=6, m=24):
    """A partly filled descending state and candidates drawn from a few
    values, so that ties between incumbents and candidates are common."""
    rng = np.random.default_rng(seed)
    levels = np.array([-np.inf, 0.25, 0.5, 0.75, 1.0], np.float32)
    state_s = -np.sort(-rng.choice(levels, size=(n, k)), axis=1).astype(np.float32)
    state_i = np.where(np.isfinite(state_s), rng.integers(0, 1000, (n, k)), -1).astype(np.int32)
    cand_s = rng.choice(levels, size=(n, m)).astype(np.float32)
    cand_i = rng.integers(1000, 2000, (n, m)).astype(np.int32)
    return state_s, state_i, cand_s, cand_i


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_candidates_bit_identical(seed):
    ss, si, cs, ci = _tied_candidates(seed)
    got = insert_candidates(*(torch.from_numpy(a) for a in (ss, si, cs, ci)))
    want = jax_insert(*(jnp.asarray(a) for a in (ss, si, cs, ci)))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed,shared_ids", [(3, False), (4, True)])
def test_topk_update_bit_identical(seed, shared_ids):
    ss, si, cs, ci = _tied_candidates(seed)
    ids = ci[0] if shared_ids else ci
    got = topk_update(TopKState(torch.from_numpy(ss), torch.from_numpy(si)),
                      torch.from_numpy(cs), torch.from_numpy(ids))
    from repro.core.topk import TopKState as JaxState

    want = jax_topk_update(JaxState(jnp.asarray(ss), jnp.asarray(si)),
                           jnp.asarray(cs), jnp.asarray(ids))
    assert got.scores.numpy().tobytes() == np.asarray(want.scores).tobytes()
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    # the stable merge and the insertion body agree (incumbents win ties)
    ins = insert_candidates(torch.from_numpy(ss), torch.from_numpy(si), torch.from_numpy(cs),
                            torch.from_numpy(np.broadcast_to(ids, cs.shape).copy()))
    assert torch.equal(ins[0], got.scores) and torch.equal(ins[1], got.ids)


def test_state_helpers():
    st = init_topk(3, 4, device="cpu")
    assert st.k == 4 and torch.isinf(st.scores).all() and (st.ids == -1).all()
    st = topk_update(st, torch.tensor([[0.5, 0.1], [0.2, 0.3], [0.9, 0.8]]),
                     torch.tensor([7, 8]))
    padded = pad_topk_state(st, 5)
    assert padded.scores.shape == (5, 4) and (padded.ids[3:] == -1).all()
    assert float(min_prune_score(st)) == float("-inf")
    full = topk_update(init_topk(2, 1, device="cpu"), torch.tensor([[0.5], [0.25]]), torch.tensor([1]))
    assert float(min_prune_score(full)) == 0.25
    assert float(min_prune_score(full, valid=torch.tensor([True, False]))) == 0.5


def _both_inputs(nr, ns, dim, br, bs, k, s_valid=None, seed_state=None, s_offset=0):
    """The same arrays for both packages: (jax args, torch args).  Built
    with the port's plumbing, which tests/test_torch_format.py holds byte
    for byte to the JAX package's."""
    R = synthetic_sparse(nr, dim=dim, nnz_mean=12, nnz_std=4, seed=nr + ns)
    S = synthetic_sparse(ns, dim=dim, nnz_mean=12, nnz_std=4, seed=nr * ns + s_offset)
    r_tiles = _pad_rows(dense_tiles_with_sentinel(R, 128), br)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(S, 128), bs)
    active = torch.from_numpy(active_lists(tile_occupancy(R, 128).numpy(),
                                           tile_occupancy(S, 128).numpy(), br, bs))
    valid, ids = column_meta(ns, s_tiles.shape[1], s_offset=s_offset, s_valid=s_valid,
                             device="cpu")
    state = seed_state if seed_state is not None else init_topk(nr, k, device="cpu")
    init_s, init_i = pad_state(state, r_tiles.shape[1])
    thr = min_prune_score(state).reshape(1, 1)
    nrv = torch.full((1,), nr, dtype=torch.int32)
    torch_args = (r_tiles, s_tiles, active, valid, ids, init_s, init_i, thr, nrv)
    jax_args = tuple(jnp.asarray(a.numpy()) for a in torch_args)
    return jax_args, torch_args


def _check(jax_args, torch_args, br, bs):
    want = knn_topk_ref(*jax_args[:7], thr=jax_args[7], nr_valid=jax_args[8],
                        block_r=br, block_s=bs)
    got = knn_topk_plain(*torch_args[:7], thr=torch_args[7], nr_valid=torch_args[8],
                         block_r=br, block_s=bs)
    assert_topk_close(got[0].numpy(), got[1].numpy(), np.asarray(want[0]), np.asarray(want[1]),
                      RTOL, ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=RTOL, atol=ATOL)
    return got


@pytest.mark.parametrize("nr,ns,dim,br,bs,k", [
    (64, 64, 256, 64, 64, 8),
    (70, 90, 640, 64, 64, 5),      # padded rows + ragged final S block, k%8
    (48, 100, 512, 16, 32, 12),    # k%8 != 0, small blocks
    (32, 200, 1024, 32, 64, 3),    # tall-thin
])
def test_knn_topk_plain_vs_reference(nr, ns, dim, br, bs, k):
    jax_args, torch_args = _both_inputs(nr, ns, dim, br, bs, k)
    _check(jax_args, torch_args, br, bs)


def test_knn_topk_plain_masked_columns():
    s_valid = np.random.default_rng(0).random(64) > 0.3
    jax_args, torch_args = _both_inputs(40, 64, 512, 32, 32, 7, s_valid=s_valid)
    got = _check(jax_args, torch_args, 32, 32)
    assert not np.isin(got[1].numpy(), np.nonzero(~s_valid)[0]).any()


def test_knn_topk_plain_chained_warm_threshold():
    """A chained pair over two S chunks: the first pass's state seeds the
    second's state and its MinPruneScore threshold; both packages agree on
    all three outputs."""
    nr, ns, dim, br, bs, k = 40, 64, 512, 32, 32, 7
    jax_args, torch_args = _both_inputs(nr, ns, dim, br, bs, k)
    first = knn_topk_ref(*jax_args[:7], thr=jax_args[7], nr_valid=jax_args[8],
                         block_r=br, block_s=bs)
    warm = TopKState(torch.from_numpy(np.array(first[0][:nr])),
                     torch.from_numpy(np.array(first[1][:nr])))
    jax_args, torch_args = _both_inputs(nr, ns, dim, br, bs, k, seed_state=warm, s_offset=ns)
    assert np.isfinite(np.asarray(jax_args[7])).all()   # a live threshold
    _check(jax_args, torch_args, br, bs)


def test_knn_topk_op_matches_dense_merge():
    """ops.knn_topk on the CPU == dense scores, >0 mask, one topk_update;
    the wrapper ran the plain version and counted no launch."""
    R = synthetic_sparse(70, dim=640, nnz_mean=15, nnz_std=4, seed=160)
    S = synthetic_sparse(90, dim=640, nnz_mean=15, nnz_std=4, seed=6300)
    before = knn_topk_fused.launches
    st = knn_topk(R, S, k=5, block_r=64, block_s=64, device="cpu")
    assert knn_topk_fused.launches == before
    jr = jax_synthetic(70, dim=640, nnz_mean=15, nnz_std=4, seed=160)
    js = jax_synthetic(90, dim=640, nnz_mean=15, nnz_std=4, seed=6300)
    dense = np.asarray(densify(jr)) @ np.asarray(densify(js)).T
    want = jax_topk_update(jax_init_topk(70, 5), jnp.asarray(np.where(dense > 0, dense, -np.inf)),
                           jnp.arange(90, dtype=jnp.int32))
    assert_topk_close(st.scores.numpy(), st.ids.numpy(), np.asarray(want.scores),
                      np.asarray(want.ids), RTOL, ATOL)


def test_knn_topk_fused_rejects_other_devices():
    args = [torch.zeros(2, 8, 4, device="meta")] + [None] * 6
    with pytest.raises(ValueError):
        knn_topk_fused(*args)


def _split_case(variant, nr=70, ns=128, dim=512, br=32, bs=32, k=7):
    """(torch args, jax args) of one fused call, each a case of the split
    walk: "plain"; "ties" (S's second half repeats its first, so equal
    scores sit in two S ranges); "warm-no-offer" (a warm state and its
    MinPruneScore from a first pass, and R block 1 zeroed, so it offers
    nothing and keeps its finite seed)."""
    R = synthetic_sparse(nr, dim=dim, nnz_mean=12, nnz_std=4, seed=nr + ns)
    if variant == "ties":
        S = doubled(synthetic_sparse(ns // 2, dim=dim, nnz_mean=12, nnz_std=4, seed=7))
    else:
        S = synthetic_sparse(ns, dim=dim, nnz_mean=12, nnz_std=4, seed=nr * ns)
    state = init_topk(nr, k, device="cpu")
    if variant == "warm-no-offer":
        first = synthetic_sparse(ns, dim=dim, nnz_mean=12, nnz_std=4, seed=5)
        f_tiles = _pad_rows(dense_tiles_with_sentinel(first, 128), bs)
        r_tiles = _pad_rows(dense_tiles_with_sentinel(R, 128), br)
        f_active = torch.from_numpy(active_lists(tile_occupancy(R, 128).numpy(),
                                                 tile_occupancy(first, 128).numpy(), br, bs))
        fv, fi = column_meta(ns, f_tiles.shape[1], s_offset=ns, device="cpu")
        w_s, w_i, _ = knn_topk_plain(r_tiles, f_tiles, f_active, fv, fi,
                                     *pad_state(state, r_tiles.shape[1]), block_r=br, block_s=bs)
        state = TopKState(w_s[:nr], w_i[:nr])
        R = with_zero_rows(R, br, 2 * br)
    r_tiles = _pad_rows(dense_tiles_with_sentinel(R, 128), br)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(S, 128), bs)
    active = torch.from_numpy(active_lists(tile_occupancy(R, 128).numpy(),
                                           tile_occupancy(S, 128).numpy(), br, bs))
    valid, ids = column_meta(ns, s_tiles.shape[1], device="cpu")
    init_s, init_i = pad_state(state, r_tiles.shape[1])
    thr = min_prune_score(state).reshape(1, 1)
    nrv = torch.full((1,), nr, dtype=torch.int32)
    torch_args = (r_tiles, s_tiles, active, valid, ids, init_s, init_i, thr, nrv)
    return torch_args, tuple(jnp.asarray(a.numpy()) for a in torch_args)


def _split_walk(torch_args, br, bs, n_ranges, unit):
    """The fused kernel's two passes in plain form: S cut into ``n_ranges``
    runs of ``unit``-column tiles (a divisor of block_s: a range may start
    inside an S block), each walked by ``knn_topk_plain`` from an empty state
    seeded with thr_in, its threshold rising after each tile; the partial
    states inserted in range order onto the init state; thr_out = min over
    rows < nr_valid of the final k-th score where the R block offered
    anything (some positive valid score beats thr_in), else thr_in."""
    r_tiles, s_tiles, active, valid, ids, init_s, init_i, thr, nrv = torch_args
    n_units = s_tiles.shape[1] // unit
    per = -(-n_units // n_ranges)
    act_u = active.repeat_interleave(bs // unit, dim=1)   # each tile keeps its block's list
    out_s, out_i = init_s, init_i
    for u0 in range(0, n_units, per):
        u1 = min(n_units, u0 + per)
        cols = slice(u0 * unit, u1 * unit)
        p_s, p_i, _ = knn_topk_plain(
            r_tiles, s_tiles[:, cols], act_u[:, u0:u1], valid[:, cols], ids[:, cols],
            torch.full_like(init_s, float("-inf")), torch.full_like(init_i, -1),
            thr=thr, nr_valid=nrv, block_r=br, block_s=unit)
        out_s, out_i = insert_candidates(out_s, out_i, p_s, p_i)
    scores = knn_score_plain(r_tiles, s_tiles, active, block_r=br, block_s=bs)
    ok = (scores > 0) & (valid > 0) & (scores > thr)
    offered = ok.reshape(-1, br * scores.shape[1]).any(dim=1)
    row_ok = torch.arange(out_s.shape[0]) < nrv
    kth = torch.where(row_ok, out_s[:, -1], float("inf")).reshape(-1, br).min(dim=1).values
    return out_s, out_i, torch.where(offered, kth, thr.reshape(()))[:, None]


@pytest.mark.parametrize("variant", ["plain", "ties", "warm-no-offer"])
@pytest.mark.parametrize("n_ranges,unit", [
    (1, 32), (2, 32), (4, 32),   # whole S blocks of 32 columns; 4: one block a range
    (3, 16), (8, 16),            # half-block tiles: ranges of 3, 3, 2 start inside blocks
])
def test_split_walk_merged_in_s_order_is_the_sequential_walk(variant, n_ranges, unit):
    """The algebra of the fused kernel's S split: ranges walked apart and
    merged in S order give the sequential walk's state bit for bit (rows <
    nr_valid), ties and thr_out included, and the JAX reference's within
    rtol=1e-5, atol=1e-6."""
    br, bs, nr = 32, 32, 70
    torch_args, jax_args = _split_case(variant, nr=nr, br=br, bs=bs)
    kw = dict(thr=torch_args[7], nr_valid=torch_args[8], block_r=br, block_s=bs)
    want = knn_topk_plain(*torch_args[:7], **kw)
    got = _split_walk(torch_args, br, bs, n_ranges, unit)
    assert torch.equal(got[0][:nr], want[0][:nr]) and torch.equal(got[1][:nr], want[1][:nr])
    assert torch.equal(got[2], want[2])
    ref = knn_topk_ref(*jax_args[:7], thr=jax_args[7], nr_valid=jax_args[8],
                       block_r=br, block_s=bs)
    assert_topk_close(got[0][:nr].numpy(), got[1][:nr].numpy(), np.asarray(ref[0])[:nr],
                      np.asarray(ref[1])[:nr], RTOL, ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=RTOL, atol=ATOL)
    if variant == "ties":       # a row holds both copies of one S row: a tie across ranges
        ids = want[1][:nr]
        assert bool(((ids[:, :, None] == ids[:, None, :] + 64) & (ids[:, None, :] >= 0)).any())
    if variant == "warm-no-offer":   # block 1 kept its seed; the others rose above it
        thr_in = float(torch_args[7])
        assert np.isfinite(thr_in) and float(want[2][1]) == thr_in
        assert float(want[2][0]) > thr_in and float(want[2][2]) > thr_in
        # block 1's seeded k-th scores lie above thr_in: "no offer" is told apart
        assert float(torch_args[5][br:2 * br, -1].min()) > thr_in


@pytest.mark.parametrize("n_rb,n_sb,block_r,block_s,n_sm,want", [
    (8, 40, 256, 256, 132, (16, 5)),   # the engine's shapes: 16 x 16 CTAs, one wave of 264
    (1, 8, 256, 256, 132, (16, 1)),    # streaming: one 128-column tile a range
    (1, 1, 64, 64, 132, (1, 1)),       # one S block of one tile: P = 1
    (40, 40, 256, 256, 132, (16, 5)),  # 80 R tiles: 1,280 CTAs of 5 tiles
    (1, 41, 256, 256, 4, (4, 21)),     # ragged: the last range holds 19 tiles
])
def test_split_ranges(n_rb, n_sb, block_r, block_s, n_sm, want):
    assert split_ranges(n_rb, n_sb, block_r, block_s, n_sm) == want
