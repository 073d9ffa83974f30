"""The port's streaming top-k merge (src/repro_torch/kernels/topk_merge and
core/topk.merge_topk_states) against the JAX package's, bit for bit on the
same seeded inputs, ties and -inf included; and the unfused join path
(score, mask, merge) against the port's fused knn_topk op."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.topk import TopKState as JaxState  # noqa: E402
from repro.core.topk import merge_topk_states as jax_merge_states  # noqa: E402
from repro.kernels.topk_merge.ops import topk_merge as jax_topk_merge  # noqa: E402
from repro_torch.core.topk import TopKState, init_topk, merge_topk_states  # noqa: E402
from repro_torch.kernels.knn_score.ops import (  # noqa: E402
    _pad_rows, active_lists, dense_tiles_with_sentinel, knn_score)
from repro_torch.kernels.knn_topk.kernel import knn_topk_fused  # noqa: E402
from repro_torch.kernels.knn_topk.ops import (  # noqa: E402
    column_meta, knn_topk, pad_state, score_then_merge)
from repro_torch.kernels.topk_merge.kernel import insert_candidates, topk_merge_cuda  # noqa: E402
from repro_torch.kernels.topk_merge.ops import topk_merge  # noqa: E402
from repro_torch.kernels.topk_merge.ref import topk_merge_plain  # noqa: E402
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import tile_occupancy  # noqa: E402
from repro_torch.testing import doubled  # noqa: E402

LEVELS = np.array([-np.inf, 0.125, 0.25, 0.5, 0.75, 1.0], np.float32)


def _state(rng, n, k):
    """A descending (n, k) state with some empty (-inf, -1) slots and ties."""
    s = -np.sort(-rng.choice(LEVELS, size=(n, k)), axis=1).astype(np.float32)
    i = np.where(np.isfinite(s), rng.integers(0, 1000, (n, k)), -1).astype(np.int32)
    return s, i


def _inputs(seed, n, k, m, shared_ids):
    """State and (n, m) candidates: a few tied levels (-inf among them)
    mixed with distinct random scores."""
    rng = np.random.default_rng(seed)
    ss, si = _state(rng, n, k)
    cs = np.where(rng.random((n, m)) < 0.5, rng.choice(LEVELS, size=(n, m)),
                  rng.random((n, m))).astype(np.float32)
    ci = (np.arange(1000, 1000 + m, dtype=np.int32) if shared_ids
          else rng.integers(1000, 5000, (n, m)).astype(np.int32))
    return ss, si, cs, ci


def _same(got, want):
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    assert gs.dtype == ws.dtype == np.float32 and gi.dtype == wi.dtype == np.int32
    assert gs.tobytes() == ws.tobytes() and gi.tobytes() == wi.tobytes()


@pytest.mark.parametrize("n,k,m,shared_ids", [
    (64, 5, 64, False),
    (256, 8, 300, True),      # M not a multiple of 32, shared (M,) ids
    (100, 16, 64, False),
    (32, 1, 50, False),
    (16, 128, 200, True),     # k = 128
    (8, 200, 300, True),      # k > 128: the large-k kernel's route on CUDA
])
def test_topk_merge_bit_identical(n, k, m, shared_ids):
    ss, si, cs, ci = _inputs(n + m, n, k, m, shared_ids)
    want = jax_topk_merge(*(jnp.asarray(a) for a in (ss, si, cs, ci)), interpret=True)
    t = [torch.from_numpy(a) for a in (ss, si, cs, ci)]
    before = topk_merge_cuda.launches
    _same(topk_merge(*t, device="cpu"), want)
    assert topk_merge_cuda.launches == before   # the plain version ran
    _same(topk_merge_plain(*t), want)
    ids = t[3].expand(n, m) if shared_ids else t[3]
    _same(insert_candidates(t[0], t[1], t[2], ids), want)


@pytest.mark.parametrize("chunk", [1, 17, 32, 64])
def test_chunked_merge_equals_one_shot(chunk):
    ss, si, cs, ci = (torch.from_numpy(a) for a in _inputs(9, 48, 7, 150, False))
    one = topk_merge(ss, si, cs, ci, device="cpu")
    s, i = ss, si
    for c0 in range(0, cs.shape[1], chunk):
        s, i = topk_merge(s, i, cs[:, c0 : c0 + chunk], ci[:, c0 : c0 + chunk], device="cpu")
    _same((s, i), one)


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 16), (2, 128), (3, 150), (4, 256)])
def test_merge_topk_states_bit_identical(seed, k):
    rng = np.random.default_rng(seed)
    a_s, a_i = _state(rng, 40, k)
    b_s, b_i = _state(rng, 40, k)
    b_s[::3] = a_s[::3]   # whole rows tied between the shards
    want = jax_merge_states(JaxState(jnp.asarray(a_s), jnp.asarray(a_i)),
                            JaxState(jnp.asarray(b_s), jnp.asarray(b_i)))
    a = TopKState(torch.from_numpy(a_s), torch.from_numpy(a_i))
    b = TopKState(torch.from_numpy(b_s), torch.from_numpy(b_i))
    got = merge_topk_states(a, b)
    _same((got.scores, got.ids), (want.scores, want.ids))
    _same(topk_merge_plain(a.scores, a.ids, b.scores, b.ids), (want.scores, want.ids))


@pytest.mark.parametrize("nr,ns,dim,br,bs,k", [
    (70, 90, 640, 64, 64, 5),
    (40, 300, 512, 32, 96, 7),
])
def test_unfused_path_equals_knn_topk(nr, ns, dim, br, bs, k):
    """knn_score, the > 0 mask, then topk_merge == the fused op (the path
    tests/test_knn_topk.py holds the JAX fused kernel to)."""
    R = synthetic_sparse(nr, dim=dim, nnz_mean=15, nnz_std=4, seed=160)
    S = synthetic_sparse(ns, dim=dim, nnz_mean=15, nnz_std=4, seed=6300)
    fused = knn_topk(R, S, k=k, block_r=br, block_s=bs, device="cpu")
    sc = knn_score(R, S, block_r=br, block_s=bs, device="cpu")
    st = init_topk(nr, k, device="cpu")
    got = topk_merge(st.scores, st.ids, torch.where(sc > 0, sc, float("-inf")),
                     torch.arange(ns, dtype=torch.int32), device="cpu")
    _same(got, (fused.scores, fused.ids))


@pytest.mark.parametrize("k", [7, 150])
def test_score_then_merge_windows_equal_one_shot(k):
    """score_then_merge over a stack of 19 S blocks, walked in windows of 1
    and 3 blocks, equals one window over the whole stack bit for bit (and,
    at k <= 128, the fused kernel's plain version).  S holds tied rows, and
    its blocks' active lists differ."""
    nr, br, bs, dim = 40, 32, 16, 32768
    R = synthetic_sparse(nr, dim=dim, nnz_mean=40, nnz_std=4, seed=41)
    S = doubled(synthetic_sparse(150, dim=dim, nnz_mean=5, nnz_std=1, seed=42))
    r_tiles = _pad_rows(dense_tiles_with_sentinel(R, 128), br)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(S, 128), bs)
    active = torch.as_tensor(active_lists(tile_occupancy(R, 128).numpy(),
                                          tile_occupancy(S, 128).numpy(), br, bs))
    valid, ids = column_meta(S.num_vectors, s_tiles.shape[1], device="cpu")
    init_s, init_i = pad_state(init_topk(nr, k, device="cpu"), r_tiles.shape[1])
    args = (r_tiles, s_tiles, active, valid, ids, init_s, init_i)
    assert s_tiles.shape[1] == 19 * bs and not (active[:, :1] == active).all()
    one = score_then_merge(*args, block_r=br, block_s=bs)
    pairs = r_tiles.shape[1] * bs
    for blocks in (1, 3):
        _same(score_then_merge(*args, block_r=br, block_s=bs, max_scores=blocks * pairs), one)
    assert (one[1][:nr] >= 3 * bs).any()   # columns past the first windows entered
    if k <= 128:
        _same(knn_topk_fused(*args, block_r=br, block_s=bs)[:2], one)



# The k <= 128 CUDA kernel for M >= SPLIT_MIN_M splits each row into eight
# slices (csrc/topk_merge.cu, topk_merge_split_kernel): each slice merged
# into an empty state of its own, then the incoming state takes the eight
# partial states in slice order.  A plain model of that split, held to the
# plain version and to the JAX package bit for bit.
SPLIT_WARPS = 8


def _split_slices(m, first_aligned):
    """The kernel's slices [lo, hi): 0, then first_aligned + w * len, len a
    multiple of 4 (the row's 16-byte grid starts at column first_aligned)."""
    length = (-(-m // SPLIT_WARPS) + 3) & ~3
    edges = ([0] + [min(m, first_aligned + w * length) for w in range(1, SPLIT_WARPS)]
             + [m])
    return list(zip(edges[:-1], edges[1:]))


def _split_merge_model(ss, si, cs, ci, first_aligned):
    n, m = cs.shape
    ids = ci[None, :].expand(n, m) if ci.dim() == 1 else ci
    empty = (torch.full_like(ss, float("-inf")), torch.full_like(si, -1))
    s, i = ss, si
    for lo, hi in _split_slices(m, first_aligned):   # in slice order: earlier slices win ties
        part = insert_candidates(*empty, cs[:, lo:hi], ids[:, lo:hi])
        s, i = insert_candidates(s, i, *part)
    return s, i


def test_split_slices_cover_the_row_on_its_grid():
    for m in (1001, 1024, 1027, 10_240):
        for a0 in range(4):
            sl = _split_slices(m, a0)
            assert sl[0][0] == 0 and sl[-1][1] == m
            assert all(hi == lo2 for (_, hi), (lo2, _) in zip(sl, sl[1:]))
            assert all((lo - a0) % 4 == 0 for lo, hi in sl[1:] if lo < m)


@pytest.mark.parametrize("n,k,m,shared_ids,kind,first_aligned", [
    (24, 5, 1001, True, "mixed", 0),     # M not a multiple of 4 or of 8
    (24, 5, 1001, False, "mixed", 3),    # a row start off the 16-byte grid
    (16, 8, 1024, True, "ties", 0),      # every candidate tied: ties across slices
    (16, 33, 1027, False, "ties", 2),
    (20, 16, 1100, True, "neginf", 1),   # most columns -inf
    (8, 128, 1031, False, "mixed", 0),   # k = 128
])
def test_split_model_bit_identical(n, k, m, shared_ids, kind, first_aligned):
    rng = np.random.default_rng(n * m + k)
    ss, si = _state(rng, n, k)
    if kind == "ties":
        cs = np.full((n, m), 0.5, np.float32)
    else:
        cs = np.where(rng.random((n, m)) < 0.5, rng.choice(LEVELS, size=(n, m)),
                      rng.random((n, m))).astype(np.float32)
        if kind == "neginf":
            cs[rng.random((n, m)) < 0.9] = -np.inf
    ci = (np.arange(1000, 1000 + m, dtype=np.int32) if shared_ids
          else rng.integers(1000, 5000, (n, m)).astype(np.int32))
    t = [torch.from_numpy(a) for a in (ss, si, cs, ci)]
    want = jax_topk_merge(*(jnp.asarray(a) for a in (ss, si, cs, ci)), interpret=True)
    _same(_split_merge_model(*t, first_aligned), want)
    _same(topk_merge_plain(*t), want)
