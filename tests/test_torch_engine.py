"""The port's join engine (src/repro_torch: SparseKNNIndex and knn_join)
against the JAX engine, the dense oracle and the port's own
reference_join, on the CPU where the kernels' plain versions run: the
fused-kernel IIB path (with the k > 128 route, score_then_merge, tiles
that are not a multiple of 4, and once each the approx tier, planner
calibration and the mutations) and the paper's three drivers, BF,
IIB without the kernel and IIIB, cached and streaming, with ragged
blocks, warm start and a frozen superset order.  Scores within
rtol=1e-5, atol=1e-6, ids equal outside tie groups; the work counters
equal the reference's; cached equals streaming bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import knn_join as jax_knn_join  # noqa: E402
from repro.core.engine import JoinSpec as JaxSpec  # noqa: E402
from repro.core.engine import JoinStats as JaxStats  # noqa: E402
from repro.core.engine import SparseKNNIndex as JaxIndex  # noqa: E402
from repro.core.reference import oracle_knn  # noqa: E402
from repro.sparse.datagen import spectra_like as jax_spectra  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import SparseBatch as JaxBatch  # noqa: E402
from repro.sparse.format import densify  # noqa: E402
from repro_torch.core.blocknl import knn_join  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    JoinSpec,
    JoinStats,
    SparseKNNIndex,
    plan,
)
from repro_torch.core.reference import HostCSR, reference_join  # noqa: E402
from repro_torch.core.topk import init_topk  # noqa: E402
from repro_torch.kernels.knn_score.ops import knn_score  # noqa: E402
from repro_torch.kernels.knn_topk import ops as knn_topk_ops  # noqa: E402
from repro_torch.kernels.knn_topk.kernel import MAX_K, knn_topk_fused  # noqa: E402
from repro_torch.kernels.knn_topk.ops import column_meta, knn_topk  # noqa: E402
from repro_torch.kernels.topk_merge.ops import topk_merge  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _port(batch):
    """The JAX package's batch as the port's, same bytes."""
    return from_arrays(np.asarray(batch.indices), np.asarray(batch.values),
                       np.asarray(batch.nnz), batch.dim)


@pytest.fixture(scope="module")
def rs(small_rs):
    R, S = small_rs
    osc, oid = oracle_knn(np.asarray(densify(R)), np.asarray(densify(S)), 5)
    return R, S, _port(R), _port(S), osc, oid


def _oracle(scores, osc):
    """The engine offers only score > 0 candidates; compare those entries."""
    pos = osc > 0
    np.testing.assert_allclose(np.where(pos, scores, 0.0), np.where(pos, osc, 0.0),
                               rtol=RTOL, atol=ATOL)


def test_engine_matches_jax_engine_and_oracle(rs):
    """Cached mode: one launch (here: plain call) per R block; scores, ids,
    tiles_scored and device_dispatches equal the JAX engine's."""
    R, S, pR, pS, osc, _ = rs
    jres = JaxIndex.build(S, JaxSpec(k=5, algorithm="iib", r_block=24, s_block=32,
                                     use_kernel=True)).query(R)
    spec = JoinSpec(k=5, algorithm="iib", r_block=24, s_block=32, use_kernel=True)
    res = SparseKNNIndex.build(pS, spec, device="cpu").query(pR)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    assert res.stats.tiles_scored == jres.stats.tiles_scored
    assert res.stats.device_dispatches == jres.stats.device_dispatches == 2
    assert res.stats.blocks == jres.stats.blocks
    assert res.stats.index_builds == jres.stats.index_builds == 0
    _oracle(res.scores.numpy(), osc)


def test_knn_join_matches_engine_and_oracle(rs):
    """Streaming mode (knn_join): one launch per (R block, S block) pair,
    the same result as cached mode."""
    _, _, pR, pS, osc, _ = rs
    cached = SparseKNNIndex.build(
        pS, JoinSpec(k=5, algorithm="iib", r_block=24, s_block=32, use_kernel=True),
        device="cpu").query(pR)
    stats = JoinStats()
    out = knn_join(pR, pS, 5, algorithm="iib", r_block=24, s_block=32, use_kernel=True,
                   stats=stats, device="cpu")
    assert_topk_close(out.scores.numpy(), out.ids.numpy(), cached.scores.numpy(),
                      cached.ids.numpy(), RTOL, ATOL)
    assert stats.device_dispatches == stats.blocks == 2 * 3
    _oracle(out.scores.numpy(), osc)


@pytest.mark.parametrize("r_block,s_block,k", [(20, 33, 5), (48, 80, 3), (17, 13, 12)])
def test_ragged_blocks_match_oracle(rs, r_block, s_block, k):
    """Ragged final R and S blocks in both modes stay exact."""
    R, S, pR, pS, _, _ = rs
    osc, _ = oracle_knn(np.asarray(densify(R)), np.asarray(densify(S)), k)
    spec = JoinSpec(k=k, algorithm="iib", r_block=r_block, s_block=s_block, use_kernel=True)
    cached = SparseKNNIndex.build(pS, spec, device="cpu").query(pR)
    assert cached.scores.shape == (48, k)
    _oracle(cached.scores.numpy(), osc)
    out = knn_join(pR, pS, k, algorithm="iib", r_block=r_block, s_block=s_block,
                   use_kernel=True, device="cpu")
    _oracle(out.scores.numpy(), osc)


@pytest.fixture(scope="module")
def wide_rs():
    """R 40 and S 300 rows at dim 2000: S enough for k up to 200."""
    R = jax_synthetic(40, dim=2000, nnz_mean=40, seed=0)
    S = jax_synthetic(300, dim=2000, nnz_mean=40, seed=1)
    return R, S, _port(R), _port(S)


@pytest.mark.parametrize("k", [150, 200])
def test_large_k_route_matches_jax_and_oracle(wide_rs, monkeypatch, k):
    """k > MAX_K: cached mode, streaming mode and knn_join take
    score_then_merge (the fused kernel is never called), equal the JAX
    package's knn_join and the oracle, and count dispatches as the
    reference does: one per R block cached, one per pair streaming."""
    assert k > MAX_K
    R, S, pR, pS = wide_rs

    def fused(*args, **kwargs):
        raise AssertionError("the fused kernel was called at k > MAX_K")

    monkeypatch.setattr(knn_topk_ops, "knn_topk_fused", fused)
    want = jax_knn_join(R, S, k, algorithm="iib", r_block=16, s_block=128, use_kernel=True)
    osc, _ = oracle_knn(np.asarray(densify(R)), np.asarray(densify(S)), k)
    spec = JoinSpec(k=k, algorithm="iib", r_block=16, s_block=128, use_kernel=True)
    cached = SparseKNNIndex.build(pS, spec, device="cpu").query(pR)
    streaming = SparseKNNIndex.build(pS, spec, cache_device_blocks=False, device="cpu").query(pR)
    joined = knn_join(pR, pS, k, algorithm="iib", r_block=16, s_block=128, use_kernel=True,
                      device="cpu")
    for got in (cached, streaming, joined):
        assert got.scores.shape == got.ids.shape == (40, k)
        assert_topk_close(got.scores.numpy(), got.ids.numpy(), np.asarray(want.scores),
                          np.asarray(want.ids), RTOL, ATOL)
        _oracle(got.scores.numpy(), osc)
    assert cached.stats.device_dispatches == 3
    assert streaming.stats.device_dispatches == streaming.stats.blocks == 3 * 3


@pytest.mark.parametrize("tile", [100, 126])
def test_tile_not_a_multiple_of_4_matches_jax_engine(wide_rs, tile):
    """The dense tiles are padded with zero dims to a multiple of 4 (once,
    at build, for the cached S stack); the index's own tile, and so
    tiles_scored, stay the reference's."""
    R, S, pR, pS = wide_rs
    jres = JaxIndex.build(S, JaxSpec(k=5, algorithm="iib", r_block=16, s_block=128, tile=tile,
                                     use_kernel=True)).query(R)
    spec = JoinSpec(k=5, algorithm="iib", r_block=16, s_block=128, tile=tile, use_kernel=True)
    index = SparseKNNIndex.build(pS, spec, device="cpu")
    assert index._kernel_stack.s_tiles.shape[2] == -(-tile // 4) * 4
    res = index.query(pR)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    assert res.stats.tiles_scored == jres.stats.tiles_scored
    out = knn_join(pR, pS, 5, algorithm="iib", r_block=16, s_block=128, tile=tile,
                   use_kernel=True, device="cpu")
    assert_topk_close(out.scores.numpy(), out.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)


def test_index_reused_across_queries(rs):
    """Two queries on one index: the same answer, one plain call per R block
    each, and no kernel launch counted on the CPU."""
    _, _, pR, pS, _, _ = rs
    index = SparseKNNIndex.build(
        pS, JoinSpec(k=5, algorithm="iib", r_block=16, s_block=32, use_kernel=True),
        device="cpu")
    before = knn_topk_fused.launches
    a, b = index.query(pR), index.query(pR.rows(0, 16))
    assert knn_topk_fused.launches == before
    assert a.stats.device_dispatches == 3 and b.stats.device_dispatches == 1
    assert torch.equal(a.scores[:16], b.scores) and torch.equal(a.ids[:16], b.ids)
    assert index.num_blocks == 3 and index.stats.build_wall_s > 0


def test_entry_points_need_cuda_unless_cpu_is_named(rs, monkeypatch):
    _, _, pR, pS, _, _ = rs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = JoinSpec(k=5, algorithm="iib", use_kernel=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparseKNNIndex.build(pS, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        knn_join(pR, pS, 5, algorithm="iib", use_kernel=True)


_S, _I = torch.zeros(4, 3), torch.full((4, 3), -1, dtype=torch.int32)
OPS = {  # the public ops, each on small CPU inputs
    "knn_score": lambda pR, pS, **kw: knn_score(pR, pS, block_r=16, block_s=32, **kw),
    "knn_topk": lambda pR, pS, **kw: knn_topk(pR, pS, k=5, block_r=16, block_s=32, **kw),
    "topk_merge": lambda pR, pS, **kw: topk_merge(_S, _I, torch.ones(4, 6),
                                                  torch.arange(6), **kw),
    "init_topk": lambda pR, pS, **kw: init_topk(4, 3, **kw),
    "column_meta": lambda pR, pS, **kw: column_meta(5, 8, **kw),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_ops_need_cuda_unless_cpu_is_named(rs, monkeypatch, op):
    """Every public op runs on CUDA by default: without a card it raises,
    even on CPU inputs, and runs on the CPU only when asked."""
    _, _, pR, pS, _, _ = rs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OPS[op](pR, pS)
    out = OPS[op](pR, pS, device="cpu")
    out = (out.scores, out.ids) if hasattr(out, "scores") else out
    assert {x.device.type for x in (out if isinstance(out, tuple) else (out,))} == {"cpu"}


@pytest.mark.parametrize("kwargs,build_kwargs", [
    (dict(algorithm="iib", use_kernel=True, accuracy="approx"), {}),
    (dict(algorithm="iib", use_kernel=True), dict(calibration={"c2_unit_s": 1.0})),
])
def test_approx_and_calibration_match_jax_engine(rs, kwargs, build_kwargs):
    """The two options that raised before the approx tier and the planner's
    calibration were ported: each now runs and equals the JAX engine,
    every counter included (approx: the candidate and scanned rows)."""
    R, S, pR, pS, _, _ = rs
    spec = dict(k=5, r_block=24, s_block=32, **kwargs)
    jstats, stats = JaxStats(), JoinStats()
    jres = JaxIndex.build(S, JaxSpec(**spec), **build_kwargs).query(R, stats=jstats)
    res = SparseKNNIndex.build(pS, JoinSpec(**spec), device="cpu", **build_kwargs).query(
        pR, stats=stats)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    for c in COUNTERS + ("candidate_rows", "scanned_rows"):
        assert getattr(stats, c) == getattr(jstats, c), c
    assert stats.candidate_fraction == jstats.candidate_fraction


@pytest.mark.parametrize("kwargs,build_kwargs", [
    (dict(algorithm="bf"), {}),
    (dict(algorithm="iiib"), {}),
    (dict(algorithm="iib"), {}),                       # IIB without the kernel
    (dict(algorithm="iib", use_kernel=True, warm_start=0.1), {}),
    (dict(algorithm="iib", use_kernel=True), dict(frozen_rank=np.arange(512))),
])
def test_options_now_on_the_slice_match_jax_engine(rs, kwargs, build_kwargs):
    """The options that raised before the three drivers were ported: each
    now runs and equals the JAX engine (warm_start and frozen_rank touch
    IIIB only, as in the reference)."""
    R, S, pR, pS, osc, _ = rs
    spec = dict(k=5, r_block=24, s_block=32, **kwargs)
    jres = JaxIndex.build(S, JaxSpec(**spec), **build_kwargs).query(R)
    res = SparseKNNIndex.build(pS, JoinSpec(**spec), device="cpu", **build_kwargs).query(pR)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    assert res.stats.device_dispatches == jres.stats.device_dispatches
    assert res.stats.tiles_scored == jres.stats.tiles_scored
    _oracle(res.scores.numpy(), osc)


@pytest.mark.parametrize("method,args", [
    ("extend", (None,)), ("delete", ([0],)), ("expire", (0.0,)), ("compact", ()),
    ("refreeze", ()),
])
def test_mutations_match_jax_engine(rs, method, args):
    """The five mutations that raised before they were ported: each now runs
    on the fused-kernel index as on the JAX engine's (``extend``'s batch,
    None before, is S's last 30 rows on an index over the first 50), and
    an approx query on this exact-built index raises ValueError, as there."""
    R, S, pR, pS, _, _ = rs
    spec = dict(k=5, algorithm="iib", use_kernel=True)
    j_build, p_build, j_args, p_args = S, pS, args, args
    if method == "extend":
        j_build = JaxBatch(indices=S.indices[:50], values=S.values[:50], nnz=S.nnz[:50],
                           dim=S.dim)
        p_build = pS.rows(0, 50)
        j_args = (JaxBatch(indices=S.indices[50:], values=S.values[50:], nnz=S.nnz[50:],
                           dim=S.dim),)
        p_args = (pS.rows(50, 80),)
    jidx = JaxIndex.build(j_build, JaxSpec(**spec))
    index = SparseKNNIndex.build(p_build, JoinSpec(**spec), device="cpu")
    j_out, p_out = getattr(jidx, method)(*j_args), getattr(index, method)(*p_args)
    if isinstance(j_out, int):
        assert p_out == j_out
    assert (index.num_vectors, index.live_rows) == (jidx.num_vectors, jidx.live_rows)
    assert index.stats.index_builds == jidx.stats.index_builds
    jstats, stats = JaxStats(), JoinStats()
    jres, res = jidx.query(R, stats=jstats), index.query(pR, stats=stats)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    assert {c: getattr(stats, c) for c in COUNTERS} == {c: getattr(jstats, c) for c in COUNTERS}
    with pytest.raises(ValueError):
        jidx.query(R, accuracy="approx")
    with pytest.raises(ValueError):
        index.query(pR, accuracy="approx")


def test_planner_matches_reference(rs):
    R, S, pR, pS, _, _ = rs
    from repro.core.engine import plan as jax_plan

    for spec_kw in (dict(k=5, use_kernel=True), dict(k=5, s_block=30), dict(k=5)):
        got = plan(pR, pS, JoinSpec(**spec_kw))
        want = jax_plan(R, S, JaxSpec(**spec_kw))
        assert (got.algorithm, got.r_block, got.s_block) == (
            want.algorithm, want.r_block, want.s_block)
        assert got.cost_bf == pytest.approx(want.cost_bf)
        assert got.cost_iib == pytest.approx(want.cost_iib)


# ---------------------------------------------------------------------------
# the paper's three drivers through the engine: BF, IIB without the fused
# kernel, IIIB with its masked superset index
# ---------------------------------------------------------------------------

COUNTERS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
            "device_dispatches", "host_syncs")


def _host(batch):
    return HostCSR.from_padded(batch.indices.numpy(), batch.values.numpy(), batch.nnz.numpy(),
                               batch.dim)


def _same_counters(got: JoinStats, want):
    assert {c: getattr(got, c) for c in COUNTERS} == {c: getattr(want, c) for c in COUNTERS}
    assert len(got.min_prune_trace) == len(want.min_prune_trace)
    for g, w in zip(got.min_prune_trace, want.min_prune_trace):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algorithm", ["bf", "iib", "iiib"])
@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("r_block,s_block", [(24, 32), (20, 33)])
def test_drivers_match_jax_engine_oracle_and_reference(rs, algorithm, cached, r_block, s_block):
    """Each driver, cached and streaming, with even and ragged blocks:
    scores and ids equal the JAX engine's (tolerance, ids outside tie
    groups), every JoinStats counter equals its count, and the result
    agrees with the dense oracle and the port's own reference_join."""
    R, S, pR, pS, osc, _ = rs
    spec = dict(k=5, algorithm=algorithm, r_block=r_block, s_block=s_block)
    jstats, stats = JaxStats(), JoinStats()
    jres = JaxIndex.build(S, JaxSpec(**spec), cache_device_blocks=cached).query(R, stats=jstats)
    index = SparseKNNIndex.build(pS, JoinSpec(**spec), cache_device_blocks=cached, device="cpu")
    res = index.query(pR, stats=stats)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    _same_counters(stats, jstats)
    _oracle(res.scores.numpy(), osc)
    ref_s, _ = reference_join(_host(pR), _host(pS), 5, algorithm=algorithm, r_block=r_block,
                              s_block=s_block)
    _oracle(res.scores.numpy(), np.where(ref_s > 0, ref_s, 0.0))
    if cached and algorithm != "bf":
        assert index.stats.index_builds == index.num_blocks


@pytest.mark.parametrize("algorithm", ["bf", "iib", "iiib"])
@pytest.mark.parametrize("r_block,s_block", [(24, 32), (20, 33), (48, 80)])
def test_cached_equals_streaming_bit_for_bit(rs, algorithm, r_block, s_block):
    """The cached walk and the per-pair loop give identical arrays (the
    reference's test_scanned_driver_matches_per_pair_loop); the cached
    drivers make one dispatch and one host sync per R block."""
    _, _, pR, pS, _, _ = rs
    spec = JoinSpec(k=5, algorithm=algorithm, r_block=r_block, s_block=s_block)
    cached, stream = JoinStats(), JoinStats()
    a = SparseKNNIndex.build(pS, spec, device="cpu").query(pR, stats=cached)
    b = SparseKNNIndex.build(pS, spec, cache_device_blocks=False, device="cpu").query(
        pR, stats=stream)
    assert torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)
    r_blocks = -(-48 // r_block)
    assert cached.device_dispatches == cached.host_syncs == r_blocks
    assert stream.device_dispatches >= r_blocks * -(-80 // s_block)
    assert cached.list_entries == stream.list_entries
    knn = knn_join(pR, pS, 5, algorithm=algorithm, r_block=r_block, s_block=s_block,
                   device="cpu")
    assert torch.equal(knn.scores, b.scores) and torch.equal(knn.ids, b.ids)


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("warm_start,seed", [(0.0, 0), (0.2, 0), (0.2, 7)])
@pytest.mark.parametrize("frozen", [False, True])
def test_iiib_warm_start_and_frozen_rank_match_jax_engine(rs, cached, warm_start, seed, frozen):
    """IIIB with a warm-start sample (the reference's sampler and seed) and
    with a frozen superset order (here the identity): the JAX engine's
    result, counters and threshold traces."""
    R, S, pR, pS, osc, _ = rs
    spec = dict(k=5, algorithm="iiib", r_block=24, s_block=20, warm_start=warm_start, seed=seed)
    rank = np.arange(512, dtype=np.int32) if frozen else None
    jstats, stats = JaxStats(), JoinStats()
    jres = JaxIndex.build(S, JaxSpec(**spec), cache_device_blocks=cached,
                          frozen_rank=rank).query(R, stats=jstats)
    res = SparseKNNIndex.build(pS, JoinSpec(**spec), cache_device_blocks=cached, device="cpu",
                               frozen_rank=rank).query(pR, stats=stats)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    _same_counters(stats, jstats)
    _oracle(res.scores.numpy(), osc)
    if warm_start and cached:
        # the sample seeds MinPruneScore: live from the first block
        assert all(t[0] > -np.inf for t in stats.min_prune_trace)


def test_iiib_threshold_monotone_and_live_on_ragged_r_block(rs):
    """The MinPruneScore carried through the walk only rises, and a ragged
    final R block's padding rows do not pin it at -inf (the reference's
    test_iiib_threshold_live_on_ragged_r_block); cached equals streaming."""
    _, _, pR, pS, _, _ = rs
    for ws in (0.0, 0.2):
        spec = JoinSpec(k=5, algorithm="iiib", r_block=20, s_block=20, warm_start=ws)
        stats = JoinStats()
        res = SparseKNNIndex.build(pS, spec, device="cpu").query(pR, stats=stats)
        assert len(stats.min_prune_trace) == 3               # blocks of 20, 20, 8
        for trace in stats.min_prune_trace:
            assert trace.shape == (5,)                       # seed + 4 S blocks
            assert np.all(np.diff(trace) >= 0) and trace[-1] > -np.inf
        stream = SparseKNNIndex.build(pS, spec, cache_device_blocks=False,
                                      device="cpu").query(pR)
        assert torch.equal(res.scores, stream.scores) and torch.equal(res.ids, stream.ids)


def test_iiib_mask_prunes_entries_as_the_reference():
    """The reference's test_iiib_mask_prunes_entries data: the mask keeps
    fewer entries than the superset holds, the same count as the
    reference's, and a warm start keeps no more."""
    R = jax_synthetic(64, dim=4096, nnz_mean=24, nnz_std=6, seed=0)
    S = jax_synthetic(256, dim=4096, nnz_mean=24, nnz_std=6, seed=1)
    pR, pS = _port(R), _port(S)
    osc, _ = oracle_knn(np.asarray(densify(R)), np.asarray(densify(S)), 3)
    kept = {}
    for ws in (0.0, 0.25):
        spec = dict(k=3, algorithm="iiib", r_block=64, s_block=64, warm_start=ws)
        index = SparseKNNIndex.build(pS, JoinSpec(**spec), device="cpu")
        stats, jstats = JoinStats(), JaxStats()
        res = index.query(pR, stats=stats)
        JaxIndex.build(S, JaxSpec(**spec)).query(R, stats=jstats)
        assert stats.list_entries == jstats.list_entries
        assert stats.list_entries < sum(b.list_total for b in index._blocks)
        kept[ws] = stats.list_entries
        _oracle(res.scores.numpy(), osc)
    assert kept[0.25] <= kept[0.0]


@pytest.mark.parametrize("algorithm", ["bf", "iib", "iiib"])
def test_spectra_drivers_match_jax_engine(algorithm):
    """Spectra-shaped data (30 x 50 at dim 2000), cached and streaming."""
    R, S = jax_spectra(30, dim=2000, seed=0), jax_spectra(50, dim=2000, seed=1)
    pR, pS = _port(R), _port(S)
    osc, _ = oracle_knn(np.asarray(densify(R)), np.asarray(densify(S)), 5)
    spec = dict(k=5, algorithm=algorithm, r_block=16, s_block=16)
    for cached in (True, False):
        jstats, stats = JaxStats(), JoinStats()
        jres = JaxIndex.build(S, JaxSpec(**spec), cache_device_blocks=cached).query(
            R, stats=jstats)
        res = SparseKNNIndex.build(pS, JoinSpec(**spec), cache_device_blocks=cached,
                                   device="cpu").query(pR, stats=stats)
        assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                          np.asarray(jres.ids), RTOL, ATOL)
        _same_counters(stats, jstats)
        _oracle(res.scores.numpy(), osc)


def test_knn_join_default_algorithm_runs(rs):
    """knn_join's default algorithm is IIIB, as the reference's."""
    R, S, pR, pS, osc, _ = rs
    stats = JoinStats()
    out = knn_join(pR, pS, 5, r_block=24, s_block=32, stats=stats, device="cpu")
    want = jax_knn_join(R, S, 5, r_block=24, s_block=32)
    assert_topk_close(out.scores.numpy(), out.ids.numpy(), np.asarray(want.scores),
                      np.asarray(want.ids), RTOL, ATOL)
    assert stats.index_builds == 2 * 3 and len(stats.min_prune_trace) == 0
    _oracle(out.scores.numpy(), osc)


def test_planner_picks_a_driver_that_runs(rs):
    """With the algorithm left open the planner picks BF or IIIB; both run."""
    _, _, pR, pS, osc, _ = rs
    for s_block in (32, 80):
        index = SparseKNNIndex.build(pS, JoinSpec(k=5, s_block=s_block), device="cpu")
        assert index.algorithm in ("bf", "iiib")
        _oracle(index.query(pR).scores.numpy(), osc)
