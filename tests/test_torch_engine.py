"""The port's fused-kernel join path (src/repro_torch: SparseKNNIndex with
use_kernel=True, and knn_join) against the JAX engine and the dense oracle,
on the CPU where the kernel's plain version runs.  Scores within rtol=1e-5,
atol=1e-6, ids equal outside tie groups; tiles_scored and
device_dispatches equal the reference's.  Also the k > 128 route
(score_then_merge) and tiles that are not a multiple of 4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import knn_join as jax_knn_join  # noqa: E402
from repro.core.engine import JoinSpec as JaxSpec  # noqa: E402
from repro.core.engine import SparseKNNIndex as JaxIndex  # noqa: E402
from repro.core.reference import oracle_knn  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import densify  # noqa: E402
from repro_torch.core.blocknl import knn_join  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    JoinSpec,
    JoinStats,
    SparseKNNIndex,
    plan,
)
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
    (dict(algorithm="bf"), {}),
    (dict(algorithm="iiib"), {}),
    (dict(algorithm="iib"), {}),                       # IIB without the kernel
    (dict(algorithm="iib", use_kernel=True, accuracy="approx"), {}),
    (dict(algorithm="iib", use_kernel=True, warm_start=0.1), {}),
    (dict(algorithm="iib", use_kernel=True), dict(calibration={"c2_unit_s": 1.0})),
    (dict(algorithm="iib", use_kernel=True), dict(frozen_rank=np.arange(512))),
])
def test_options_off_the_slice_raise(rs, kwargs, build_kwargs):
    _, _, _, pS, _, _ = rs
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue"):
        SparseKNNIndex.build(pS, JoinSpec(k=5, **kwargs), device="cpu", **build_kwargs)


@pytest.mark.parametrize("method,args", [
    ("extend", (None,)), ("delete", ([0],)), ("expire", (0.0,)), ("compact", ()),
    ("refreeze", ()),
])
def test_mutations_raise(rs, method, args):
    _, _, pR, pS, _, _ = rs
    index = SparseKNNIndex.build(pS, JoinSpec(k=5, algorithm="iib", use_kernel=True),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue"):
        getattr(index, method)(*args)
    with pytest.raises(NotImplementedError):
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
