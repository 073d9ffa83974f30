"""The port's fused-kernel join path (src/repro_torch: SparseKNNIndex with
use_kernel=True, and knn_join) against the JAX engine and the dense oracle,
on the CPU where the kernel's plain version runs.  Scores within rtol=1e-5,
atol=1e-6, ids equal outside tie groups; tiles_scored and
device_dispatches equal the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import JoinSpec as JaxSpec  # noqa: E402
from repro.core.engine import SparseKNNIndex as JaxIndex  # noqa: E402
from repro.core.reference import oracle_knn  # noqa: E402
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
from repro_torch.kernels.knn_topk.kernel import knn_topk_fused  # noqa: E402
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
