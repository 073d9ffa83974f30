"""The datastore's lifecycle in the port (src/repro_torch/core/engine.py)
against the JAX engine on the same seeded inputs, on the CPU: extend (a
wider feature axis, a block-aligned tail, a partial tail block), delete
(duplicates, idempotence), TTL expiry, compact (the all-dead stub,
``last_compact_keep``), refreeze (with and without ``frozen_rank``), the
warm start after deletes, and planner calibration (a dict and a JSON
file), for each of bf, iib, iib with the fused kernel and iiib, cached
and streaming.

Tolerances: scores within rtol=1e-5, atol=1e-6 and ids equal outside tie
groups (``assert_topk_close``); bit for bit where the reference's own
test is (extend against the concatenated build, cached against
streaming); ``index_builds``, ``live_rows``/``dead_rows``, ``dim_freq``,
``max_weight`` and every ``JoinStats`` counter equal."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import JoinSpec as JaxSpec  # noqa: E402
from repro.core.engine import JoinStats as JaxStats  # noqa: E402
from repro.core.engine import SparseKNNIndex as JaxIndex  # noqa: E402
from repro.core.engine import plan as jax_plan  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import SparseBatch as JaxBatch  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    JoinSpec,
    JoinStats,
    SparseKNNIndex,
    load_calibration,
    plan,
)
from repro_torch.sparse.format import from_arrays  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
COUNTERS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
            "device_dispatches", "host_syncs", "candidate_rows", "scanned_rows")
# (algorithm, use_kernel): the paper's three drivers and the fused IIB path
PATHS = [("bf", False), ("iib", False), ("iib", True), ("iiib", False)]
PATH_IDS = ["bf", "iib", "iib-kernel", "iiib"]


def _port(batch):
    """The JAX package's batch as the port's, same bytes."""
    return from_arrays(np.asarray(batch.indices), np.asarray(batch.values),
                       np.asarray(batch.nnz), batch.dim)


def _rows(sb, rows):
    """Rows of a JAX batch (a slice or an index array)."""
    return JaxBatch(indices=jnp.asarray(np.asarray(sb.indices)[rows]),
                    values=jnp.asarray(np.asarray(sb.values)[rows]),
                    nnz=jnp.asarray(np.asarray(sb.nnz)[rows]), dim=sb.dim)


def _pair(S, spec_kw, cached=True, **build_kw):
    """(JAX index, port index) over the same S with the same spec."""
    return (JaxIndex.build(S, JaxSpec(**spec_kw), cache_device_blocks=cached, **build_kw),
            SparseKNNIndex.build(_port(S), JoinSpec(**spec_kw), cache_device_blocks=cached,
                                 device="cpu", **build_kw))


def _same_query(jidx, pidx, R, accuracy=None):
    """Query both indexes with R: results within tolerance, every counter
    and the threshold traces equal.  Returns the port's result."""
    jstats, stats = JaxStats(), JoinStats()
    jres = jidx.query(R, stats=jstats, accuracy=accuracy)
    res = pidx.query(_port(R), stats=stats, accuracy=accuracy)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    assert {c: getattr(stats, c) for c in COUNTERS} == {c: getattr(jstats, c) for c in COUNTERS}
    assert len(stats.min_prune_trace) == len(jstats.min_prune_trace)
    for g, w in zip(stats.min_prune_trace, jstats.min_prune_trace):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
    return res


def _same_state(jidx, pidx):
    """The datastore's state: sizes, liveness, statistics, builds."""
    assert (pidx.num_vectors, pidx.num_blocks) == (jidx.num_vectors, jidx.num_blocks)
    assert (pidx.live_rows, pidx.dead_rows) == (jidx.live_rows, jidx.dead_rows)
    assert pidx.stats.index_builds == jidx.stats.index_builds
    np.testing.assert_array_equal(pidx.dim_freq, jidx.dim_freq)
    np.testing.assert_array_equal(pidx.max_weight, jidx.max_weight)
    assert pidx.occupied_tiles == jidx.occupied_tiles
    if pidx.algorithm == "iiib":
        np.testing.assert_array_equal(pidx._rank_np, jidx._rank_np)


def _spec(alg, kernel, **kw):
    return dict(k=5, algorithm=alg, use_kernel=kernel, r_block=24, s_block=32, **kw)


# ---------------------------------------------------------------------------
# extend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_extend_matches_jax_engine_and_concatenated_build(small_rs, alg, kernel, cached):
    """Build on 50 rows, extend by 30 (the partial block 1 is rebuilt, block
    2 is new): the JAX engine's result, counters and state; bit for bit the
    port's build over all 80 rows (IIIB: with that build's frozen rank)."""
    R, S = small_rs
    spec = _spec(alg, kernel)
    full = SparseKNNIndex.build(_port(S), JoinSpec(**spec), cache_device_blocks=cached,
                                device="cpu")
    rank = full._rank_np
    jidx, pidx = _pair(_rows(S, slice(0, 50)), spec, cached, frozen_rank=rank)
    jidx.extend(_rows(S, slice(50, 80)))
    assert pidx.extend(_port(S).rows(50, 80)) is pidx
    _same_state(jidx, pidx)
    if cached and alg != "bf" and not kernel:
        assert pidx.stats.index_builds == 2 + 2      # blocks 0, 1; then 1, 2
    res = _same_query(jidx, pidx, R)
    want = full.query(_port(R))
    assert torch.equal(res.scores, want.scores) and torch.equal(res.ids, want.ids)


@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_extend_wider_feature_axis_matches_jax_engine(small_rs, alg, kernel):
    """New rows with more features a row widen the host mirrors and the BF
    and kernel stacks' feature axis (the reference's
    test_extend_unifies_feature_width); cached equals streaming."""
    R, S = small_rs
    extra = jax_synthetic(24, dim=512, nnz_mean=35, nnz_std=5, seed=9)
    assert extra.max_features != S.max_features
    spec = _spec(alg, kernel)
    results = []
    for cached in (True, False):
        jidx, pidx = _pair(S, spec, cached)
        jidx.extend(extra)
        pidx.extend(_port(extra))
        assert pidx._idx.shape == jidx._idx.shape
        _same_state(jidx, pidx)
        results.append(_same_query(jidx, pidx, R))
    assert torch.equal(results[0].scores, results[1].scores)
    assert torch.equal(results[0].ids, results[1].ids)


@pytest.mark.parametrize("alg", ["iib", "iiib"])
def test_extend_rebuilds_only_tail_blocks(small_rs, alg):
    """A block-aligned old tail adds one block; a partial one is rebuilt in
    place and starts no new block: index_builds as the reference counts."""
    R, S = small_rs
    spec = dict(k=5, algorithm=alg, s_block=32, r_block=24)
    jidx, pidx = _pair(_rows(S, slice(0, 64)), spec)
    assert pidx.stats.index_builds == jidx.stats.index_builds == 2
    jidx.extend(_rows(S, slice(64, 80)))
    pidx.extend(_port(S).rows(64, 80))
    assert pidx.stats.index_builds == jidx.stats.index_builds == 3
    extra = jax_synthetic(8, dim=512, nnz_mean=20, seed=3)
    jidx.extend(extra)
    pidx.extend(_port(extra))
    assert pidx.num_blocks == 3 and pidx.stats.index_builds == jidx.stats.index_builds == 4
    _same_state(jidx, pidx)
    _same_query(jidx, pidx, R)


def test_extend_pads_the_retained_index_prefix():
    """When the new blocks' lists are longer, the retained IIB stack prefix
    is padded to the new list width with sentinel rows and zero values:
    equal to the full build's stack, which built it at that width."""
    sparse = jax_synthetic(256, dim=512, nnz_mean=1, nnz_std=0, seed=4)    # lists <= 128
    dense = jax_synthetic(256, dim=512, nnz_mean=20, nnz_std=5, seed=5)    # lists > 128
    spec = JoinSpec(k=5, algorithm="iib", s_block=256)
    grown = SparseKNNIndex.build(_port(sparse), spec, device="cpu")
    assert grown._iib_stack.max_rows == 128
    grown.extend(_port(dense))
    assert grown._iib_stack.max_rows == 256 and grown.stats.index_builds == 2
    # the host mirrors after extend are the row-concatenation (features padded)
    full = SparseKNNIndex.build(from_arrays(grown._idx, grown._val, grown._nnz, 512), spec,
                                device="cpu")
    for name in ("rows", "vals", "counts"):
        assert torch.equal(getattr(grown._iib_stack, name), getattr(full._iib_stack, name)), name
    jidx = JaxIndex.build(sparse, JaxSpec(k=5, algorithm="iib", s_block=256)).extend(dense)
    _same_query(jidx, grown, jax_synthetic(30, dim=512, nnz_mean=20, seed=6))


def test_extend_rejects_another_dim(small_rs):
    _, S = small_rs
    index = SparseKNNIndex.build(_port(S), JoinSpec(k=5, algorithm="bf"), device="cpu")
    with pytest.raises(ValueError):
        index.extend(_port(jax_synthetic(4, dim=256, nnz_mean=10, seed=0)))


# ---------------------------------------------------------------------------
# tombstones: delete, expire, compact
# ---------------------------------------------------------------------------

DEAD = [0, 7, 33, 79]


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_delete_and_compact_match_jax_engine(small_rs, alg, kernel, cached):
    """delete(): duplicates counted once, idempotent, no index build, the
    JAX engine's result; equal to a build without the rows (ids mapped);
    compact(): the real rebuild, ids shifted to the survivors' positions,
    bit for bit that build."""
    R, S = small_rs
    spec = _spec(alg, kernel)
    keep = np.setdiff1d(np.arange(S.num_vectors), DEAD)
    jidx, pidx = _pair(S, spec, cached)
    builds = pidx.stats.index_builds
    assert pidx.delete([DEAD[0]] * 3) == jidx.delete([DEAD[0]] * 3) == 1
    assert pidx.delete(DEAD) == jidx.delete(DEAD) == 3
    assert pidx.delete(DEAD) == jidx.delete(DEAD) == 0
    assert pidx.stats.index_builds == builds, "delete built an index"
    assert (pidx.live_rows, pidx.dead_rows) == (76, 4)
    _same_state(jidx, pidx)
    res = _same_query(jidx, pidx, R)
    assert not np.isin(res.ids.numpy(), DEAD).any()

    fresh = SparseKNNIndex.build(_port(_rows(S, keep)), JoinSpec(**spec),
                                 cache_device_blocks=cached, device="cpu",
                                 frozen_rank=pidx._rank_np).query(_port(R))
    ok = fresh.scores.numpy() > -np.inf
    assert_topk_close(res.scores.numpy(), np.where(ok, res.ids.numpy(), -1),
                      fresh.scores.numpy(), np.where(ok, keep[fresh.ids.numpy()], -1), RTOL, ATOL)

    assert pidx.compact() == jidx.compact() == 4
    np.testing.assert_array_equal(pidx.last_compact_keep, jidx.last_compact_keep)
    _same_state(jidx, pidx)
    res_c = _same_query(jidx, pidx, R)
    assert torch.equal(res_c.scores, fresh.scores) and torch.equal(res_c.ids, fresh.ids)
    assert pidx.compact() == jidx.compact() == 0
    assert pidx.last_compact_keep.all()


def test_delete_rejects_out_of_range_ids(small_rs):
    _, S = small_rs
    index = SparseKNNIndex.build(_port(S), JoinSpec(k=5, algorithm="iib"), device="cpu")
    for bad in ([-1], [80], [3, 200]):
        with pytest.raises(IndexError):
            index.delete(bad)
    assert index.dead_rows == 0


def test_delete_is_one_upload_of_the_valid_masks(small_rs):
    """delete() changes only the valid masks: the kernel stack's col_valid
    gets the holes, its tiles, ids and occupancy stay the same tensors."""
    _, S = small_rs
    index = SparseKNNIndex.build(_port(S), JoinSpec(**_spec("iib", True)), device="cpu")
    ks = index._kernel_stack
    tiles, ids, occ = ks.s_tiles, ks.col_ids, ks.s_occ
    index.delete(DEAD)
    assert index._kernel_stack.s_tiles is tiles and index._kernel_stack.col_ids is ids
    assert index._kernel_stack.s_occ is occ
    col_valid = index._kernel_stack.col_valid[0].numpy()
    assert col_valid[DEAD].sum() == 0 and col_valid[:80].sum() == 76 and col_valid[80:].sum() == 0


@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_compact_all_dead_keeps_a_stub(small_rs, alg, kernel):
    """Every row dead: compact keeps one still-tombstoned stub row, as the
    reference does; every query then returns nothing."""
    R, S = small_rs
    spec = _spec(alg, kernel)
    for cached in (True, False):
        jidx, pidx = _pair(S, spec, cached)
        assert pidx.delete(np.arange(80)) == jidx.delete(np.arange(80)) == 80
        res = _same_query(jidx, pidx, R)
        assert (res.ids.numpy() == -1).all()
        assert pidx.compact() == jidx.compact() == 79
        np.testing.assert_array_equal(pidx.last_compact_keep, jidx.last_compact_keep)
        assert (pidx.num_vectors, pidx.live_rows) == (1, 0)
        _same_state(jidx, pidx)
        res = _same_query(jidx, pidx, R)
        assert (res.ids.numpy() == -1).all() and np.isneginf(res.scores.numpy()).all()


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
def test_ttl_expiry_and_warm_start_skip_dead(small_rs, cached):
    """extend(deadline=) rows vanish after expire(now) (deadline inclusive);
    the warm-start sampler draws live rows only, with the reference's RNG
    call, so the traces and kept counts equal the JAX engine's."""
    R, S = small_rs
    spec = dict(k=5, algorithm="iiib", r_block=24, s_block=32, warm_start=0.2)
    jidx, pidx = _pair(S, spec, cached)
    base = _same_query(jidx, pidx, R)
    extra = jax_synthetic(16, dim=S.dim, nnz_mean=20, seed=9)
    jidx.extend(extra, deadline=50.0)
    pidx.extend(_port(extra), deadline=50.0)
    assert pidx.expire(now=10.0) == jidx.expire(now=10.0) == 0
    _same_query(jidx, pidx, R)
    assert pidx.expire(now=50.0) == jidx.expire(now=50.0) == 16
    _same_state(jidx, pidx)
    res = _same_query(jidx, pidx, R)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), base.scores.numpy(),
                      base.ids.numpy(), RTOL, 1e-5)
    assert not np.isin(res.ids.numpy(), np.arange(80, 96)).any()


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
@pytest.mark.parametrize("seed", [0, 7])
def test_warm_start_after_deletes_matches_jax_engine(small_rs, cached, seed):
    """The warm-start sample after deletes: the same live rows as the
    reference's sampler (the traces, kept counts and dense pairs equal)."""
    R, S = small_rs
    spec = dict(k=5, algorithm="iiib", r_block=24, s_block=20, warm_start=0.25, seed=seed)
    jidx, pidx = _pair(S, spec, cached)
    dead = np.arange(0, 80, 3)
    assert pidx.delete(dead) == jidx.delete(dead) == dead.size
    res = _same_query(jidx, pidx, R)
    assert not np.isin(res.ids.numpy(), dead).any()
    assert all(t[0] > -np.inf for t in res.stats.min_prune_trace)


@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_mutation_sequence_matches_jax_engine(small_rs, alg, kernel):
    """One sequence through both engines, cached and streaming: extend,
    delete, extend with a TTL, expire, compact, extend again; after every
    step the same result, counters and state; cached equals streaming."""
    R, S = small_rs
    spec = _spec(alg, kernel)
    extra = jax_synthetic(20, dim=S.dim, nnz_mean=22, seed=11)
    out = {}
    for cached in (True, False):
        jidx, pidx = _pair(_rows(S, slice(0, 40)), spec, cached)
        steps = []
        for name, op in (
            ("extend", lambda x, conv: x.extend(conv(_rows(S, slice(40, 80))))),
            ("delete", lambda x, conv: x.delete([1, 5, 41, 60])),
            ("ttl", lambda x, conv: x.extend(conv(extra), deadline=np.arange(20.0))),
            ("expire", lambda x, conv: x.expire(now=9.5)),
            ("compact", lambda x, conv: x.compact()),
            ("extend2", lambda x, conv: x.extend(conv(_rows(S, slice(0, 12))))),
        ):
            j_out = op(jidx, lambda b: b)
            p_out = op(pidx, _port)
            if isinstance(j_out, int):
                assert p_out == j_out, name
            _same_state(jidx, pidx)
            steps.append(_same_query(jidx, pidx, R))
        out[cached] = steps
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)


# ---------------------------------------------------------------------------
# refreeze
# ---------------------------------------------------------------------------

def _drift_batch(n, pools_counts, weights, seed, dim=2048):
    """The reference's test_refreeze_recovers_prune_rate data."""
    rng = np.random.default_rng(seed)
    rows_i, rows_v = [], []
    for _ in range(n):
        ds, ws = [], []
        for (pool, cnt), w in zip(pools_counts, weights):
            ds.append(rng.choice(pool, cnt, replace=False))
            ws.append(w * (0.5 + rng.random(cnt)))
        d = np.concatenate(ds)
        order = np.argsort(d)
        rows_i.append(d[order])
        rows_v.append(np.concatenate(ws)[order].astype(np.float32))
    return JaxBatch(indices=jnp.asarray(np.stack(rows_i).astype(np.int32)),
                    values=jnp.asarray(np.stack(rows_v)),
                    nnz=jnp.asarray(np.full(n, len(rows_i[0]), np.int32)), dim=dim)


@pytest.fixture(scope="module")
def drift():
    content, boiler_old, boiler_new = np.arange(0, 256), np.arange(256, 512), np.arange(512, 1024)
    S1 = _drift_batch(64, [(content, 16), (boiler_old, 16)], [1.0, 0.2], seed=1)
    S2 = _drift_batch(512, [(content, 8), (boiler_new, 24)], [1.0, 0.2], seed=2)
    Rq = _drift_batch(40, [(content, 24)], [2.0], seed=3)
    return S1, S2, Rq


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
@pytest.mark.parametrize("given", [False, True], ids=["recounted", "frozen_rank"])
def test_refreeze_matches_jax_engine(drift, cached, given):
    """After drift, refreeze() recomputes IIIB's rank over the live rows (or
    takes ``frozen_rank``) and rebuilds the stacks: the JAX engine's rank,
    index_builds, kept entries and result; fewer entries kept than with the
    stale rank (the reference's test_refreeze_recovers_prune_rate)."""
    S1, S2, Rq = drift
    spec = dict(k=5, algorithm="iiib", s_block=64, r_block=40, warm_start=0.2)
    jidx, pidx = _pair(S1, spec, cached)
    jidx.extend(S2)
    pidx.extend(_port(S2))
    pidx.delete([3, 70])
    jidx.delete([3, 70])
    stale = _same_query(jidx, pidx, Rq)
    builds = pidx.stats.index_builds
    rank = np.arange(2048, dtype=np.int32)[::-1].copy() if given else None
    assert pidx.refreeze(frozen_rank=rank) is pidx
    jidx.refreeze(frozen_rank=rank)
    _same_state(jidx, pidx)
    if cached:
        assert pidx.stats.index_builds == builds + pidx.num_blocks
    fresh = _same_query(jidx, pidx, Rq)
    if not given:
        assert fresh.stats.list_entries < stale.stats.list_entries
    assert_topk_close(fresh.scores.numpy(), fresh.ids.numpy(), stale.scores.numpy(),
                      stale.ids.numpy(), RTOL, 1e-5)


@pytest.mark.parametrize("alg,kernel", [("bf", False), ("iib", False), ("iib", True)])
def test_refreeze_is_a_no_op_off_iiib(small_rs, alg, kernel):
    R, S = small_rs
    jidx, pidx = _pair(S, _spec(alg, kernel))
    builds = pidx.stats.index_builds
    before = pidx.query(_port(R))
    assert pidx.refreeze() is pidx
    jidx.refreeze()
    assert pidx.stats.index_builds == builds
    after = _same_query(jidx, pidx, R)
    assert torch.equal(before.scores, after.scores) and torch.equal(before.ids, after.ids)


# ---------------------------------------------------------------------------
# planner calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cal", [
    {"index_cost_factor": 1e9},
    {"c2_unit_s": 1e-10, "c3_unit_s": 2e-10},
    {"c2_unit_s": 3e-9},
    {},
])
def test_plan_calibration_matches_reference(cal, tmp_path):
    """plan(calibration=) from a dict and from a JSON file: the reference's
    algorithm, blocks and cost estimates."""
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(cal))
    for shape in ((1000, 8, 10_000), (1000, 5000, 10_000), (300, 40, 2000)):
        want = jax_plan(shape, shape, JaxSpec(k=5), calibration=cal)
        for given in (cal, str(path)):
            got = plan(shape, shape, JoinSpec(k=5), calibration=given)
            assert (got.algorithm, got.r_block, got.s_block) == (
                want.algorithm, want.r_block, want.s_block)
            for c in ("cost_bf", "cost_iib", "cost_iiib"):
                assert getattr(got, c) == pytest.approx(getattr(want, c), rel=1e-12)
    assert load_calibration(str(path)) == cal and load_calibration(None) is None


@pytest.mark.parametrize("cal", [{"index_cost_factor": 1e9}, {"index_cost_factor": 1e-9}])
def test_index_carries_calibration_into_its_plan(small_rs, cal, tmp_path):
    """The index plans its algorithm with the calibration (an extreme
    indexed-cost factor flips it) and keeps it for plan_for; the JAX
    engine's choice and result."""
    R, S = small_rs
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(cal))
    for given in (cal, str(path)):
        jidx, pidx = _pair(S, dict(k=5, r_block=24, s_block=32), calibration=given)
        assert pidx.algorithm == jidx.algorithm == ("bf" if cal["index_cost_factor"] > 1 else
                                                    "iiib")
        assert pidx.calibration == cal
        got, want = pidx.plan_for(_port(R)), jidx.plan_for(R)
        assert (got.algorithm, got.r_block, got.s_block) == (
            want.algorithm, want.r_block, want.s_block)
        assert (got.cost_bf, got.cost_iib) == pytest.approx((want.cost_bf, want.cost_iib))
        _same_query(jidx, pidx, R)
