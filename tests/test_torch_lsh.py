"""The approx tier in the port (src/repro_torch/core/lsh.py and the
engine's ``accuracy="approx"``) against the JAX package on the same
seeded inputs, on the CPU: the copied planner and ``keys_host`` byte for
byte; the torch ``band_hits``/``candidate_mask`` equal to the JAX
``candidate_mask`` and ``candidate_mask_host`` (padded and empty R rows);
every driver's approx query, cached and streaming, equal to the JAX
engine's (ids, ``candidate_rows`` and every counter); ``gen_clustered``
byte-identical to ``benchmarks/common.py``'s; the recall contract on it;
the exact face of an approx-built index bit for bit an exact-built one's;
the tier through ``extend`` and ``delete``.

Tolerances: scores rtol=1e-5, atol=1e-6 with ids equal outside tie groups
(``assert_topk_close``); masks, keys and counts exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks.common import gen_clustered as jax_gen_clustered  # noqa: E402
from repro.core import lsh as jax_lsh  # noqa: E402
from repro.core.engine import JoinSpec as JaxSpec  # noqa: E402
from repro.core.engine import JoinStats as JaxStats  # noqa: E402
from repro.core.engine import SparseKNNIndex as JaxIndex  # noqa: E402
from repro.sparse.datagen import synthetic_sparse as jax_synthetic  # noqa: E402
from repro.sparse.format import SparseBatch as JaxBatch  # noqa: E402
from repro_torch.core import lsh  # noqa: E402
from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex  # noqa: E402
from repro_torch.kernels.knn_topk import ops as knn_topk_ops  # noqa: E402
from repro_torch.sparse.datagen import gen_clustered  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
DIM, NNZ = 1024, 24
COUNTERS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
            "device_dispatches", "host_syncs", "candidate_rows", "scanned_rows")
PATHS = [("bf", False), ("iib", False), ("iib", True), ("iiib", False)]
PATH_IDS = ["bf", "iib", "iib-kernel", "iiib"]


def _port(batch):
    return from_arrays(np.asarray(batch.indices), np.asarray(batch.values),
                       np.asarray(batch.nnz), batch.dim)


def _jrows(sb, lo, hi):
    return JaxBatch(indices=sb.indices[lo:hi], values=sb.values[lo:hi], nnz=sb.nnz[lo:hi],
                    dim=sb.dim)


@pytest.fixture(scope="module")
def planted():
    """The reference's recall-contract workload (tests/test_lsh.py):
    16 clusters x 8 rows at dim 1024, 24 features a row."""
    R, S = jax_gen_clustered(16, 8, dim=DIM, nnz=NNZ, seed=2)
    return R, S, _port(R), _port(S)


# ---------------------------------------------------------------------------
# the copied planner and keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", [0.5, 0.8, 0.9, 0.95, 0.99, 0.999])
@pytest.mark.parametrize("sim", [0.5, 0.8, 0.9, 0.97])
def test_planner_equals_reference(target, sim):
    assert lsh.plan_bands(target, sim) == jax_lsh.plan_bands(target, sim)
    assert lsh.plan_bands(target, sim, max_bits=64, max_rows=8) == jax_lsh.plan_bands(
        target, sim, max_bits=64, max_rows=8)
    cfg, want = lsh.plan_lsh(target, seed=3, sim_threshold=sim), jax_lsh.plan_lsh(
        target, seed=3, sim_threshold=sim)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.n_bits == want.n_bits
    for s in (-1.0, 0.0, 0.3, 0.9, 1.0):
        assert cfg.recall_at(s) == want.recall_at(s)
        assert lsh.collision_probability(s, 7, 11) == jax_lsh.collision_probability(s, 7, 11)


def test_config_validation_and_recall_equal_reference():
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            lsh.plan_bands(bad)
    with pytest.raises(ValueError):
        lsh.LSHConfig(n_bands=1, rows_per_band=31)
    with pytest.raises(ValueError):
        lsh.LSHConfig(n_bands=0, rows_per_band=4)
    exact = np.array([[0, 1, 2], [3, 4, -1], [-1, -1, -1]])
    approx = np.array([[0, 2, 9], [3, 4, -1], [5, 6, 7]])
    assert lsh.measured_recall(approx, exact) == jax_lsh.measured_recall(approx, exact)
    with pytest.raises(ValueError):
        lsh.measured_recall(approx[:2], exact)


@pytest.mark.parametrize("seed,target", [(0, 0.95), (3, 0.9), (11, 0.99)])
def test_keys_byte_identical_to_reference(seed, target):
    """The seeded projections and the packed band keys, byte for byte, on
    synthetic rows, rows with extra padding and empty rows."""
    cfg = lsh.plan_lsh(target, seed=seed)
    jcfg = jax_lsh.plan_lsh(target, seed=seed)
    S = jax_synthetic(2100, dim=DIM, nnz_mean=NNZ, seed=seed)   # > one host chunk
    idx, val = np.asarray(S.indices), np.asarray(S.values)
    idx = np.concatenate([idx, np.full((3, idx.shape[1]), DIM, idx.dtype)])
    val = np.concatenate([val, np.zeros((3, val.shape[1]), val.dtype)])
    ours, theirs = lsh.LSHBands(cfg, DIM), jax_lsh.LSHBands(jcfg, DIM)
    assert ours._proj.tobytes() == theirs._proj.tobytes()
    got, want = ours.keys_host(idx, val), theirs.keys_host(idx, val)
    assert got.dtype == want.dtype == np.int32 and got.tobytes() == want.tobytes()
    assert (got[-3:] == 0).all()


# ---------------------------------------------------------------------------
# the band lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks,s_block,rb", [(2, 40, 24), (1, 96, 5), (3, 17, 1)])
def test_candidate_mask_equals_jax_and_host(blocks, s_block, rb):
    """torch band_hits / candidate_mask against JAX's candidate_mask and the
    host twin: padded R rows (r_real False) and empty R rows (key 0 in
    every band) stay out; planted collisions hit; the live count equal."""
    cfg = lsh.plan_lsh(0.95)
    bands = lsh.LSHBands(cfg, DIM)
    R = jax_synthetic(rb, dim=DIM, nnz_mean=NNZ, seed=rb)
    S = jax_synthetic(blocks * s_block, dim=DIM, nnz_mean=NNZ, seed=blocks)
    rk = bands.keys_host(np.asarray(R.indices), np.asarray(R.values))
    sk = bands.keys_host(np.asarray(S.indices), np.asarray(S.values))
    sk = sk.reshape(blocks, s_block, cfg.n_bands)
    sk[-1, -1] = rk[0]                            # a planted collision
    r_real = np.ones(rb, bool)
    if rb > 2:
        r_real[-2:] = False                       # padded tail rows
        sk[0, 0] = rk[-1]                         # collides only with a padded row
        rk[1] = 0                                 # an empty R row's keys...
        r_real[1] = False                         # ...which the engine excludes
    s_valid = np.random.default_rng(0).random((blocks, s_block)) > 0.2
    mask, count = lsh.candidate_mask(torch.as_tensor(rk), torch.as_tensor(r_real),
                                     torch.as_tensor(sk), torch.as_tensor(s_valid))
    jmask, jcount = jax_lsh.candidate_mask(jnp.asarray(rk), jnp.asarray(r_real),
                                           jnp.asarray(sk), jnp.asarray(s_valid))
    host = lsh.candidate_mask_host(rk, r_real, sk)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(mask.numpy(), host)
    np.testing.assert_array_equal(host, jax_lsh.candidate_mask_host(rk, r_real, sk))
    assert int(count) == int(jcount) == int((host & s_valid).sum())
    assert host[-1, -1]
    if rb > 2:
        assert not host[0, 0] or np.isin(sk[0, 0], rk[r_real]).any()
    flat, _ = lsh.candidate_mask(torch.as_tensor(rk), torch.as_tensor(r_real),
                                 torch.as_tensor(sk.reshape(-1, cfg.n_bands)),
                                 torch.ones(blocks * s_block, dtype=torch.bool))
    np.testing.assert_array_equal(flat.numpy(), host.reshape(-1))


# ---------------------------------------------------------------------------
# the engine's approx tier
# ---------------------------------------------------------------------------

def test_gen_clustered_byte_identical_to_benchmarks():
    for args in ((16, 8, DIM, NNZ, 2), (12, 8, DIM, NNZ, 5), (30, 3, 500, 10, 7)):
        for got, want in zip(gen_clustered(*args), jax_gen_clustered(*args)):
            for f in ("indices", "values", "nnz"):
                g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
            assert got.dim == want.dim


def _approx_pair(S, pS, spec_kw, cached):
    return (JaxIndex.build(S, JaxSpec(**spec_kw), cache_device_blocks=cached),
            SparseKNNIndex.build(pS, JoinSpec(**spec_kw), cache_device_blocks=cached,
                                 device="cpu"))


def _same(jidx, pidx, R, pR, accuracy=None):
    jstats, stats = JaxStats(), JoinStats()
    jres = jidx.query(R, stats=jstats, accuracy=accuracy)
    res = pidx.query(pR, stats=stats, accuracy=accuracy)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), np.asarray(jres.scores),
                      np.asarray(jres.ids), RTOL, ATOL)
    assert {c: getattr(stats, c) for c in COUNTERS} == {c: getattr(jstats, c) for c in COUNTERS}
    assert len(stats.min_prune_trace) == len(jstats.min_prune_trace)
    return res, jres


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_approx_query_matches_jax_engine_and_meets_recall(planted, alg, kernel, cached):
    """Every driver's approx query equals the JAX engine's (ids, counters,
    candidate rows); the recall contract holds (>= 0.95 against the same
    index's exact face) with a candidate set smaller than S."""
    R, S, pR, pS = planted
    spec = dict(k=5, algorithm=alg, use_kernel=kernel, r_block=4, s_block=32,
                accuracy="approx", target_recall=0.95)
    jidx, pidx = _approx_pair(S, pS, spec, cached)
    res, _ = _same(jidx, pidx, R, pR)
    exact, _ = _same(jidx, pidx, R, pR, accuracy="exact")
    recall = lsh.measured_recall(res.ids.numpy(), exact.ids.numpy())
    res.stats.recall = recall
    assert recall >= 0.95, recall
    assert 0 < res.stats.candidate_rows
    assert res.stats.candidate_fraction < 1.0
    assert exact.stats.candidate_fraction is None


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_exact_face_bit_identical_to_exact_build(alg, kernel, cached):
    """accuracy='exact' on an approx-built index skips the mask: bit for bit
    an exact-built index (the reference's test_exact_mode_bit_identity)."""
    R = _port(jax_synthetic(24, dim=DIM, nnz_mean=NNZ, seed=0))
    S = _port(jax_synthetic(96, dim=DIM, nnz_mean=NNZ, seed=1))
    spec = JoinSpec(k=5, algorithm=alg, use_kernel=kernel, r_block=16, s_block=40)
    aspec = dataclasses.replace(spec, accuracy="approx", target_recall=0.9)
    ref = SparseKNNIndex.build(S, spec, cache_device_blocks=cached, device="cpu").query(R)
    idx = SparseKNNIndex.build(S, aspec, cache_device_blocks=cached, device="cpu")
    got = idx.query(R, accuracy="exact")
    assert torch.equal(got.scores, ref.scores) and torch.equal(got.ids, ref.ids)
    assert idx.spec.accuracy == "approx" and got.stats.scanned_rows == 0


def test_exact_index_rejects_approx_queries():
    R = _port(jax_synthetic(8, dim=DIM, nnz_mean=NNZ, seed=0))
    S = _port(jax_synthetic(40, dim=DIM, nnz_mean=NNZ, seed=1))
    idx = SparseKNNIndex.build(S, JoinSpec(k=5, algorithm="iib", r_block=16, s_block=40),
                               device="cpu")
    with pytest.raises(ValueError, match="LSH"):
        idx.query(R, accuracy="approx")
    with pytest.raises(ValueError):
        idx.query(R, accuracy="bogus")


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "streaming"])
@pytest.mark.parametrize("alg,kernel", PATHS, ids=PATH_IDS)
def test_approx_survives_extend_and_delete(alg, kernel, cached):
    """extend() restacks the band keys, tombstones AND into the same masks
    (the reference's test_approx_survives_extend_and_delete): the exact
    face equals an exact build with the same deletes, no deleted row is a
    candidate, and every step equals the JAX engine."""
    R, S = jax_gen_clustered(12, 8, dim=DIM, nnz=NNZ, seed=5)
    pR, pS = _port(R), _port(S)
    n0 = S.num_vectors - 24
    spec = dict(k=5, algorithm=alg, use_kernel=kernel, r_block=4, s_block=32,
                accuracy="approx", target_recall=0.95)
    jidx = JaxIndex.build(_jrows(S, 0, n0), JaxSpec(**spec), cache_device_blocks=cached)
    pidx = SparseKNNIndex.build(pS.rows(0, n0), JoinSpec(**spec), cache_device_blocks=cached,
                                device="cpu")
    jidx.extend(_jrows(S, n0, S.num_vectors))
    pidx.extend(pS.rows(n0, S.num_vectors))
    assert pidx.delete(np.arange(3)) == jidx.delete(np.arange(3)) == 3
    ref = SparseKNNIndex.build(pS, JoinSpec(**dict(spec, accuracy="exact", target_recall=None)),
                               cache_device_blocks=cached, device="cpu")
    ref.delete(np.arange(3))
    got, _ = _same(jidx, pidx, R, pR, accuracy="exact")
    want = ref.query(pR)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids.numpy())
    approx, _ = _same(jidx, pidx, R, pR)
    assert not np.isin(approx.ids.numpy(), np.arange(3)).any()
    assert approx.stats.scanned_rows == -(-R.num_vectors // 4) * pidx.live_rows


def test_approx_large_k_route_matches_jax_engine(monkeypatch):
    """k 150 on the fused path takes score_then_merge with the candidate
    mask folded into its column mask (the fused kernel is never called):
    the JAX engine's approx result and counters."""
    R, S = jax_gen_clustered(40, 8, dim=DIM, nnz=NNZ, seed=3)

    def fused(*args, **kwargs):
        raise AssertionError("the fused kernel was called at k > MAX_K")

    monkeypatch.setattr(knn_topk_ops, "knn_topk_fused", fused)
    spec = dict(k=150, algorithm="iib", use_kernel=True, r_block=8, s_block=128,
                accuracy="approx", target_recall=0.95)
    for cached in (True, False):
        jidx, pidx = _approx_pair(S, _port(S), spec, cached)
        res, _ = _same(jidx, pidx, R, _port(R))
        assert res.scores.shape == (40, 150) and res.stats.candidate_fraction < 1.0


def test_lsh_cfg_is_the_hasher(planted):
    """A passed ``lsh_cfg`` wins over the planned one, as in the reference
    (every holder of one config hashes alike)."""
    R, S, pR, pS = planted
    cfg = lsh.LSHConfig(n_bands=8, rows_per_band=6, seed=4)
    jcfg = jax_lsh.LSHConfig(n_bands=8, rows_per_band=6, seed=4)
    spec = dict(k=5, algorithm="iiib", r_block=4, s_block=32, target_recall=0.95)
    jidx = JaxIndex.build(S, JaxSpec(**spec), lsh_cfg=jcfg)
    pidx = SparseKNNIndex.build(pS, JoinSpec(**spec), device="cpu", lsh_cfg=cfg)
    assert pidx._lsh.cfg == cfg
    for pb, jb in zip(pidx._blocks, jidx._blocks):
        np.testing.assert_array_equal(pb.lshkeys, jb.lshkeys)
    _same(jidx, pidx, R, pR)
