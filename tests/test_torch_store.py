"""The port's sharded store (src/repro_torch/store/sharded.py) against the
JAX package's ShardedKNNStore on the same seeded inputs, on the CPU.

The JAX store needs one device a shard, so it runs in a subprocess with
forced host devices (``tests/util_subproc.py::run_with_devices``) and
dumps its results; the port runs the SAME scenario code (``SCENARIOS``,
executed against either package through a small adapter) in-process on
the CPU, 4 shards on one device.  Scenarios: the reference's parity case
(R 45, S 131, dim 512, s_block 16, r_block 20; shards 33/33/33/32) for
bf, iib and iiib, exact and approx; each algorithm through add (with a
TTL), delete, expire, compact(shards=), compact, auto_compact, a fully
dead shard's revival and refreeze; 2 replicas x 2 shards through
round-robin routing, a replica kill, mutations while it is dead,
resync_replicas, verify_replicas and a shard-copy loss; and the
unreplicated loss semantics (ShardLostError, allow_partial).
``tree_reduce_topk`` is held bit for bit against the JAX function run
under shard_map at 1, 2, 3 and 5 states with ties across states.

Tolerances: scores within rtol=1e-5, atol=1e-6 and ids equal outside tie
groups (``assert_topk_close``); every JoinStats and StoreStats counter,
IIIB's threshold traces (within tolerance), shard_rows, placed_shards,
placed_bytes, replica_dispatches, the mutations' return values and the
fault outcomes equal.  Against the port's own single SparseKNNIndex the
store is bit for bit on the CPU."""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import (  # noqa: E402
    JoinSpec,
    JoinStats,
    SparseKNNIndex,
    _pad_feature_axis,
)
from repro_torch.core.topk import TopKState, tree_reduce_topk  # noqa: E402
from repro_torch.runtime.fault import (  # noqa: E402
    FaultPlan,
    FaultSpec,
    ShardLostError,
)
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402
from repro_torch.store import ShardedKNNStore, StoreStats  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402
from tests.util_subproc import run_with_devices  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
DIM, NNZ = 512, 18
# name -> (rows, seed) of the seeded inputs both packages read
INPUTS = {"R": (45, 0), "S": (131, 1), "S2": (21, 7), "S3": (12, 8), "S4": (4, 11),
          "S5": (10, 2)}

# The scenario code both packages run.  ``api`` adapts the package: its
# JoinSpec and JoinStats, ``store(S, spec, shards, replicas, **kw)``,
# ``data(name)`` (a batch of INPUTS), the fault classes, and ``asnp``.
SCENARIOS = r'''
import numpy as np

ALGS = ("bf", "iib", "iiib")
JOIN_FIELDS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
               "device_dispatches", "host_syncs", "candidate_rows", "scanned_rows")
STORE_FIELDS = ("queries", "device_dispatches", "host_syncs", "index_builds", "stack_uploads",
                "placed_shards", "placed_bytes", "deleted", "expired", "compactions",
                "shard_losses", "degraded_queries", "replica_losses", "replica_failovers",
                "resyncs")


def snapshot(out, tag, store):
    out[tag + "/store"] = {f: getattr(store.stats, f) for f in STORE_FIELDS}
    out[tag + "/replica_dispatches"] = dict(store.stats.replica_dispatches)
    out[tag + "/shard_rows"] = [int(x) for x in store.shard_rows]
    out[tag + "/lost"] = (tuple(store.lost_shards), tuple(store.dead_replicas),
                          bool(store.needs_resync))


def qrec(out, tag, store, R, api, **kw):
    st = api.JoinStats()
    try:
        res = store.query(R, stats=st, **kw)
    except api.ShardLostError as e:
        out[tag + "/raised"] = ("ShardLostError", int(e.shard))
        snapshot(out, tag, store)
        return None
    out[tag + "/scores"] = api.asnp(res.scores)
    out[tag + "/ids"] = api.asnp(res.ids)
    out[tag + "/missing"] = tuple(int(x) for x in res.missing_shards)
    out[tag + "/join"] = {f: getattr(st, f) for f in JOIN_FIELDS}
    out[tag + "/trace"] = [np.asarray(t, np.float32) for t in st.min_prune_trace]
    snapshot(out, tag, store)
    return res


def parity(out, api):
    R, S = api.data("R"), api.data("S")
    for alg in ALGS:
        for acc in ("exact", "approx"):
            kw = {"target_recall": 0.9} if acc == "approx" else {}
            spec = api.JoinSpec(k=5, algorithm=alg, s_block=16, r_block=20, **kw)
            store = api.store(S, spec, 4)
            for q in range(2):
                qrec(out, f"parity/{alg}/{acc}/q{q}", store, R, api)
            if acc == "approx":
                qrec(out, f"parity/{alg}/{acc}/as_exact", store, R, api, accuracy="exact")


def mutations(out, api):
    R, S = api.data("R"), api.data("S")
    for alg in ALGS:
        p = f"mut/{alg}/"
        spec = api.JoinSpec(k=5, algorithm=alg, s_block=16, r_block=20)
        store = api.store(S, spec, 4, auto_compact=0.9)
        qrec(out, p + "build", store, R, api)
        out[p + "delete_n"] = int(store.delete([0, 5, 40, 66, 99, 130]))
        qrec(out, p + "delete", store, R, api)
        out[p + "add_ttl_gids"] = np.asarray(store.add(api.data("S2"), ttl=10.0, now=100.0))
        qrec(out, p + "add_ttl", store, R, api)
        out[p + "expire_n"] = int(store.expire(now=120.0))
        qrec(out, p + "expire", store, R, api)
        out[p + "compact01_n"] = int(store.compact(shards=[0, 1]))
        qrec(out, p + "compact01", store, R, api)
        out[p + "add_gids"] = np.asarray(store.add(api.data("S3")))
        qrec(out, p + "add", store, R, api)
        out[p + "compact_n"] = int(store.compact())
        qrec(out, p + "compact", store, R, api)
        # auto_compact: killing most of shard 0 crosses the threshold
        store.auto_compact = 0.3
        g0 = np.asarray(store._gids[0])
        out[p + "auto_n"] = int(store.delete(g0[: len(g0) // 2 + 1]))
        qrec(out, p + "auto", store, R, api)
        # a fully dead shard compacts to its placeholder row and revives
        g1 = np.asarray(store._gids[1])
        out[p + "dead1_n"] = int(store.delete(g1))
        out[p + "dead1_compact_n"] = int(store.compact(shards=[1]))
        out[p + "revive_gids"] = np.asarray(store.add(api.data("S4")))
        qrec(out, p + "revive", store, R, api)
        if alg == "iiib":
            store.refreeze()
            qrec(out, p + "refreeze", store, R, api)


def replicas(out, api):
    R, S = api.data("R"), api.data("S")
    spec = api.JoinSpec(k=5, algorithm="iib", s_block=16, r_block=20)
    store = api.store(S, spec, 2, replicas=2)
    for q in range(2):
        qrec(out, f"rep/q{q}", store, R, api)
    store.fault_plan = api.FaultPlan([api.FaultSpec("replica_error", replica=1)])
    qrec(out, "rep/kill", store, R, api)
    store.fault_plan = None
    out["rep/add_gids"] = np.asarray(store.add(api.data("S5")))
    out["rep/delete_n"] = int(store.delete([3, 40]))
    out["rep/dirty1"] = sorted(int(i) for i in store._replica_dirty[1])
    qrec(out, "rep/while_dead", store, R, api)
    out["rep/resync"] = tuple(int(r) for r in store.resync_replicas())
    out["rep/state_after_resync"] = store.health.state(1)
    out["rep/verify"] = bool(store.verify_replicas())
    qrec(out, "rep/probe", store, R, api)
    out["rep/state_after_probe"] = store.health.state(1)
    out["rep/resync_again"] = tuple(store.resync_replicas())
    store.fault_plan = api.FaultPlan([api.FaultSpec("shard_error", shard=0, at_dispatch=0)])
    qrec(out, "rep/shard_copy", store, R, api)
    store.fault_plan = None
    out["rep/resync_shard"] = tuple(int(r) for r in store.resync_replicas())
    out["rep/verify_shard"] = bool(store.verify_replicas())
    qrec(out, "rep/after_resync", store, R, api)


def losses(out, api):
    R, S = api.data("R"), api.data("S")
    spec = api.JoinSpec(k=5, algorithm="iib", s_block=16, r_block=45)
    flat = api.store(S, spec, 2)
    qrec(out, "loss/clean", flat, R, api)
    flat.fault_plan = api.FaultPlan([api.FaultSpec("shard_error", shard=1, at_dispatch=0)])
    qrec(out, "loss/raise", flat, R, api)
    qrec(out, "loss/partial", flat, R, api, allow_partial=True)
    flat.fault_plan = None
    out["loss/resync"] = tuple(flat.resync_replicas())
    flat2 = api.store(S, spec, 2)
    flat2.mark_lost(0)
    qrec(out, "loss/marked_raise", flat2, R, api)
    qrec(out, "loss/marked_partial", flat2, R, api, allow_partial=True)
    out["loss/add_gids"] = np.asarray(flat2.add(api.data("S4")))
    qrec(out, "loss/marked_after_add", flat2, R, api, allow_partial=True)
    # replicated: the same shard lost on both copies is data loss too
    rep = api.store(S, api.JoinSpec(k=5, algorithm="iib", s_block=16, r_block=20), 2,
                    replicas=2)
    rep.mark_lost(1, replica=0)
    qrec(out, "loss/rep_one_copy", rep, R, api)
    rep.mark_lost(1, replica=1)
    qrec(out, "loss/rep_both_raise", rep, R, api)
    qrec(out, "loss/rep_both_partial", rep, R, api, allow_partial=True)


def run_all(api):
    out = {}
    for scenario in (parity, mutations, replicas, losses):
        scenario(out, api)
    return out
'''

JAX_ADAPTER = r'''
import pickle, sys, types
import numpy as np
import jax.numpy as jnp
from repro.core.engine import JoinSpec, JoinStats
from repro.launch.mesh import make_store_mesh
from repro.runtime.fault import FaultPlan, FaultSpec, ShardLostError
from repro.sparse.format import SparseBatch
from repro.store import ShardedKNNStore

inputs = np.load(sys.argv[1] if len(sys.argv) > 1 else INPUT_PATH)

def data(name):
    return SparseBatch(indices=jnp.asarray(inputs[name + "_idx"]),
                       values=jnp.asarray(inputs[name + "_val"]),
                       nnz=jnp.asarray(inputs[name + "_nnz"]), dim=int(inputs["dim"]))

def store(S, spec, shards, replicas=1, **kw):
    return ShardedKNNStore.build(S, spec, mesh=make_store_mesh(shards, replicas=replicas), **kw)

api = types.SimpleNamespace(JoinSpec=JoinSpec, JoinStats=JoinStats, store=store, data=data,
                            FaultPlan=FaultPlan, FaultSpec=FaultSpec,
                            ShardLostError=ShardLostError, asnp=np.asarray)
with open(OUTPUT_PATH, "wb") as f:
    pickle.dump(run_all(api), f)
print("JAX_STORE_DONE")
'''


def _scenario_namespace():
    ns = {}
    exec(compile(SCENARIOS, "<store scenarios>", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded inputs both packages read, as arrays and as an npz file."""
    arrays = {"dim": np.asarray(DIM)}
    for name, (rows, seed) in INPUTS.items():
        b = synthetic_sparse(rows, dim=DIM, nnz_mean=NNZ, seed=seed)
        arrays[name + "_idx"] = b.indices.numpy()
        arrays[name + "_val"] = b.values.numpy()
        arrays[name + "_nnz"] = b.nnz.numpy()
    path = tmp_path_factory.mktemp("store_inputs") / "inputs.npz"
    np.savez(path, **arrays)
    return arrays, str(path)


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory):
    """Every scenario's results from the JAX store (4 forced host devices)."""
    out_path = str(tmp_path_factory.mktemp("store_jax") / "out.pkl")
    code = (f"INPUT_PATH = {inputs[1]!r}\nOUTPUT_PATH = {out_path!r}\n" + SCENARIOS
            + JAX_ADAPTER)
    assert "JAX_STORE_DONE" in run_with_devices(code, n_devices=4)
    with open(out_path, "rb") as f:
        return pickle.load(f)


def _port_api(arrays):
    import types

    def data(name):
        return from_arrays(arrays[name + "_idx"], arrays[name + "_val"],
                           arrays[name + "_nnz"], DIM)

    def store(S, spec, shards, replicas=1, **kw):
        return ShardedKNNStore.build(S, spec, num_shards=shards, replicas=replicas,
                                     device="cpu", **kw)

    return types.SimpleNamespace(JoinSpec=JoinSpec, JoinStats=JoinStats, store=store, data=data,
                                 FaultPlan=FaultPlan, FaultSpec=FaultSpec,
                                 ShardLostError=ShardLostError, asnp=lambda t: t.numpy())


@pytest.fixture(scope="module")
def port_out(inputs):
    return _scenario_namespace()["run_all"](_port_api(inputs[0]))


def _hold(port_out, jax_out, tag):
    """One query tag: results within tolerance (or the same raise), every
    counter equal."""
    assert (tag + "/raised" in port_out) == (tag + "/raised" in jax_out), tag
    if tag + "/raised" in jax_out:
        assert port_out[tag + "/raised"] == jax_out[tag + "/raised"], tag
    else:
        assert_topk_close(port_out[tag + "/scores"], port_out[tag + "/ids"],
                          jax_out[tag + "/scores"], jax_out[tag + "/ids"], RTOL, ATOL)
        assert port_out[tag + "/missing"] == jax_out[tag + "/missing"], tag
        assert port_out[tag + "/join"] == jax_out[tag + "/join"], tag
        assert len(port_out[tag + "/trace"]) == len(jax_out[tag + "/trace"]), tag
        for g, w in zip(port_out[tag + "/trace"], jax_out[tag + "/trace"]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for key in ("store", "replica_dispatches", "shard_rows", "lost"):
        assert port_out[f"{tag}/{key}"] == jax_out[f"{tag}/{key}"], (tag, key)


@pytest.mark.subproc
@pytest.mark.parametrize("alg", ["bf", "iib", "iiib"])
@pytest.mark.parametrize("acc", ["exact", "approx"])
def test_store_matches_jax_store(port_out, jax_out, alg, acc):
    """The reference's parity case, 4 shards: two queries (and, approx
    built, an exact query) equal to the JAX store's, every counter equal."""
    tags = [f"parity/{alg}/{acc}/q0", f"parity/{alg}/{acc}/q1"]
    if acc == "approx":
        tags.append(f"parity/{alg}/{acc}/as_exact")
    for tag in tags:
        _hold(port_out, jax_out, tag)


@pytest.mark.subproc
@pytest.mark.parametrize("alg", ["bf", "iib", "iiib"])
def test_store_mutations_match_jax_store(port_out, jax_out, alg):
    """add with a TTL, delete, expire, compact(shards=), add, compact,
    auto_compact, a dead shard's revival (and IIIB's refreeze): after each,
    the query, shard_rows, placed_shards/placed_bytes and every counter
    equal the JAX store's, and so do the mutations' return values."""
    p = f"mut/{alg}/"
    steps = ["build", "delete", "add_ttl", "expire", "compact01", "add", "compact", "auto",
             "revive"] + (["refreeze"] if alg == "iiib" else [])
    for step in steps:
        _hold(port_out, jax_out, p + step)
    for key in ("delete_n", "expire_n", "compact01_n", "compact_n", "auto_n", "dead1_n",
                "dead1_compact_n"):
        assert port_out[p + key] == jax_out[p + key], key
    for key in ("add_ttl_gids", "add_gids", "revive_gids"):
        np.testing.assert_array_equal(port_out[p + key], jax_out[p + key])


@pytest.mark.subproc
def test_store_replicas_match_jax_store(port_out, jax_out):
    """2 replicas x 2 shards: round-robin replica_dispatches, the failover
    through a replica kill, write-through while it is dead, resync,
    verify, the half-open probe, and a shard-copy loss, all as the JAX
    store's."""
    for step in ("q0", "q1", "kill", "while_dead", "probe", "shard_copy", "after_resync"):
        _hold(port_out, jax_out, "rep/" + step)
    for key in ("dirty1", "resync", "state_after_resync", "verify", "state_after_probe",
                "resync_again", "resync_shard", "verify_shard", "delete_n"):
        assert port_out["rep/" + key] == jax_out["rep/" + key], key
    np.testing.assert_array_equal(port_out["rep/add_gids"], jax_out["rep/add_gids"])
    assert port_out["rep/kill/store"]["replica_failovers"] == 1
    assert set(port_out["rep/q1/replica_dispatches"]) == {0, 1}


@pytest.mark.subproc
def test_store_losses_match_jax_store(port_out, jax_out):
    """Unreplicated: a shard_error raises ShardLostError, allow_partial
    serves missing_shards, mark_lost then add goes to the surviving shard;
    replicated: one lost copy fails over, both lost is data loss."""
    for step in ("clean", "raise", "partial", "marked_raise", "marked_partial",
                 "marked_after_add", "rep_one_copy", "rep_both_raise", "rep_both_partial"):
        _hold(port_out, jax_out, "loss/" + step)
    assert port_out["loss/resync"] == jax_out["loss/resync"] == ()
    assert port_out["loss/raise/raised"] == ("ShardLostError", 1)
    assert port_out["loss/partial/missing"] == (1,)
    np.testing.assert_array_equal(port_out["loss/add_gids"], jax_out["loss/add_gids"])


# -- the port alone -----------------------------------------------------------

def _batches():
    R = synthetic_sparse(45, dim=DIM, nnz_mean=NNZ, seed=0)
    S = synthetic_sparse(131, dim=DIM, nnz_mean=NNZ, seed=1)
    return R, S


@pytest.mark.parametrize("alg", ["bf", "iib", "iiib"])
@pytest.mark.parametrize("acc", ["exact", "approx"])
def test_store_equals_single_index_bit_for_bit(alg, acc):
    """4 ragged shards (33/33/33/32) with ragged blocks equal one
    SparseKNNIndex over the same S bit for bit; one dispatch and one host
    sync per R block; no query-time index build."""
    R, S = _batches()
    kw = {"target_recall": 0.9} if acc == "approx" else {}
    spec = JoinSpec(k=5, algorithm=alg, s_block=16, r_block=20, **kw)
    single = SparseKNNIndex.build(S, spec, device="cpu").query(R)
    store = ShardedKNNStore.build(S, spec, num_shards=4, device="cpu")
    assert store.shard_rows == [33, 33, 33, 32]
    builds = store.stats.index_builds
    assert store.num_blocks == 11           # 3 + 3 + 3 + 2 blocks of 16
    assert builds == (0 if alg == "bf" else 11)
    for _ in range(2):
        stats = JoinStats()
        res = store.query(R, stats=stats)
        assert torch.equal(res.scores, single.scores) and torch.equal(res.ids, single.ids)
        assert stats.device_dispatches == stats.host_syncs == 3
    assert store.stats.index_builds == builds


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_store_shard_counts_equal_single_index(shards):
    """Any shard count, odd ones included (the tree carries the odd state
    up), equals the single index bit for bit."""
    R, S = _batches()
    spec = JoinSpec(k=7, algorithm="iib", s_block=8, r_block=16)
    single = SparseKNNIndex.build(S, spec, device="cpu").query(R)
    res = ShardedKNNStore.build(S, spec, num_shards=shards, device="cpu").query(R)
    assert torch.equal(res.scores, single.scores) and torch.equal(res.ids, single.ids)


def test_store_dispatch_shape_and_fault_hook_once_per_dispatch():
    """One FaultPlan.on_dispatch per R block, whatever the shard and
    replica count; the fan-out launches one merge per shard block step and
    shards - 1 tree merges per R block (counted on topk_merge_cuda)."""
    from repro_torch.core import topk as topk_mod

    R, S = _batches()
    spec = JoinSpec(k=5, algorithm="bf", s_block=16, r_block=20)
    store = ShardedKNNStore.build(S, spec, num_shards=4, replicas=2, device="cpu")
    store.fault_plan = FaultPlan([])
    calls = []
    real = topk_mod.topk_merge_cuda

    def counting(*a):
        calls.append(a[2].shape[1])
        return real(*a)

    topk_mod.topk_merge_cuda = counting
    try:
        stats = JoinStats()
        store.query(R, stats=stats)
    finally:
        topk_mod.topk_merge_cuda = real
    r_blocks = 3
    assert store.fault_plan.dispatches == r_blocks == stats.device_dispatches
    b_max = store._num_blocks_stacked
    assert len(calls) == r_blocks * (4 * b_max + 3)
    assert calls.count(5) == r_blocks * 3         # the tree merges take M = k


def test_replicas_hold_tensors_of_their_own():
    """Each replica's tensors are its own (no memory shared with another
    replica or with the host mirror): corrupting one is seen by
    verify_replicas and repaired by resync."""
    R, S = _batches()
    spec = JoinSpec(k=5, algorithm="iib", s_block=16, r_block=20)
    store = ShardedKNNStore.build(S, spec, num_shards=2, replicas=2, device="cpu")
    a, b = store._stacks
    for k in a:
        for ta, tb in zip(a[k], b[k]):      # each shard's tensor
            assert ta.data_ptr() != tb.data_ptr(), k
            assert ta.untyped_storage().data_ptr() != tb.untyped_storage().data_ptr(), k
            assert not np.shares_memory(ta.numpy(), store._stacked_host[k]), k
    assert store.verify_replicas()
    b["vals"][0][0].add_(1.0)
    with pytest.raises(ValueError, match="replica 1 leaf 'vals'"):
        store.verify_replicas()
    store._replica_dirty[1].add(0)
    assert store.resync_replicas() == (1,)
    assert store.verify_replicas()


def test_incremental_placement_counters():
    """A geometry-stable add copies one shard slice into each replica;
    delete moves only the valid mask; a geometry-growing add re-places
    everything (the reference's counts)."""
    R, S = _batches()
    spec = JoinSpec(k=5, algorithm="bf", s_block=16, r_block=20)
    store = ShardedKNNStore.build(S, spec, num_shards=4, replicas=2, device="cpu")
    single = SparseKNNIndex.build(S, spec, device="cpu")
    assert store.stats.placed_shards == 8
    full_bytes = store.stats.placed_bytes // 2

    def chunk(lo, hi):
        return S.rows(lo, hi)

    ps0, pb0 = store.stats.placed_shards, store.stats.placed_bytes
    store.add(chunk(0, 4))
    single.extend(chunk(0, 4))
    assert store.stats.placed_shards - ps0 == 2
    assert (store.stats.placed_bytes - pb0) * 2 < 2 * full_bytes
    a, b = store.query(R), single.query(R)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    assert store.verify_replicas()
    ps1 = store.stats.placed_shards
    store.delete([0])
    single.delete([0])
    assert store.stats.placed_shards == ps1
    ps2 = store.stats.placed_shards
    store.add(chunk(4, 20))
    single.extend(chunk(4, 20))
    assert store.stats.placed_shards - ps2 == 8
    a, b = store.query(R), single.query(R)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    assert store.verify_replicas()


def test_padded_blocks_offer_nothing():
    """A shard padded to the cross-shard block count walks blocks whose
    rows are all invalid: a store whose shards differ in block count
    still equals the single index, and the padded valid rows are False."""
    R, S = _batches()
    spec = JoinSpec(k=5, algorithm="iiib", s_block=16, r_block=45)
    store = ShardedKNNStore.build(S, spec, num_shards=2, device="cpu")
    store.add(synthetic_sparse(40, dim=DIM, nnz_mean=NNZ, seed=9))
    counts = [s.num_blocks for s in store.shards]
    assert max(counts) > min(counts)
    short = int(np.argmin(counts))
    assert not store._stacked_host["valid"][short, counts[short]:].any()
    assert (store._stacked_host["counts"][short, counts[short]:] == 0).all()
    single = SparseKNNIndex.build(S, spec, device="cpu")
    single.extend(synthetic_sparse(40, dim=DIM, nnz_mean=NNZ, seed=9))
    res, ref = store.query(R), single.query(R)
    assert_topk_close(res.scores.numpy(), res.ids.numpy(), ref.scores.numpy(), ref.ids.numpy(),
                      RTOL, ATOL)


@pytest.mark.parametrize("how", ["delete", "expire"])
def test_tombstones_beside_an_auto_compaction_are_folded(how):
    """One delete (or expiry) over two shards that trips auto_compact on
    one of them: the other shard's new tombstones reach the device too, so
    no dead row is served, and the answer is a fresh index's over the live
    rows.  The JAX store skips that refresh and serves deleted id 49 in
    the delete case (ROADMAP queue 3, a reference fault)."""
    R = synthetic_sparse(20, dim=DIM, nnz_mean=NNZ, seed=0)
    S = synthetic_sparse(100, dim=DIM, nnz_mean=NNZ, seed=1)        # shards of 25
    spec = JoinSpec(k=5, algorithm="bf", s_block=16, r_block=20)
    store = ShardedKNNStore.build(S, spec, num_shards=4, auto_compact=0.5, device="cpu")
    if how == "delete":
        dead = np.concatenate([np.arange(0, 13), np.arange(25, 50, 3)])
        assert store.delete(dead) == dead.size
    else:
        a = store.add(synthetic_sparse(26, dim=DIM, nnz_mean=NNZ, seed=3), ttl=1.0, now=0.0)
        b = store.add(synthetic_sparse(4, dim=DIM, nnz_mean=NNZ, seed=4), ttl=1.0, now=0.0)
        assert store.shard_rows == [51, 29, 25, 25]
        dead = np.concatenate([a, b])
        assert store.expire(now=2.0) == dead.size
    assert store.stats.compactions == 1
    ids = store.query(R).ids.numpy()
    assert not np.isin(ids, dead).any()
    f = max(sh._idx.shape[1] for sh in store.shards)
    parts = [_pad_feature_axis(sh._idx[sh._alive], sh._val[sh._alive], f, DIM)
             + (sh._nnz[sh._alive],) for sh in store.shards]
    S_live = from_arrays(*(np.concatenate(x) for x in zip(*parts)), DIM)
    gids = np.concatenate([g[sh._alive] for sh, g in zip(store.shards, store._gids)])
    want = SparseKNNIndex.build(S_live, spec, device="cpu").query(R)
    got = store.query(R)
    assert_topk_close(got.scores.numpy(), got.ids.numpy(), want.scores.numpy(),
                      gids[want.ids.numpy()], RTOL, ATOL)


def test_store_stats_expose_and_trace_events():
    """StoreStats is backed by the port's registry (the exposition reads
    the same cells), and a failover lands in the port's flight recorder
    with the R block's span."""
    from repro_torch.obs import recorder as obs_recorder
    from repro_torch.obs.registry import parse_exposition

    R, S = _batches()
    rec = obs_recorder.FlightRecorder()
    obs_recorder.set_recorder(rec)
    try:
        spec = JoinSpec(k=5, algorithm="iib", s_block=16, r_block=45)
        store = ShardedKNNStore.build(S, spec, num_shards=2, replicas=2, device="cpu")
        store.fault_plan = FaultPlan([FaultSpec("replica_error", replica=1)])
        store.query(R)
        store.query(R)
        kinds = [e["kind"] for e in rec.events()]
    finally:
        obs_recorder.set_recorder(None)
    assert "fault_injected" in kinds and "replica_lost" in kinds
    assert "replica_failover" in kinds
    parsed = parse_exposition(store.stats.expose())
    assert parsed["store_queries"]["value"] == 2 == store.stats.queries
    assert parsed["store_replica_failovers"]["value"] == 1
    assert isinstance(store.stats, StoreStats)


def test_store_rejects_what_it_does_not_take():
    R, S = _batches()
    with pytest.raises(ValueError, match="use_kernel"):
        ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="iib", use_kernel=True),
                              device="cpu")
    with pytest.raises(ValueError, match="warm_start"):
        ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="iiib", warm_start=0.1),
                              device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        ShardedKNNStore.build(S, JoinSpec(k=5), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="rows < 4 shards"):
        ShardedKNNStore.build(S.rows(0, 3), JoinSpec(k=5), num_shards=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="bf"))
    store = ShardedKNNStore.build(S, JoinSpec(k=5, algorithm="bf"), num_shards=2,
                                  device="cpu")
    with pytest.raises(ValueError, match="without the LSH band tier"):
        store.query(R, accuracy="approx")
    assert store.resync_replicas() == ()


# -- tree_reduce_topk ---------------------------------------------------------

TREE_SIZES = (1, 2, 3, 5)
N_ROWS, K = 12, 4


def _tree_states(n):
    """n per-shard states with ties across states: scores from {3, 2, 1}
    and -inf, descending per row; ids distinct per state."""
    rng = np.random.default_rng(n)
    vals = np.array([3.0, 2.0, 1.0, -np.inf], np.float32)
    scores = -np.sort(-vals[rng.integers(0, 4, size=(n, N_ROWS, K))], axis=2)
    ids = (np.arange(n)[:, None, None] * 100 + rng.integers(0, 50, size=(n, N_ROWS, K)))
    ids = np.where(np.isfinite(scores), ids, -1).astype(np.int32)
    return scores.astype(np.float32), ids


TREE_JAX = r'''
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.topk import TopKState, tree_reduce_topk
out = {}
for n, (scores, ids) in STATES.items():
    mesh = compat.make_mesh((n,), ("shard",))
    def local(s, i, n=n):
        return tree_reduce_topk(TopKState(scores=s[0], ids=i[0]), ("shard",), n)
    fn = compat.shard_map(local, mesh, in_specs=(P("shard"), P("shard")),
                          out_specs=TopKState(scores=P(), ids=P()))
    red = jax.jit(fn)(jnp.asarray(scores), jnp.asarray(ids))
    out[n] = (np.asarray(red.scores), np.asarray(red.ids))
with open(OUTPUT_PATH, "wb") as f:
    pickle.dump(out, f)
print("TREE_DONE")
'''


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tree_jax") / "tree.pkl")
    states = {n: _tree_states(n) for n in TREE_SIZES}
    code = (f"import pickle\nOUTPUT_PATH = {path!r}\nwith open({path + '.in'!r}, 'rb') as f:\n"
            "    STATES = pickle.load(f)\n" + TREE_JAX)
    with open(path + ".in", "wb") as f:
        pickle.dump(states, f)
    assert "TREE_DONE" in run_with_devices(code, n_devices=max(TREE_SIZES))
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.subproc
@pytest.mark.parametrize("n", TREE_SIZES)
def test_tree_reduce_topk_matches_jax_shard_map(jax_tree, n):
    """Bit for bit the JAX tree reduction under shard_map, ties included
    (the lower shard wins)."""
    scores, ids = _tree_states(n)
    red = tree_reduce_topk([TopKState(torch.from_numpy(scores[i]), torch.from_numpy(ids[i]))
                            for i in range(n)])
    want_s, want_i = jax_tree[n]
    np.testing.assert_array_equal(red.scores.numpy(), want_s)
    np.testing.assert_array_equal(red.ids.numpy(), want_i)


def test_tree_reduce_topk_lower_shard_wins_ties():
    """Equal scores in every state: the lowest shard's ids fill the row."""
    states = [TopKState(torch.ones((2, 3)), torch.full((2, 3), i, dtype=torch.int32))
              for i in range(5)]
    red = tree_reduce_topk(states)
    assert (red.ids == 0).all()
    with pytest.raises(ValueError):
        tree_reduce_topk([])

