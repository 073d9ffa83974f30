"""The port's device meshes (src/repro_torch/launch/mesh.py), the store's
placement on them (launch/sharding.py) and ``ShardedKNNStore(mesh=)``,
on the CPU.

A mesh that repeats one device is the counterpart of the reference's
forced host devices: a store over ``["cpu"] * 4`` must equal the
``num_shards=4`` store bit for bit, every ``JoinStats`` and
``StoreStats`` counter included, for bf, iib and iiib, exact and approx,
through mutations; a ``(2, 2)`` ``('replica', 'shard')`` mesh through a
replica kill, resync and a shard-copy loss; ``save`` then
``load(mesh=)``; and a ``KNNScheduler`` serving a mesh store.  The
builders raise, naming both counts, when asked for more devices than
there are."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import JoinSpec, JoinStats  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    DeviceMesh,
    dp_axes,
    make_host_mesh,
    make_store_mesh,
    replica_submeshes,
)
from repro_torch.launch.sharding import (  # noqa: E402
    placed_numpy,
    placed_shape,
    store_put,
    store_shard_update,
    store_stack_specs,
)
from repro_torch.runtime.fault import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.store import ShardedKNNStore  # noqa: E402

DIM, NNZ = 512, 18
JOIN_FIELDS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
               "device_dispatches", "host_syncs", "candidate_rows", "scanned_rows")
STORE_FIELDS = ("queries", "device_dispatches", "host_syncs", "index_builds", "stack_uploads",
                "placed_shards", "placed_bytes", "deleted", "expired", "compactions",
                "shard_losses", "degraded_queries", "replica_losses", "replica_failovers",
                "resyncs")


def _batches():
    R = synthetic_sparse(45, dim=DIM, nnz_mean=NNZ, seed=0)
    S = synthetic_sparse(131, dim=DIM, nnz_mean=NNZ, seed=1)
    return R, S


def _same(a, b, sa, sb):
    """Two stores' query results and every counter equal, bit for bit."""
    assert torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)
    assert a.missing_shards == b.missing_shards
    for f in JOIN_FIELDS:
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    for ta, tb in zip(a.stats.min_prune_trace, b.stats.min_prune_trace):
        assert np.array_equal(ta, tb)
    for f in STORE_FIELDS:
        assert getattr(sa.stats, f) == getattr(sb.stats, f), f
    assert sa.stats.replica_dispatches == sb.stats.replica_dispatches
    assert sa.shard_rows == sb.shard_rows


# -- the meshes ---------------------------------------------------------------

def test_builders_raise_naming_both_counts():
    """A request for more CUDA devices than there are names what it needs
    and what there is; an explicit list too.  Nothing shrinks to fit."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n + 1} CUDA devices, have {n}"):
        make_store_mesh(n + 1)
    with pytest.raises(ValueError, match=f"need {2 * (n + 1)} CUDA devices, have {n}"):
        make_host_mesh(2, n + 1)
    with pytest.raises(ValueError, match="need 6 devices, have 4"):
        make_store_mesh(3, replicas=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="2 devices cannot host 3 replicas"):
        make_store_mesh(replicas=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        make_store_mesh(2, replicas=0, devices="cpu")
    with pytest.raises(ValueError, match="devices must be"):
        make_store_mesh(2, devices="cuda:0")


def test_mesh_shapes_and_the_device_order():
    m = make_host_mesh(4, 2, devices="cpu")
    assert m.shape == {"data": 4, "model": 2} and m.devices.size == 8
    assert dp_axes(m) == ("data",)
    s = make_store_mesh(4, devices="cpu")
    assert s.axis_names == ("shard",) and s.shape == {"shard": 4}
    assert make_store_mesh(devices="cpu").shape == {"shard": 1}
    assert make_store_mesh(devices=["cpu"] * 3).shape == {"shard": 3}
    # positions over several axes flatten in the order the axes are named,
    # every other axis at index 0
    grid = np.array([[f"cpu:{4 * i + j}" for j in range(4)] for i in range(2)], dtype=object)
    labelled = DeviceMesh(grid, ("data", "model"))
    assert [d.index for d in labelled.devices_along(("data",))] == [0, 4]
    assert [d.index for d in labelled.devices_along(("model",))] == [0, 1, 2, 3]
    assert [d.index for d in labelled.devices_along(("model", "data"))] == [0, 4, 1, 5, 2, 6,
                                                                           3, 7]
    with pytest.raises(ValueError, match="not in the mesh"):
        labelled.devices_along(("shard",))
    with pytest.raises(ValueError, match="axis names"):
        DeviceMesh(grid, ("data",))


def test_replica_submeshes_shapes():
    mesh = make_store_mesh(3, replicas=2, devices=[f"cpu:{i}" for i in range(6)])
    assert mesh.shape == {"replica": 2, "shard": 3}
    subs = replica_submeshes(mesh)
    assert len(subs) == 2
    for r, sub in enumerate(subs):
        assert sub.axis_names == ("shard",) and sub.shape == {"shard": 3}
        assert [d.index for d in sub.devices_along(("shard",))] == [3 * r, 3 * r + 1, 3 * r + 2]


def test_store_put_and_shard_update():
    """Each leaf's shard slices on the mesh positions' devices, owning
    their memory; an update rewrites one shard's tensor only and refuses
    a slice of another geometry."""
    mesh = make_store_mesh(3, devices=["cpu"] * 3)
    tree = {"a": np.arange(24, dtype=np.int32).reshape(3, 2, 4),
            "b": np.ones((3, 5), bool)}
    assert store_stack_specs(tree, "shard") == {"a": (("shard",), None, None),
                                                "b": (("shard",), None)}
    placed = store_put(tree, mesh, ("shard",))
    for k, host in tree.items():
        assert placed_shape(placed[k]) == host.shape
        assert np.array_equal(placed_numpy(placed[k]), host)
        for t in placed[k]:
            assert t.device.type == "cpu" and not np.shares_memory(t.numpy(), host)
    before = [t.clone() for t in placed["a"]]
    new = np.full((1, 2, 4), -7, np.int32)
    out = store_shard_update(placed["a"], 1, new)
    assert out is placed["a"]
    assert torch.equal(out[0], before[0]) and torch.equal(out[2], before[2])
    assert (out[1] == -7).all()
    with pytest.raises(ValueError, match="geometry changed"):
        store_shard_update(placed["a"], 0, np.zeros((1, 3, 4), np.int32))
    with pytest.raises(ValueError, match="3 shards on 2 mesh positions"):
        store_put(tree, make_store_mesh(2, devices="cpu"), ("shard",))


# -- the store over a mesh ----------------------------------------------------

@pytest.mark.parametrize("alg", ["bf", "iib", "iiib"])
@pytest.mark.parametrize("acc", ["exact", "approx"])
def test_store_over_repeated_device_mesh_equals_num_shards_store(alg, acc):
    """A mesh of ["cpu"] * 4 and num_shards=4: every query and counter
    equal, through add (TTL), delete, expire and compact."""
    R, S = _batches()
    kw = {"target_recall": 0.9} if acc == "approx" else {}
    spec = JoinSpec(k=5, algorithm=alg, s_block=16, r_block=20, **kw)
    flat = ShardedKNNStore.build(S, spec, num_shards=4, device="cpu")
    meshed = ShardedKNNStore.build(S, spec, mesh=make_store_mesh(4, devices="cpu"))
    assert meshed.n_shards == 4 and meshed.device == torch.device("cpu")
    steps = [lambda st: None,
             lambda st: st.add(synthetic_sparse(21, dim=DIM, nnz_mean=NNZ, seed=7),
                               ttl=10.0, now=100.0),
             lambda st: st.delete([0, 5, 40, 66, 99, 130]),
             lambda st: st.expire(now=120.0),
             lambda st: st.compact(shards=[0, 1])]
    for step in steps:
        np.testing.assert_array_equal(np.asarray(step(flat)), np.asarray(step(meshed)))
        a, b = JoinStats(), JoinStats()
        _same(flat.query(R, stats=a), meshed.query(R, stats=b), flat, meshed)


def test_replica_mesh_failover_and_resync_equal_replicas_store():
    """A (2, 2) ('replica', 'shard') mesh against replicas=2 x num_shards=2:
    a replica kill mid-query, writes while it is dead, resync, the
    half-open probe and a shard-copy loss, every result and counter equal."""
    R, S = _batches()
    spec = JoinSpec(k=5, algorithm="iib", s_block=16, r_block=20)
    flat = ShardedKNNStore.build(S, spec, num_shards=2, replicas=2, device="cpu")
    meshed = ShardedKNNStore.build(S, spec, mesh=make_store_mesh(2, replicas=2, devices="cpu"))
    assert meshed.n_replicas == 2 and meshed.n_shards == 2
    stores = (flat, meshed)

    def query_both(fault=None):
        for st in stores:
            st.fault_plan = FaultPlan(fault) if fault else None
        _same(flat.query(R), meshed.query(R), flat, meshed)
        for st in stores:
            st.fault_plan = None

    query_both()
    query_both([FaultSpec("replica_error", replica=1)])
    assert meshed.dead_replicas == (1,) and meshed.stats.replica_failovers == 1
    for st in stores:
        st.add(synthetic_sparse(10, dim=DIM, nnz_mean=NNZ, seed=2))
        st.delete([3, 40])
    assert flat._replica_dirty == meshed._replica_dirty
    query_both()                        # while replica 1 is dead
    assert flat.resync_replicas() == meshed.resync_replicas() == (1,)
    assert meshed.verify_replicas()
    query_both()                        # the half-open probe
    query_both([FaultSpec("shard_error", shard=0, at_dispatch=0)])
    assert flat.resync_replicas() == meshed.resync_replicas()
    assert meshed.verify_replicas()
    query_both()
    assert meshed.stats.resyncs == 2


def test_mesh_store_save_then_load_on_a_mesh(tmp_path):
    """save, then load onto a mesh of the saved shard count: bit for bit;
    onto a mesh of 2: within float32 rounding (other blocks)."""
    R, S = _batches()
    spec = JoinSpec(k=5, algorithm="iiib", s_block=16, r_block=20)
    store = ShardedKNNStore.build(S, spec, mesh=make_store_mesh(4, devices="cpu"))
    store.delete([1, 2, 77])
    want = store.query(R)
    store.save(str(tmp_path))
    loaded = ShardedKNNStore.load(str(tmp_path), mesh=make_store_mesh(4, devices=["cpu"] * 4))
    got = loaded.query(R)
    assert loaded.n_shards == 4 and not loaded._dirty
    assert torch.equal(got.scores, want.scores) and torch.equal(got.ids, want.ids)
    two = ShardedKNNStore.load(str(tmp_path), mesh=make_store_mesh(2, devices="cpu"))
    assert two.n_shards == 2
    np.testing.assert_allclose(two.query(R).scores.numpy(), want.scores.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_store_mesh_arguments_that_disagree_raise():
    _, S = _batches()
    spec = JoinSpec(k=5, algorithm="bf", s_block=16)
    mesh = make_store_mesh(4, devices="cpu")
    with pytest.raises(ValueError, match="not both"):
        ShardedKNNStore(S, spec, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="num_shards=2 but the mesh holds 4"):
        ShardedKNNStore(S, spec, mesh=mesh, num_shards=2)
    with pytest.raises(ValueError, match="replicas=3 but the mesh holds 1"):
        ShardedKNNStore(S, spec, mesh=mesh, replicas=3)
    with pytest.raises(ValueError, match="pass mesh="):
        ShardedKNNStore(S, spec, axes=("shard",), device="cpu")
    # a mesh axis other than 'replica' outside ``axes`` holds no copy: the
    # store shards over ``data`` at model position 0
    host = make_host_mesh(4, 2, devices="cpu")
    st = ShardedKNNStore(S, spec, mesh=host, axes=("data",))
    assert st.n_shards == 4 and st.n_replicas == 1


def test_scheduler_serves_a_mesh_store():
    """A KNNScheduler over a store on a mesh: every request answered, each
    within tolerance of the num_shards=4 store's direct query of its rows."""
    import asyncio

    from repro_torch.serve import KNNScheduler, ServeConfig
    from repro_torch.testing import assert_topk_close

    R, S = _batches()
    spec = JoinSpec(k=5, algorithm="iib", s_block=16, r_block=20)
    store = ShardedKNNStore.build(S, spec, mesh=make_store_mesh(4, devices="cpu"))
    flat = ShardedKNNStore.build(S, spec, num_shards=4, device="cpu")
    reqs = [R.rows(i, i + 9) for i in range(0, 45, 9)]

    async def main():
        async with KNNScheduler(store, ServeConfig(r_block=20, window_s=0.001)) as sched:
            outs = await asyncio.gather(*[sched.submit(q, k=5) for q in reqs])
            return outs, sched.metrics

    outs, metrics = asyncio.run(main())
    assert metrics.failed == 0 and len(outs) == len(reqs)
    for q, (ids, scores) in zip(reqs, outs):
        want = flat.query(q)
        assert_topk_close(scores, ids, want.scores.numpy(), want.ids.numpy(), 1e-5, 1e-6)
