"""The port's durable store (``ShardedKNNStore.save`` / ``save_dirty`` /
``load`` / ``recover`` in src/repro_torch/store/sharded.py) against the
JAX package's on the same seeded inputs, on the CPU.

The JAX store needs one device a shard, so it runs in a subprocess with 4
forced host devices (``tests/util_subproc.py::run_with_devices``), runs
the scenario code in ``SCENARIOS`` against its package, writes its
checkpoints under the test's ``tmp_path`` and dumps what it saw; the port
runs the same code in-process, 4 shards on the CPU.  The scenario is the
reference's durability prelude (tests/test_store_durability.py: S 160
rows, dim 1024, 16 features a row, k 5, r_block 32, s_block 48): for bf,
iib and iiib, exact and approx, two adds (one with a TTL), three deletes
and an expiry, ``save``, one more add and a delete, ``save_dirty``; then
``mark_lost`` and ``recover``; and, on iib, the reference's two-step
rollback (the newest step destroyed) and corrupt-leaf fallback.

Held: the two packages' checkpoints are the same files (every manifest
leaf's path, file, shape, dtype and sha256, and ``extra["store"]``), and
``save_dirty`` hard-links the same leaves; the port's ``load`` of the
JAX-written checkpoint answers within ``assert_topk_close`` of the JAX
store (scores rtol=1e-5, atol=1e-6, ids equal outside tie groups) with
every JoinStats and StoreStats counter equal to the JAX store's own load;
the port's own save → load is bit for bit its store, at 4 shards and
elastically at 2 and 8; ``recover`` (and the rollback and fallback cases)
ends as the JAX store's does."""
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.engine import JoinSpec, JoinStats  # noqa: E402
from repro_torch.runtime.fault import corrupt_checkpoint_leaf  # noqa: E402
from repro_torch.sparse.datagen import synthetic_sparse  # noqa: E402
from repro_torch.sparse.format import from_arrays  # noqa: E402
from repro_torch.store import ShardedKNNStore  # noqa: E402
from repro_torch.testing import assert_topk_close  # noqa: E402
from tests.util_subproc import run_with_devices  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
DIM, NNZ = 1024, 16
# name -> (rows, seed): the reference prelude's batches
INPUTS = {"S": (160, 0), "A1": (12, 1), "A2": (8, 2), "A3": (4, 3), "R": (24, 9)}
CASES = [(alg, acc) for acc in ("exact", "approx") for alg in ("bf", "iib", "iiib")]

# The scenario code both packages run.  ``api`` adapts the package: its
# JoinSpec and JoinStats, ``store(S, spec)`` (4 shards), ``load(d, **kw)``,
# ``data(name)``, ``ckpt`` (latest_step), ``corrupt`` and ``asnp``.
SCENARIOS = r'''
import json, os, shutil
import numpy as np

JOIN_FIELDS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
               "device_dispatches", "host_syncs", "candidate_rows", "scanned_rows")
STORE_FIELDS = ("queries", "device_dispatches", "host_syncs", "index_builds", "stack_uploads",
                "placed_shards", "placed_bytes", "deleted", "expired", "compactions", "saves",
                "shard_losses", "degraded_queries", "recoveries")


def qrec(out, tag, store, R, api):
    st = api.JoinStats()
    res = store.query(R, stats=st)
    out[tag + "/scores"] = api.asnp(res.scores)
    out[tag + "/ids"] = api.asnp(res.ids)
    out[tag + "/join"] = {f: getattr(st, f) for f in JOIN_FIELDS}
    out[tag + "/store"] = {f: getattr(store.stats, f) for f in STORE_FIELDS}
    out[tag + "/lost"] = tuple(int(i) for i in store.lost_shards)


def manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def linked(d):
    """Paths of step 1 whose file is step 0's inode (hard-linked)."""
    m0 = {e["path"]: e["file"] for e in manifest(d, 0)["leaves"]}
    out = []
    for e in manifest(d, 1)["leaves"]:
        i1 = os.stat(os.path.join(d, "step_00000001", e["file"])).st_ino
        i0 = os.stat(os.path.join(d, "step_00000000", m0[e["path"]])).st_ino
        if i0 == i1:
            out.append(e["path"])
    return out


def spec_of(api, alg, acc):
    kw = {"target_recall": 0.9} if acc == "approx" else {}
    return api.JoinSpec(k=5, algorithm=alg, r_block=32, s_block=48, **kw)


def lifecycle(out, api, root, alg, acc):
    p = f"{alg}/{acc}/"
    d = os.path.join(root, f"{alg}_{acc}")
    R = api.data("R")
    store = api.store(api.data("S"), spec_of(api, alg, acc))
    store.add(api.data("A1"), ttl=2.0, now=0.0)
    store.add(api.data("A2"))
    store.delete([0, 3, 7])
    store.expire(now=5.0)
    out[p + "path0"] = os.path.basename(store.save(d, extra={"tag": alg}))
    out[p + "dirty0"] = sorted(store._dirty)
    out[p + "add3"] = np.asarray(store.add(api.data("A3")))
    store.delete([11])
    out[p + "dirty1"] = sorted(store._dirty)
    out[p + "path1"] = os.path.basename(store.save_dirty(d, extra={"tag": alg}))
    out[p + "manifests"] = (manifest(d, 0), manifest(d, 1))
    out[p + "linked"] = linked(d)
    qrec(out, p + "saved", store, R, api)
    loaded = api.load(d)
    out[p + "loaded_meta"] = (loaded.n_shards, loaded.num_vectors, dict(loaded.loaded_extra),
                              sorted(loaded._dirty), loaded._dirty_rank)
    qrec(out, p + "loaded", loaded, R, api)
    qrec(out, p + "loaded_again", loaded, R, api)
    el = api.load(d, num_shards=2)
    out[p + "elastic2_dirty"] = sorted(el._dirty)
    qrec(out, p + "elastic2", el, R, api)
    store.mark_lost(1)
    out[p + "recovered"] = tuple(int(i) for i in store.recover(d))
    qrec(out, p + "recover", store, R, api)


def rollback(out, api, root):
    """The newest commit destroyed wholesale: recover() resolves the
    previous step and shard 0 rolls back to it."""
    d = os.path.join(root, "rollback")
    R = api.data("R")
    store = api.store(api.data("S"), spec_of(api, "iib", "exact"))
    store.save(d)
    qrec(out, "rollback/r0", store, R, api)
    store.add(api.data("A3"))                 # -> shard 0
    store.save(d)
    out["rollback/latest"] = api.ckpt.latest_step(d)
    shutil.rmtree(os.path.join(d, "step_00000001"))
    out["rollback/latest_after"] = api.ckpt.latest_step(d)
    store.mark_lost(0)
    out["rollback/recovered"] = tuple(int(i) for i in store.recover(d))
    qrec(out, "rollback/after", store, R, api)


def fallback(out, api, root):
    """A corrupt leaf in the newest commit: a pinned recover raises, the
    default one (and load) fall back to the previous valid step."""
    d = os.path.join(root, "fallback")
    R = api.data("R")
    store = api.store(api.data("S"), spec_of(api, "iib", "exact"))
    store.save(d)
    qrec(out, "fallback/r0", store, R, api)
    store.add(api.data("A3"))                 # -> shard 0
    store.save(d)
    out["fallback/corrupted"] = os.path.basename(api.corrupt(d))
    store.mark_lost(0)
    try:
        store.recover(d, step=1)
        out["fallback/pinned"] = "recovered"
    except ValueError as e:
        out["fallback/pinned"] = "corrupt checkpoint leaf" in str(e)
    out["fallback/lost_after_pinned"] = tuple(int(i) for i in store.lost_shards)
    out["fallback/recovered"] = tuple(int(i) for i in store.recover(d))
    qrec(out, "fallback/after", store, R, api)
    qrec(out, "fallback/load", api.load(d), R, api)


def run_all(api, root):
    out = {}
    for alg, acc in CASES:
        lifecycle(out, api, root, alg, acc)
    rollback(out, api, root)
    fallback(out, api, root)
    return out
'''

JAX_ADAPTER = r'''
import pickle, types
import numpy as np
import jax.numpy as jnp
from repro.checkpoint import ckpt
from repro.core.engine import JoinSpec, JoinStats
from repro.launch.mesh import make_store_mesh
from repro.runtime.fault import corrupt_checkpoint_leaf
from repro.sparse.format import SparseBatch
from repro.store import ShardedKNNStore

inputs = np.load(INPUT_PATH)

def data(name):
    return SparseBatch(indices=jnp.asarray(inputs[name + "_idx"]),
                       values=jnp.asarray(inputs[name + "_val"]),
                       nnz=jnp.asarray(inputs[name + "_nnz"]), dim=int(inputs["dim"]))

def load(d, num_shards=4):
    return ShardedKNNStore.load(d, mesh=make_store_mesh(num_shards))

api = types.SimpleNamespace(
    JoinSpec=JoinSpec, JoinStats=JoinStats, data=data, load=load, ckpt=ckpt,
    store=lambda S, spec: ShardedKNNStore.build(S, spec, mesh=make_store_mesh(4)),
    corrupt=corrupt_checkpoint_leaf, asnp=np.asarray)
with open(OUTPUT_PATH, "wb") as f:
    pickle.dump(run_all(api, ROOT), f)
print("JAX_DURABILITY_DONE")
'''


def _namespace():
    ns = {"CASES": CASES}
    exec(compile(SCENARIOS, "<durability scenarios>", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    arrays = {"dim": np.asarray(DIM)}
    for name, (rows, seed) in INPUTS.items():
        b = synthetic_sparse(rows, dim=DIM, nnz_mean=NNZ, seed=seed)
        arrays[name + "_idx"] = b.indices.numpy()
        arrays[name + "_val"] = b.values.numpy()
        arrays[name + "_nnz"] = b.nnz.numpy()
    path = tmp_path_factory.mktemp("durability_inputs") / "inputs.npz"
    np.savez(path, **arrays)
    return arrays, str(path)


@pytest.fixture(scope="module")
def jax_run(inputs, tmp_path_factory):
    """(results, checkpoint root) of the JAX store (4 forced host devices)."""
    root = str(tmp_path_factory.mktemp("ckpt_jax"))
    out_path = os.path.join(root, "out.pkl")
    code = (f"INPUT_PATH = {inputs[1]!r}\nOUTPUT_PATH = {out_path!r}\nROOT = {root!r}\n"
            f"CASES = {CASES!r}\n" + SCENARIOS + JAX_ADAPTER)
    assert "JAX_DURABILITY_DONE" in run_with_devices(code, n_devices=4)
    with open(out_path, "rb") as f:
        return pickle.load(f), root


def _port_api(arrays):
    import types

    def data(name):
        return from_arrays(arrays[name + "_idx"], arrays[name + "_val"],
                           arrays[name + "_nnz"], DIM)

    return types.SimpleNamespace(
        JoinSpec=JoinSpec, JoinStats=JoinStats, data=data, ckpt=ckpt,
        store=lambda S, spec: ShardedKNNStore.build(S, spec, num_shards=4, device="cpu"),
        load=lambda d, num_shards=4: ShardedKNNStore.load(d, num_shards=num_shards,
                                                          device="cpu"),
        corrupt=corrupt_checkpoint_leaf, asnp=lambda t: t.numpy())


@pytest.fixture(scope="module")
def port_run(inputs, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_port"))
    return _namespace()["run_all"](_port_api(inputs[0]), root), root


def _close(port, jax, tag):
    assert_topk_close(port[tag + "/scores"], port[tag + "/ids"], jax[tag + "/scores"],
                      jax[tag + "/ids"], RTOL, ATOL)
    assert port[tag + "/join"] == jax[tag + "/join"], tag
    assert port[tag + "/store"] == jax[tag + "/store"], tag
    assert port[tag + "/lost"] == jax[tag + "/lost"], tag


def _same_bits(out, a, b):
    assert np.array_equal(out[a + "/ids"], out[b + "/ids"]), (a, b)
    assert np.array_equal(out[a + "/scores"], out[b + "/scores"]), (a, b)


@pytest.mark.subproc
@pytest.mark.parametrize("alg,acc", CASES)
def test_checkpoints_are_the_reference_files(port_run, jax_run, alg, acc):
    """Both steps (the save, then save_dirty) hold the same leaves as the
    JAX store's: path, file, shape, dtype and sha256, in the same order,
    and the same ``extra`` (the store's meta and the caller's tag)."""
    port, jax = port_run[0], jax_run[0]
    p = f"{alg}/{acc}/"
    for step in (0, 1):
        got, want = port[p + "manifests"][step], jax[p + "manifests"][step]
        assert got["extra"] == want["extra"], (step, got["extra"], want["extra"])
        assert got["leaves"] == want["leaves"], step
        assert got == want
    # jax's order: sorted keys, so the rank (iiib) leads, then shard 0's
    # alive, deadline, gids, idx, nnz, val
    first = [e["path"] for e in port[p + "manifests"][0]["leaves"]][:2]
    assert first == (["['rank']", "['shard_00000']['alive']"] if alg == "iiib" else
                     ["['shard_00000']['alive']", "['shard_00000']['deadline']"])
    for key in ("path0", "path1", "dirty0", "dirty1"):
        assert port[p + key] == jax[p + key], key
    np.testing.assert_array_equal(port[p + "add3"], jax[p + "add3"])


@pytest.mark.subproc
@pytest.mark.parametrize("alg,acc", CASES)
def test_save_dirty_links_exactly_the_clean_shards(port_run, jax_run, alg, acc):
    port, jax = port_run[0], jax_run[0]
    p = f"{alg}/{acc}/"
    dirty = port[p + "dirty1"]
    assert dirty and len(dirty) < 4
    want = {f"['shard_{i:05d}']['{leaf}']" for i in range(4) if i not in dirty
            for leaf in ("idx", "val", "nnz", "alive", "deadline", "gids")}
    if alg == "iiib":
        want.add("['rank']")              # no refreeze since the save
    assert set(port[p + "linked"]) == want
    assert port[p + "linked"] == jax[p + "linked"]


@pytest.mark.subproc
@pytest.mark.parametrize("alg,acc", CASES)
def test_port_loads_the_jax_checkpoint(inputs, jax_run, alg, acc):
    """The port's load of the JAX-written checkpoint (its newest step, the
    save_dirty) answers within tolerance of the JAX store, with every
    counter equal to the JAX store's own load of it."""
    jax, root = jax_run
    p = f"{alg}/{acc}/"
    R = _port_api(inputs[0]).data("R")
    loaded = ShardedKNNStore.load(os.path.join(root, f"{alg}_{acc}"), device="cpu")
    assert (loaded.n_shards, loaded.num_vectors, dict(loaded.loaded_extra)) == \
        jax[p + "loaded_meta"][:3]
    out = {}
    _namespace()["qrec"](out, "x", loaded, R, _port_api(None))
    assert_topk_close(out["x/scores"], out["x/ids"], jax[p + "saved/scores"],
                      jax[p + "saved/ids"], RTOL, ATOL)
    assert out["x/join"] == jax[p + "loaded/join"]
    assert out["x/store"] == jax[p + "loaded/store"]


@pytest.mark.subproc
@pytest.mark.parametrize("alg,acc", CASES)
def test_load_and_recover_match_the_jax_store(port_run, jax_run, alg, acc):
    """The port's own round trip is bit for bit (load at 4 shards, twice,
    with index builds frozen; elastic at 2), and each outcome is the JAX
    store's within tolerance with every counter equal."""
    port, jax = port_run[0], jax_run[0]
    p = f"{alg}/{acc}/"
    for tag in ("saved", "loaded", "loaded_again", "elastic2", "recover"):
        _close(port, jax, p + tag)
    for tag in ("loaded", "loaded_again", "elastic2", "recover"):
        _same_bits(port, p + "saved", p + tag)
    assert port[p + "loaded_meta"] == jax[p + "loaded_meta"]
    assert port[p + "loaded_meta"][3:] == ([], False)      # same layout: clean
    assert port[p + "elastic2_dirty"] == jax[p + "elastic2_dirty"] == [0, 1]
    builds = port[p + "loaded/store"]["index_builds"]
    assert port[p + "loaded_again/store"]["index_builds"] == builds
    assert port[p + "loaded/join"]["index_builds"] == 0
    assert port[p + "recovered"] == jax[p + "recovered"] == (1,)
    assert port[p + "recover/store"]["recoveries"] == 1


@pytest.mark.subproc
def test_recover_when_only_previous_step_survives(port_run, jax_run):
    port, jax = port_run[0], jax_run[0]
    assert (port["rollback/latest"], port["rollback/latest_after"]) == (1, 0)
    for key in ("rollback/latest", "rollback/latest_after", "rollback/recovered"):
        assert port[key] == jax[key], key
    assert port["rollback/recovered"] == (0,)
    for tag in ("rollback/r0", "rollback/after"):
        _close(port, jax, tag)
    _same_bits(port, "rollback/r0", "rollback/after")


@pytest.mark.subproc
def test_corrupt_leaf_recovery_falls_back_to_previous_step(port_run, jax_run):
    port, jax = port_run[0], jax_run[0]
    for key in ("fallback/corrupted", "fallback/pinned", "fallback/lost_after_pinned",
                "fallback/recovered"):
        assert port[key] == jax[key], key
    assert port["fallback/pinned"] is True
    assert port["fallback/lost_after_pinned"] == (0,) and port["fallback/recovered"] == (0,)
    for tag in ("fallback/r0", "fallback/after", "fallback/load"):
        _close(port, jax, tag)
    _same_bits(port, "fallback/r0", "fallback/after")
    _same_bits(port, "fallback/r0", "fallback/load")


# -- the port alone -----------------------------------------------------------

def _store(alg="iib", shards=4, **kw):
    S = synthetic_sparse(160, dim=DIM, nnz_mean=NNZ, seed=0)
    return ShardedKNNStore.build(S, JoinSpec(k=5, algorithm=alg, r_block=32, s_block=48),
                                 num_shards=shards, device="cpu", **kw)


@pytest.mark.parametrize("alg", ["bf", "iib", "iiib"])
def test_elastic_load_at_eight_shards_and_replicas_bit_for_bit(tmp_path, alg):
    """A save of 4 shards loads at 8 shards, and replicated (2 x 4), with
    the saved store's answer bit for bit; a replicated store saves the
    same leaves an unreplicated one does (one logical copy)."""
    R = synthetic_sparse(24, dim=DIM, nnz_mean=NNZ, seed=9)
    store = _store(alg)
    store.add(synthetic_sparse(12, dim=DIM, nnz_mean=NNZ, seed=1), ttl=2.0, now=0.0)
    store.delete([0, 3, 7])
    store.expire(now=5.0)
    store.save(str(tmp_path / "a"))
    want = store.query(R)
    for kw in ({"num_shards": 8}, {"replicas": 2}):
        got = ShardedKNNStore.load(str(tmp_path / "a"), device="cpu", **kw).query(R)
        assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores), kw
    rep = ShardedKNNStore.load(str(tmp_path / "a"), replicas=2, device="cpu")
    rep.save(str(tmp_path / "b"))
    a = ckpt.load_arrays(str(tmp_path / "a"), 0)[0]
    b = ckpt.load_arrays(str(tmp_path / "b"), 0)[0]
    assert list(a) == list(b)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path])


def test_elastic_load_is_dirty_and_saves_in_full(tmp_path):
    """An elastic load re-partitions the rows, so its first save_dirty
    writes every leaf (nothing to link); a same-layout load links all."""
    store = _store()
    store.save(str(tmp_path))
    el = ShardedKNNStore.load(str(tmp_path), num_shards=2, device="cpu")
    assert el._dirty == {0, 1} and el._last_save_dir is None
    same = ShardedKNNStore.load(str(tmp_path), device="cpu")
    assert not same._dirty and same._last_save_dir.endswith("step_00000000")
    path = same.save_dirty(str(tmp_path))
    inodes = [_inodes(os.path.join(tmp_path, "step_00000000")), _inodes(path)]
    assert inodes[0] == inodes[1]
    path = el.save_dirty(str(tmp_path))
    assert not set(_inodes(path).values()) & set(inodes[0].values())


def _inodes(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {e["path"]: os.stat(os.path.join(step_dir, e["file"])).st_ino for e in leaves}


def test_durability_spans_and_counters(tmp_path):
    """ckpt.save, ckpt.load and recover are spans in the flight recorder;
    saves, save_wall_s, recoveries and recovery_wall_s count."""
    from repro_torch.obs import recorder as obs_recorder

    rec = obs_recorder.FlightRecorder()
    obs_recorder.set_recorder(rec)
    try:
        store = _store()
        store.save(str(tmp_path))
        store.save_dirty(str(tmp_path))
        ShardedKNNStore.load(str(tmp_path), device="cpu")
        store.mark_lost(2)
        assert store.recover(str(tmp_path)) == (2,)
        assert store.recover(str(tmp_path)) == ()           # nothing lost
        names = [e["name"] for e in rec.events("span")]
        kinds = [e["kind"] for e in rec.events()]
    finally:
        obs_recorder.set_recorder(None)
    assert names.count("ckpt.save") == 2 and "ckpt.load" in names and "recover" in names
    assert "shard_recovered" in kinds
    assert store.stats.saves == 2 and store.stats.save_wall_s > 0
    assert store.stats.recoveries == 1 and store.stats.recovery_wall_s > 0
    assert store._dirty == {2}


def test_recover_and_load_refuse_what_they_cannot_do(tmp_path):
    store = _store()
    with pytest.raises(FileNotFoundError):
        ShardedKNNStore.load(str(tmp_path / "none"), device="cpu")
    store.save(str(tmp_path / "four"))
    other = _store(shards=2)
    other.save(str(tmp_path / "two"))
    store.mark_lost(0)
    with pytest.raises(ValueError, match="shard layout does not match"):
        store.recover(str(tmp_path / "two"))
    with pytest.raises(FileNotFoundError):
        store.recover(str(tmp_path / "none"))
    assert store.lost_shards == (0,)
    with pytest.raises(ValueError, match="mesh"):
        ShardedKNNStore.load(str(tmp_path / "four"), device="cpu", mesh=object())


@pytest.mark.parametrize("alg", ["bf", "iib", "iiib"])
def test_shard_compacted_below_s_block_loads_and_recovers(tmp_path, alg):
    """A shard compacted below the store's block size (40 → 28 rows at
    s_block 32) saves, loads at the saved block size and recovers, bit for
    bit.  The reference re-blocks every shard at 28 rows on load and raises
    in recover for bf and iiib (ROADMAP queue 3)."""
    S = synthetic_sparse(160, dim=DIM, nnz_mean=NNZ, seed=0)
    R = synthetic_sparse(24, dim=DIM, nnz_mean=NNZ, seed=9)
    spec = JoinSpec(k=5, algorithm=alg, r_block=32, s_block=32)
    store = ShardedKNNStore.build(S, spec, num_shards=4, device="cpu")
    store.delete(np.arange(40, 52))
    store.compact(shards=[1])
    assert [s.n_s for s in store.shards] == [40, 28, 40, 40] and store.s_block == 32
    store.save(str(tmp_path))
    want = store.query(R)
    loaded = ShardedKNNStore.load(str(tmp_path), device="cpu")
    assert loaded.s_block == 32 and loaded._num_blocks_stacked == store._num_blocks_stacked
    got = loaded.query(R)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    store.mark_lost(1)
    assert store.recover(str(tmp_path)) == (1,)
    assert store.shards[1].s_block == 32 and store.shards[1].num_blocks == 1
    back = store.query(R)
    assert torch.equal(back.ids, want.ids) and torch.equal(back.scores, want.scores)
    for key, host in store._stacked_host.items():
        np.testing.assert_array_equal(host, loaded._stacked_host[key])
