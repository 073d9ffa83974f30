"""The port's checkpoint module (src/repro_torch/checkpoint/ckpt.py) and
its ``corrupt_checkpoint_leaf``: the counterparts of
tests/test_checkpoint.py's cases (atomic commit, integrity, elastic
restore through ``place_fn``, GC, crash-window recovery, SIGKILL mid-save,
incremental hard-link saves, path-addressed partial loads, copy-on-write
corruption), then the two packages against each other: the flattener's
paths and order equal ``jax.tree_util.keystr`` over
``tree_flatten_with_path``, the same tree saved by each gives the same
manifest (paths, shapes, dtypes, sha256), and a checkpoint written by
either package loads in the other with equal arrays."""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro_torch.checkpoint.ckpt import (  # noqa: E402
    CheckpointManager,
    latest_step,
    leaf_paths,
    load_arrays,
    restore,
    save,
)
from repro_torch.runtime.fault import corrupt_checkpoint_leaf  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
                   "b": torch.from_numpy(rng.standard_normal(16).astype(np.float32))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v) for k, v in tree["params"].items()},
            "step": torch.zeros_like(tree["step"])}


def _assert_trees_equal(a, b):
    pa, pb = leaf_paths(a), leaf_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save(str(tmp_path), 5, tree, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 5
    restored, extra = restore(str(tmp_path), 5, _zeros_like(tree))
    assert extra == {"note": "x"}
    _assert_trees_equal(tree, restored)
    assert isinstance(restored["params"]["w"], torch.Tensor)
    assert restored["params"]["w"].device.type == "cpu"


def test_corrupted_checkpoint_is_skipped(tmp_path):
    save(str(tmp_path), 1, _tree(1))
    save(str(tmp_path), 2, _tree(2))
    d = tmp_path / "step_00000002"
    leaf = next(p for p in os.listdir(d) if p.endswith(".npy"))
    with open(d / leaf, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff")
    assert latest_step(str(tmp_path)) == 1  # falls back to the valid one


def test_partial_tmp_dir_ignored(tmp_path):
    save(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp-999")
    assert latest_step(str(tmp_path)) == 3
    CheckpointManager(str(tmp_path))        # the manager GCs stale tmp dirs
    assert not (tmp_path / "step_00000009.tmp-999").exists()


def test_manager_keeps_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_sync(s, _tree(s))
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_async_save_snapshots_the_tree(tmp_path):
    """save_async commits in the background what the tree held when it was
    called: an in-place update afterwards does not reach the commit."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(11)
    want = tree["params"]["w"].clone()
    mgr.save_async(11, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 11
    restored, _ = restore(str(tmp_path), 11, _zeros_like(tree))
    assert torch.equal(restored["params"]["w"], want)


def test_elastic_restore_place_fn(tmp_path):
    """Restore through ``place_fn`` (the hook that puts each leaf where the
    caller wants it: a device, a dtype, a slice)."""
    tree = _tree(5)
    save(str(tmp_path), 1, tree)
    placed = []

    def place_fn(path, arr):
        placed.append(path)
        return torch.from_numpy(arr).to(torch.float64)

    restored, _ = restore(str(tmp_path), 1, _zeros_like(tree), place_fn=place_fn)
    assert placed == ["['params']['b']", "['params']['w']", "['step']"]
    assert restored["params"]["w"].dtype == torch.float64
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  tree["params"]["w"].numpy().astype(np.float64))


def test_shape_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), 1, {"w": torch.zeros(5)})


def test_junk_step_names_ignored(tmp_path):
    save(str(tmp_path), 4, _tree())
    os.makedirs(tmp_path / "step_notanumber")
    os.makedirs(tmp_path / "step_12extra")
    (tmp_path / "step_99999999").write_text("a FILE, not a checkpoint dir")
    (tmp_path / "step_").mkdir()
    assert latest_step(str(tmp_path)) == 4
    CheckpointManager(str(tmp_path))           # the GC sweep must not crash


def test_overwrite_same_step_is_atomic(tmp_path):
    save(str(tmp_path), 1, _tree(1))
    save(str(tmp_path), 1, _tree(2))
    assert latest_step(str(tmp_path)) == 1
    restored, _ = restore(str(tmp_path), 1, _zeros_like(_tree()))
    assert torch.equal(restored["params"]["w"], _tree(2)["params"]["w"])
    assert not [n for n in os.listdir(tmp_path) if ".old-" in n]


def test_orphaned_old_dir_adopted(tmp_path):
    save(str(tmp_path), 2, _tree(3))
    os.rename(tmp_path / "step_00000002", tmp_path / "step_00000002.old-777")
    assert latest_step(str(tmp_path)) == 2     # adopted
    assert (tmp_path / "step_00000002").is_dir()
    assert not (tmp_path / "step_00000002.old-777").exists()


@pytest.mark.subproc
def test_sigkill_mid_save_falls_back(tmp_path):
    """A process SIGKILLed mid-write (one that imports no jax) leaves a torn
    tmp dir; latest_step resolves the previous committed step."""
    save(str(tmp_path), 1, _tree(1))
    code = f"""
import os, signal, sys
import numpy as np
import torch
from repro_torch.checkpoint.ckpt import save

real_save = np.save
def killing_save(file, arr, *a, **kw):
    real_save(file, arr, *a, **kw)
    os.kill(os.getpid(), signal.SIGKILL)      # die after the FIRST leaf
np.save = killing_save
save({str(tmp_path)!r}, 2, {{"params": {{"w": torch.ones((8, 16)), "b": torch.ones(16)}},
                             "step": torch.tensor(9, dtype=torch.int32)}})
assert "jax" not in sys.modules
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert any(".tmp-" in n for n in os.listdir(tmp_path))   # torn write
    assert latest_step(str(tmp_path)) == 1                   # skipped
    restored, _ = restore(str(tmp_path), 1, _zeros_like(_tree()))
    assert torch.equal(restored["params"]["w"], _tree(1)["params"]["w"])


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return {e["path"]: e for e in json.load(f)["leaves"]}


def test_incremental_save_hard_links_leaves(tmp_path):
    tree = _tree(7)
    save(str(tmp_path), 0, tree)
    save(str(tmp_path), 1, tree, link_from=str(tmp_path / "step_00000000"),
         link_paths={"['params']['w']", "['params']['b']"})
    m0, m1 = _manifest(tmp_path / "step_00000000"), _manifest(tmp_path / "step_00000001")
    for path in ("['params']['w']", "['params']['b']"):
        ino0 = os.stat(tmp_path / "step_00000000" / m0[path]["file"]).st_ino
        ino1 = os.stat(tmp_path / "step_00000001" / m1[path]["file"]).st_ino
        assert ino0 == ino1, f"{path} was re-serialized, not linked"
        assert m0[path]["sha"] == m1[path]["sha"]
    ino0 = os.stat(tmp_path / "step_00000000" / m0["['step']"]["file"]).st_ino
    ino1 = os.stat(tmp_path / "step_00000001" / m1["['step']"]["file"]).st_ino
    assert ino0 != ino1                          # the unlinked leaf was written
    assert latest_step(str(tmp_path)) == 1
    restored, _ = restore(str(tmp_path), 1, _zeros_like(tree))
    _assert_trees_equal(tree, restored)


def test_load_arrays_prefix_and_corrupt_detection(tmp_path):
    tree = {"s0": {"x": torch.arange(6), "y": torch.ones(3)}, "s1": {"x": torch.arange(4)}}
    save(str(tmp_path), 0, tree, extra={"n": 2})
    arrays, extra = load_arrays(str(tmp_path), 0, prefix="['s0']")
    assert set(arrays) == {"['s0']['x']", "['s0']['y']"}
    assert extra == {"n": 2}
    np.testing.assert_array_equal(arrays["['s0']['x']"], np.arange(6))
    corrupt_checkpoint_leaf(str(tmp_path), step=0, leaf=0)
    with pytest.raises(ValueError, match="corrupt checkpoint leaf"):
        load_arrays(str(tmp_path), 0)


def test_corrupt_leaf_injection_is_copy_on_write(tmp_path):
    tree = _tree(4)
    save(str(tmp_path), 0, tree)
    save(str(tmp_path), 1, tree, link_from=str(tmp_path / "step_00000000"),
         link_paths={"['params']['w']", "['params']['b']", "['step']"})
    corrupt_checkpoint_leaf(str(tmp_path))     # defaults to newest (1)
    assert latest_step(str(tmp_path)) == 0     # 1 invalid, 0 UNDAMAGED
    restored, _ = restore(str(tmp_path), 0, _zeros_like(tree))
    _assert_trees_equal(tree, restored)
    with pytest.raises(FileNotFoundError):
        corrupt_checkpoint_leaf(str(tmp_path / "empty"))


# -- the two packages -----------------------------------------------------

def _shaped(seed):
    """Trees of numpy leaves in shapes the flattener must name as jax does."""
    rng = np.random.default_rng(seed)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [
        {"b": a(3), "a": {"z": a(2, 2), "y": None, "x": [a(1), (a(2), a(3))]}},
        [a(2), None, {"k": a(1)}, (a(4),)],
        (a(5), {"shard_00001": {"val": a(2), "idx": a(2)}, "rank": a(3),
                "shard_00000": {"idx": a(1)}}),
        {"only": a(2, 3)},
        a(4),
        {"empty": {}, "none": None, "ints": np.arange(5, dtype=np.int32)},
    ]


@pytest.mark.parametrize("case", range(6))
def test_leaf_paths_equal_jax_keystr(case):
    tree = _shaped(case)[case]
    want = [(jax.tree_util.keystr(kp), leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = leaf_paths(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, x), (_, y) in zip(got, want):
        assert x is y


def _store_like_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"rank": rng.permutation(64).astype(np.int32)}
    for i in range(3):
        n = 5 + i
        tree[f"shard_{i:05d}"] = {
            "idx": rng.integers(0, 64, (n, 4)).astype(np.int32),
            "val": rng.standard_normal((n, 4)).astype(np.float32),
            "nnz": np.full(n, 4, np.int32),
            "alive": rng.random(n) > 0.3,
            "deadline": np.where(rng.random(n) > 0.5, np.inf, 7.5),
            "gids": np.arange(n, dtype=np.int32) + 10 * i,
        }
    return tree


def test_same_tree_same_manifest_in_both_packages(tmp_path):
    """Paths, order, files, shapes, dtypes and sha256 of every leaf, and
    the extra, are the reference's."""
    tree = _store_like_tree(0)
    jax_ckpt.save(str(tmp_path / "jax"), 0, tree, extra={"store": {"n_shards": 3}})
    save(str(tmp_path / "port"), 0, {k: (torch.from_numpy(v) if k == "rank" else v)
                                     for k, v in tree.items()},
         extra={"store": {"n_shards": 3}})
    with open(tmp_path / "jax" / "step_00000000" / "manifest.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "step_00000000" / "manifest.json") as f:
        got = json.load(f)
    assert got == want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    tree = _store_like_tree(1)
    if writer == "jax":
        jax_ckpt.save(str(tmp_path), 3, tree, extra={"w": 1})
        assert latest_step(str(tmp_path)) == 3
        arrays, extra = load_arrays(str(tmp_path), 3)
        restored, extra2 = restore(str(tmp_path), 3, tree)
        got = {p: np.asarray(x) for p, x in leaf_paths(restored)}
    else:
        save(str(tmp_path), 3, tree, extra={"w": 1})
        assert jax_ckpt.latest_step(str(tmp_path)) == 3
        arrays, extra = jax_ckpt.load_arrays(str(tmp_path), 3)
        restored, extra2 = jax_ckpt.restore(str(tmp_path), 3, tree,
                                            shard_fn=lambda _, a: a)
        got = {jax.tree_util.keystr(kp): np.asarray(x)
               for kp, x in jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert extra == extra2 == {"w": 1}
    want = dict(leaf_paths(tree))
    assert list(arrays) == list(want) == list(got)
    for path, arr in want.items():
        for side in (arrays[path], got[path]):
            assert side.dtype == arr.dtype, path
            np.testing.assert_array_equal(side, arr)
