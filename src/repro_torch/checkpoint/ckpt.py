"""Checkpointing with atomic commit, integrity manifest, and elastic
(layout-independent) restore: the PyTorch port's copy of
``repro.checkpoint.ckpt``.

Layout of one checkpoint::

    <dir>/step_000123/
        manifest.json      # {step, leaves: [{path, shape, dtype, file, sha}], ...}
        leaf_00000.npy ... # one .npy per tree leaf (a host value)

Properties:

* **Atomic two-phase commit** — writes go to ``step_X.tmp-<pid>``; fsync;
  then a single atomic ``rename`` publishes it.  A crash mid-write leaves
  only a tmp dir that restore ignores and the next save garbage-collects.
* **Integrity** — every leaf file carries a sha256 in the manifest;
  restore verifies and treats a mismatch as "checkpoint absent"
  (falls back to the previous step — node-failure recovery path).
* **Elastic restore** — leaves are saved as whole host arrays; restore
  places them wherever the caller's ``place_fn`` says (a device, a
  re-split), so a save and its restore need not share a layout.
* **Async save** — `CheckpointManager.save_async` snapshots to host
  memory synchronously (cheap) and writes/fsyncs in a background thread,
  so the caller is blocked only for the device->host copy.

The port's differences: trees are nested dicts, lists and tuples,
flattened by :func:`leaf_paths`, which names and orders leaves as
``jax.tree_util.tree_flatten_with_path`` + ``keystr`` do (dict keys
sorted, ``None`` dropped, ``['key']`` and ``[i]``), so with the same
``np.save`` bytes either package reads the other's checkpoints.  Leaves
are numpy arrays, Python scalars or ``torch.Tensor`` (copied to the host
with ``.cpu().numpy()``); :func:`restore` returns tensors, placed by
``place_fn(path, np_array)`` — the reference's ``shard_fn`` hook — or,
by default, ``torch.from_numpy`` on the CPU, so the caller decides the
device.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)$")
_OLD_RE = re.compile(r"step_(\d+)\.old-\d+$")


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf)]`` of a tree of dicts, lists and tuples, in
    the reference's order: dict keys sorted, sequences in index order,
    ``None`` (an empty subtree) dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaf_paths(tree[key], f"{prefix}[{key!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += leaf_paths(sub, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _map_leaves(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)`` (same
    structure; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return fn(prefix, tree)


def _host(leaf) -> np.ndarray:
    """A leaf as a host array (the reference's ``device_get``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(
    directory: str,
    step: int,
    tree,
    extra: Optional[dict] = None,
    link_from: Optional[str] = None,
    link_paths: Optional[set] = None,
) -> str:
    """Synchronous atomic save. Returns the committed path.

    ``link_from`` enables incremental saves: leaves whose tree path is in
    ``link_paths`` are hard-linked from that previously committed checkpoint
    dir instead of re-serialized (manifest entries are reused, so the sha
    stays correct without re-hashing).  Falls back to a full write for any
    leaf that can't be linked (missing in the old manifest, link failure).
    """
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    link_manifest: Dict[str, dict] = {}
    if link_from is not None and link_paths:
        try:
            with open(os.path.join(link_from, "manifest.json")) as f:
                link_manifest = {e["path"]: e for e in json.load(f)["leaves"]}
        except (OSError, json.JSONDecodeError, KeyError):
            link_manifest = {}

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(leaf_paths(tree)):
        fname = f"leaf_{i:05d}.npy"
        dst = os.path.join(tmp, fname)
        entry = None
        if link_paths and path in link_paths and path in link_manifest:
            src_entry = link_manifest[path]
            src = os.path.join(link_from, src_entry["file"])
            try:
                os.link(src, dst)
                entry = dict(src_entry, file=fname)
            except OSError:
                entry = None  # cross-device or missing: fall through to write
        if entry is None:
            arr = _host(leaf)
            np.save(dst, arr)
            entry = {
                "path": path,
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha": _sha(dst),
            }
        manifest["leaves"].append(entry)
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # directory fsync then atomic publish
    dfd = os.open(tmp, os.O_RDONLY)
    os.fsync(dfd)
    os.close(dfd)
    # Never rmtree the live checkpoint before the new one is published: a
    # crash between rmtree and rename would leave NO valid checkpoint.  Move
    # the old dir aside, publish, then delete the old one; a crash anywhere
    # in this window leaves at least one valid copy (restore adopts orphaned
    # ``.old-`` dirs whose step went missing).
    old = None
    if os.path.exists(final):
        old = final + f".old-{os.getpid()}"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return final


def _valid(ckpt_dir: str) -> bool:
    mpath = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for entry in manifest["leaves"]:
            fp = os.path.join(ckpt_dir, entry["file"])
            if not os.path.exists(fp) or _sha(fp) != entry["sha"]:
                return False
        return True
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def _committed_steps(directory: str) -> List[int]:
    """Step numbers of committed (non-tmp, non-old) dirs, ignoring any
    ``step_*`` name that isn't exactly ``step_<digits>`` (stray files,
    hand-made dirs, editor droppings)."""
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.fullmatch(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _adopt_orphans(directory: str) -> None:
    """Recover ``step_N.old-<pid>`` dirs orphaned by a crash mid-publish.

    ``save`` renames the previous committed ``step_N`` aside before
    publishing the replacement; if the process dies in that window the only
    valid copy of step N is the ``.old-`` dir.  Rename it back so restore
    sees it — unless a committed ``step_N`` already exists (normal case:
    the aside dir is just pre-delete garbage)."""
    for name in os.listdir(directory):
        m = _OLD_RE.fullmatch(name)
        if not m:
            continue
        final = os.path.join(directory, f"step_{int(m.group(1)):08d}")
        src = os.path.join(directory, name)
        if not os.path.exists(final) and _valid(src):
            os.rename(src, final)


def latest_step(directory: str) -> Optional[int]:
    """Newest step with a VALID (manifest-verified) checkpoint, else None."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    _adopt_orphans(directory)
    for s in reversed(_committed_steps(directory)):
        if _valid(os.path.join(directory, f"step_{s:08d}")):
            return s
    return None


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def restore(
    directory: str,
    step: int,
    like,
    place_fn: Optional[Callable[[str, np.ndarray], Any]] = None,
):
    """Restore into the structure of ``like``.  Returns ``(tree, extra)``.

    ``place_fn(path, np_value) -> Tensor`` places each leaf (e.g.
    ``torch.from_numpy(v).to(device)``, or a slice of it) — the elastic
    hook.  Defaults to ``torch.from_numpy`` on the CPU.
    """
    ckpt_dir = os.path.join(os.fspath(directory), f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    placed = {}
    for path, leaf in leaf_paths(like):       # the reference's order
        arr = np.load(os.path.join(ckpt_dir, by_path[path]["file"]))
        if list(arr.shape) != list(_shape(leaf)):
            raise ValueError(f"shape mismatch at {path}: {arr.shape} vs {_shape(leaf)}")
        placed[path] = place_fn(path, arr) if place_fn is not None else torch.from_numpy(arr)
    return _map_leaves(like, lambda path, _: placed[path]), manifest.get("extra", {})


def load_arrays(
    directory: str,
    step: int,
    prefix: Optional[str] = None,
    verify: bool = True,
) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load leaves by tree path without a ``like`` tree.

    Returns ``({keystr_path: np.ndarray}, extra)``.  ``prefix`` filters to
    leaves whose path starts with it — the shard-slice recovery read: a
    lost shard's arrays are fetched without touching the other shards'
    (possibly large) leaf files.  ``verify`` sha-checks each loaded leaf
    and raises ``ValueError`` on mismatch (corrupt-leaf detection).
    """
    ckpt_dir = os.path.join(os.fspath(directory), f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for entry in manifest["leaves"]:
        if prefix is not None and not entry["path"].startswith(prefix):
            continue
        fp = os.path.join(ckpt_dir, entry["file"])
        if verify and _sha(fp) != entry["sha"]:
            raise ValueError(f"corrupt checkpoint leaf {entry['path']} ({fp})")
        out[entry["path"]] = np.load(fp)
    return out, manifest.get("extra", {})


class CheckpointManager:
    """Keep-last-N manager with async commit and tmp-dir garbage collection."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.fspath(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.directory, exist_ok=True)
        self._gc_tmp()

    def _gc_tmp(self):
        _adopt_orphans(self.directory)  # rescue before sweeping
        for name in os.listdir(self.directory):
            if ".tmp-" in name or _OLD_RE.fullmatch(name):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def _gc_old(self):
        steps = _committed_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        """Snapshot to host now; write+commit in the background.  The
        snapshot is a copy: a tensor the caller updates in place after
        this returns does not reach the commit."""
        self.wait()
        host_tree = _map_leaves(tree, lambda _, x: np.array(_host(x), copy=True))

        def work():
            save(self.directory, step, host_tree, extra)
            self._gc_old()

        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def save_sync(self, step: int, tree, extra: Optional[dict] = None) -> str:
        self.wait()
        path = save(self.directory, step, tree, extra)
        self._gc_old()
        return path
