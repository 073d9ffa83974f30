"""Device meshes for the multi-device join and the sharded store (the
PyTorch counterpart of ``repro.launch.mesh``).

The reference is single-controller: one process drives every local
device through ``shard_map`` over a ``jax.sharding.Mesh``.  Here one
process holds tensors on several ``torch.device``s, and a mesh is a
:class:`DeviceMesh`: an ndarray of devices, its axis names, and the
shape by name.  Nothing here starts a process group.

A mesh is only what the caller builds.  The builders take ``devices=``:
``None`` (or ``"cuda"``) means every visible CUDA device, and asking for
more than there are raises, naming both counts; ``"cpu"`` gives as many
CPU entries as asked, and ``"meta"`` as many meta entries (a mesh that
nothing runs on, only planned against: the dry run's, ``launch/dryrun.py``);
an explicit list is used as given, and may repeat one device
(``[torch.device("cuda:0")] * 4``: four shards on one card, the
counterpart of the reference's forced host devices).

Mesh semantics (DESIGN.md §5):
  pod   — slow inter-pod links; pure data parallelism.
  data  — data-parallel axis (the ring join's R/S row shards).
  model — the join's dimension axis (``dim_axis``).
  shard — the store's row-range shards; ``replica`` its copies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceMesh:
    """A grid of ``torch.device``s with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [torch.device(d) for d in grid.reshape(-1)]
        self.devices = flat.reshape(grid.shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device grid")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def devices_along(self, axes: Sequence[str]) -> List[torch.device]:
        """The devices of every position over ``axes``, flattened in the
        order the axes are named (the first axis slowest), with every other
        axis at index 0 — the device each shard of a leading axis sharded
        over ``axes`` lives on."""
        axes = tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh {self.axis_names}")
        src = [self.axis_names.index(a) for a in axes]
        grid = np.moveaxis(self.devices, src, list(range(len(axes))))
        return list(grid[(Ellipsis,) + (0,) * (grid.ndim - len(axes))].reshape(-1))

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _pool(devices) -> Optional[List[torch.device]]:
    """The devices a builder may take: a list, or None for "as many CPU
    (or meta) entries as asked"."""
    if devices is None or devices == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if devices in ("cpu", "meta"):
        return None
    if isinstance(devices, (str, torch.device)):
        raise ValueError(f"devices must be None, 'cuda', 'cpu', 'meta' or a list, "
                         f"got {devices!r}")
    return [torch.device(d) for d in devices]


def _take(devices, need: int) -> List[torch.device]:
    pool = _pool(devices)
    if pool is None:
        return [torch.device(devices)] * need
    if need > len(pool):
        kind = "CUDA devices" if devices is None or devices == "cuda" else "devices"
        raise ValueError(f"need {need} {kind}, have {len(pool)}")
    return pool[:need]


def make_production_mesh(multi_pod: bool = False, devices="meta") -> DeviceMesh:
    """The production mesh: ``(16, 16)`` over ``('data', 'model')``, or
    ``(2, 16, 16)`` with ``'pod'`` first.  Meta entries by default: nothing
    runs on it here, it is planned against (``launch/dryrun.py``); a list
    of devices lays it on them, under the same count check."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _take(devices, int(np.prod(shape)))
    return DeviceMesh(np.array(devs, dtype=object).reshape(shape), axes)


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> DeviceMesh:
    """A ``('data', 'model')`` mesh over ``data * model`` devices."""
    devs = _take(devices, data * model)
    return DeviceMesh(np.array(devs, dtype=object).reshape(data, model), ("data", "model"))


def make_store_mesh(num_shards: Optional[int] = None, replicas: int = 1,
                    devices=None) -> DeviceMesh:
    """Mesh for the sharded KNN datastore (``ShardedKNNStore(mesh=)``).

    ``replicas=1``: the 1-D ``('shard',)`` mesh, one store shard per
    device, every device of the pool unless ``num_shards`` picks a subset
    (with ``devices="cpu"`` the default is one shard).  ``replicas>1``: a
    2-D ``('replica', 'shard')`` mesh, each replica row a full copy of
    every shard (``replicas × num_shards`` devices); ``num_shards`` then
    defaults to ``devices // replicas``."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    pool = _pool(devices)
    n = None if pool is None else len(pool)
    if num_shards is None:
        shards = 1 if n is None else n // replicas
        if shards < 1:
            raise ValueError(f"{n} devices cannot host {replicas} replicas")
    else:
        shards = int(num_shards)
        if shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    devs = np.array(_take(devices, replicas * shards), dtype=object)
    if replicas == 1:
        return DeviceMesh(devs, ("shard",))
    return DeviceMesh(devs.reshape(replicas, shards), ("replica", "shard"))


def replica_submeshes(mesh: DeviceMesh, replica_axis: str = "replica") -> List[DeviceMesh]:
    """Split a replicated store mesh into one sub-mesh per replica, each
    spanning that replica's devices over the remaining (shard) axes.  The
    store places one tensor set per sub-mesh and routes whole dispatches
    to one replica, so a dead replica is routed around."""
    names = list(mesh.axis_names)
    ax = names.index(replica_axis)
    shard_names = tuple(n for n in names if n != replica_axis)
    devs = np.moveaxis(mesh.devices, ax, 0)
    return [DeviceMesh(devs[r], shard_names) for r in range(devs.shape[0])]


def dp_axes(mesh: DeviceMesh) -> tuple:
    """Data-parallel axes: ('pod','data') on multi-pod, ('data',) otherwise."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
