"""Placement of the sharded store's stacks on a device mesh (the store
part of ``repro.launch.sharding``; its parameter, batch, cache and
activation rules belong to the LM substrate, which is not ported yet).

A store stack leaf is a host array of shape ``(num_shards, blocks, ...)``.
Placed, it becomes a list of ``num_shards`` tensors: shard ``i``'s slice
on the device at mesh position ``i`` over the store's axes (other axes
at index 0), each a copy that shares no memory with the host array or
with another placement.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh

Leaf = np.ndarray
Placed = List[torch.Tensor]


def _axes(axes) -> tuple:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def store_stack_specs(tree: Union[Leaf, Dict[str, Leaf]], axes) -> Any:
    """The layout of every leaf: its LEADING axis over the store's shard
    axes, the rest whole — ``(axes, None, ...)`` per leaf, the counterpart
    of the reference's ``PartitionSpec(axes, None, ...)``."""
    def spec(leaf):
        return (_axes(axes),) + (None,) * (np.ndim(leaf) - 1)

    return {k: spec(v) for k, v in tree.items()} if isinstance(tree, dict) else spec(tree)


def _own_copy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device`` that shares no memory with ``a``
    (on the CPU ``torch.from_numpy`` alone would alias the host array)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def store_put(tree: Union[Leaf, Dict[str, Leaf]], mesh: DeviceMesh, axes):
    """Place a store stack (one array, or a dict of them) on the mesh:
    each leaf becomes the list of its shard slices, slice ``i`` on the
    device of position ``i`` over ``axes``."""
    specs = store_stack_specs(tree, axes)

    def put(leaf: Leaf, spec) -> Placed:
        devs = mesh.devices_along(spec[0])
        if leaf.shape[0] != len(devs):
            raise ValueError(f"a leaf of {leaf.shape[0]} shards on {len(devs)} mesh positions")
        return [_own_copy(leaf[i], d) for i, d in enumerate(devs)]

    if isinstance(tree, dict):
        return {k: put(v, specs[k]) for k, v in tree.items()}
    return put(tree, specs)


def store_shard_update(arr: Placed, i: int, new_slice: Leaf) -> Placed:
    """Replace shard ``i``'s slice of an already-placed stack leaf IN
    PLACE of a full re-placement: only shard ``i``'s device receives new
    bytes (a copy into its tensor); every other shard's tensor is
    untouched.  This is what makes mutation placement O(changed shard),
    not O(store).  Returns the leaf.

    ``new_slice`` must already be padded to the stack's cross-shard
    maxima: shape ``(1,) + shard shape``.  Callers that grew the global
    geometry (more blocks, wider list bound) must fall back to a full
    :func:`store_put`."""
    new_slice = np.asarray(new_slice)
    if new_slice.shape != (1,) + tuple(arr[i].shape):
        raise ValueError(
            f"slice shape {new_slice.shape} does not match stack row "
            f"{(1,) + tuple(arr[i].shape)}: geometry changed, use store_put")
    arr[i].copy_(torch.from_numpy(np.ascontiguousarray(new_slice[0])))
    return arr


def placed_shape(arr: Placed) -> tuple:
    """The ``(num_shards, ...)`` shape of a placed stack leaf."""
    return (len(arr),) + tuple(arr[0].shape)


def placed_numpy(arr: Placed) -> np.ndarray:
    """A placed stack leaf read back to the host as one array."""
    return np.stack([t.cpu().numpy() for t in arr])
