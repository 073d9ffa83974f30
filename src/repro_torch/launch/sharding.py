"""Sharding rules (the JAX package's ``launch/sharding.py``): the store's
stacks on a device mesh, and the LM substrate's parameter, optimizer,
batch, cache and activation specs.

A spec is a tuple with one entry an axis, the counterpart of the
reference's ``PartitionSpec`` entry for entry: ``None`` (whole), an axis
name, or a tuple of names (the axis split over their product, the first
name slowest).  The spec functions read only ``mesh.shape`` and
``mesh.axis_names``.

**The store.**  A store stack leaf is a host array of shape
``(num_shards, blocks, ...)``.  Placed, it becomes a list of
``num_shards`` tensors: shard ``i``'s slice on the device at mesh
position ``i`` over the store's axes (other axes at index 0), each a copy
that shares no memory with the host array or with another placement.

**The LM.**  The reference decides a parameter's spec on its *stacked*
leaf (``(L, ...)``: every layer's leaf along leading axes) and its tree
path; the port holds one module a layer.  :func:`param_specs` therefore
maps each port parameter back to its JAX path and stacked shape
(``models/convert.py::_jax_path``), decides the spec there, and keeps the
parameter's index into the stack: ``launch/placement.py`` applies the
stacked leaf's blocks to each per-layer piece.  Decided on the per-layer
tensor's own name and shape, a spec would differ (the scan axis, the
``REPLICATE_BELOW`` count and the "largest remaining axis" all read the
stack).

Strategy (the reference's DESIGN.md §5): TP over ``model`` (heads, d_ff,
vocab, experts) + FSDP over ``data`` in ``"2d"``; every leaf FSDP over
``('data', 'model')`` in ``"fsdp"``; experts split inside in
``"2d_etp"``; replicated over ``pod``; leaves below ``REPLICATE_BELOW``
elements replicated.  What the port's one-process mesh does with these
specs is ``launch/steps.py``'s business: they place storage.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import canonical
from repro_torch.launch.mesh import DeviceMesh, dp_axes
from repro_torch.models.convert import JAX_LISTS, _jax_path, stacked_leaves

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


# ---------------------------------------------------------------------------
# LM parameter specs
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]
REPLICATE_BELOW = 1 << 16  # leaves smaller than this stay replicated


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0 and n >= k


def param_spec(path: str, shape: Tuple[int, ...], mesh, mode: str = "2d") -> Spec:
    """The spec of one stacked parameter leaf, named by its reference tree
    path (``jax.tree_util.keystr`` form: :func:`keystr`).

    mode="2d": TP over 'model' + FSDP over 'data' (default).
    mode="fsdp": no tensor parallelism — every leaf FSDP-sharded over the
    combined ('data','model') axes.
    mode="2d_etp": "2d" with each MoE expert split inside (ff over model).
    """
    dsz = mesh.shape.get("data", 1)
    msz = mesh.shape.get("model", 1)
    ndim = len(shape)
    spec: List[Any] = [None] * ndim
    if ndim == 0 or int(np.prod(shape)) < REPLICATE_BELOW:
        return tuple(spec)

    if mode == "fsdp":
        first = 1 if ("stack" in path and ndim >= 2) else 0
        both = dsz * msz
        order = sorted(range(first, ndim), key=lambda a: -shape[a])
        for a in order:
            if _div(shape[a], both):
                spec[a] = ("data", "model")
                return tuple(spec)
        # fall back: largest axis over whichever single axis divides
        for a in order:
            if _div(shape[a], dsz):
                spec[a] = "data"
                return tuple(spec)
        return tuple(spec)

    in_stack = "stack" in path
    first = 1 if (in_stack and ndim >= 2) else 0  # never shard the scan axis

    def place(axis: int, name: str, size: int) -> bool:
        if spec[axis] is None and _div(shape[axis], size):
            spec[axis] = name
            return True
        return False

    lower = path.lower()

    # --- name-targeted rules ----------------------------------------------
    if "pos_embed" in lower or ("embed" in lower and not in_stack):
        # (V, d): vocab -> model (TP vocab shard), d -> data (FSDP)
        place(0, "model", msz) or place(1, "model", msz)
        place(1, "data", dsz) or place(0, "data", dsz)
        return tuple(spec)
    if "lm_head" in lower:
        place(ndim - 1, "model", msz)     # vocab
        place(ndim - 2, "data", dsz)
        return tuple(spec)
    if ndim - first >= 3 and ("w_gate" in lower or "w_up" in lower or "w_down" in lower):
        if mode == "2d_etp":
            # expert tensor-parallelism: shard INSIDE each expert (ff over model)
            if "w_down" in lower:
                place(ndim - 2, "model", msz)   # row-parallel (ff input)
                place(ndim - 1, "data", dsz)
            else:
                place(ndim - 1, "model", msz)   # col-parallel (ff output)
                place(ndim - 2, "data", dsz)
            return tuple(spec)
        # MoE expert stacks (L, E, d, ff): experts -> model (EP)
        place(first, "model", msz)
        # largest remaining axis -> data
        rest = sorted(range(first + 1, ndim), key=lambda a: -shape[a])
        for a in rest:
            if place(a, "data", dsz):
                break
        return tuple(spec)
    if "w_o" in lower or "w_down" in lower or "w_out" in lower:
        # row-parallel: shard the INPUT-feature axis over model
        place(ndim - 2, "model", msz) or place(ndim - 1, "model", msz)
        place(ndim - 1, "data", dsz) or (ndim - 2 != first and place(ndim - 2, "data", dsz))
        return tuple(spec)

    # --- generic: col-parallel last axis, FSDP the next --------------------
    if ndim - first >= 2:
        place(ndim - 1, "model", msz)
        # largest remaining (non-scan) axis -> data
        rest = sorted(
            (a for a in range(first, ndim) if spec[a] is None), key=lambda a: -shape[a]
        )
        for a in rest:
            if place(a, "data", dsz):
                break
    elif ndim - first == 1:
        place(ndim - 1, "model", msz) or place(ndim - 1, "data", dsz)
    return tuple(spec)


def keystr(jax_path: str) -> str:
    """A JAX tree path 'stack/units/mix/0/w_x' in ``jax.tree_util.keystr``
    form: "['stack']['units']['mix'][0]['w_x']" (a number after one of
    the JAX tree's list keys is a list index)."""
    parts = jax_path.split("/")
    out = []
    for i, part in enumerate(parts):
        if part.isdigit() and i and parts[i - 1] in JAX_LISTS:
            out.append(f"[{part}]")
        else:
            out.append(f"[{part!r}]")
    return "".join(out)


def param_specs(model, mesh, mode: str = "2d") -> Dict[str, Tuple[Spec, Tuple[int, ...],
                                                                  Tuple[int, ...]]]:
    """{port name: (the stacked leaf's spec, its shape, the name's index
    into its stacked axes)} for every parameter of ``model`` (an ``LM`` or
    a mapping of names to tensors), each spec decided on the JAX path and
    the stacked shape (:func:`param_spec`)."""
    named = dict(model.named_parameters()) if hasattr(model, "named_parameters") else dict(model)
    stacked = stacked_leaves(named)
    specs = {path: param_spec(keystr(path), shape, mesh, mode)
             for path, shape in stacked.items()}
    out = {}
    for name in named:
        path, index = _jax_path(name)
        out[name] = (specs[path], stacked[path], index)
    return out


def param_shardings(model, mesh, mode: str = "2d") -> Dict[str, Spec]:
    """{JAX path: spec} of a model's stacked leaves (the reference's
    ``param_shardings``, keyed by path)."""
    named = dict(model.named_parameters()) if hasattr(model, "named_parameters") else dict(model)
    return {path: param_spec(keystr(path), shape, mesh, mode)
            for path, shape in stacked_leaves(named).items()}


def opt_shardings(param_shards, mesh) -> Dict[str, Any]:
    """m/v mirror the params; the step count replicated."""
    return {"m": param_shards, "v": param_shards, "step": ()}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _dp(mesh, mode: str = "2d") -> Tuple[Any, int]:
    """(the DP axes as a spec entry, their size).  An entry of one name is
    the name itself, as ``PartitionSpec`` keeps it."""
    dp = dp_axes(mesh)
    if mode == "fsdp":
        dp = dp + ("model",)
    return (dp[0] if len(dp) == 1 else dp), int(np.prod([mesh.shape[a] for a in dp]))


def batch_spec(shape: Tuple[int, ...], mesh, mode: str = "2d") -> Spec:
    """Input batch leaf: axis0 = global batch over DP axes (if divisible).
    mode="fsdp": the model axis joins DP, so batch shards over everything."""
    dp, dpsz = _dp(mesh, mode)
    spec: List[Any] = [None] * len(shape)
    if shape and _div(shape[0], dpsz):
        spec[0] = dp
    elif shape and "data" in mesh.axis_names and _div(shape[0], mesh.shape["data"]):
        spec[0] = "data"
    return tuple(spec)


def batch_shardings(batch: Dict[str, Any], mesh, mode: str = "2d") -> Dict[str, Spec]:
    return {k: batch_spec(tuple(np.shape(v)), mesh, mode) for k, v in batch.items()}


def cache_spec(path: str, shape: Tuple[int, ...], mesh, batch: int = 0) -> Spec:
    """KV-cache / recurrent-state leaf: stacked (L, ..., B, ...) — the batch
    axis (located by ``batch`` size hint, else assumed axis 1) over DP, one
    feature axis over model (largest trailing axis that divides)."""
    ndim = len(shape)
    if "slot_pos" in path:          # per-window bookkeeping, tiny: replicate
        return (None,) * ndim
    dp, dpsz = _dp(mesh)
    msz = mesh.shape.get("model", 1)
    spec: List[Any] = [None] * ndim
    # the batch axis: the first axis past the leading stack axis whose extent
    # is the global batch; rank-6 vlm caches put it at 2
    b_axis = None
    if batch:
        for a in range(1, ndim):
            if shape[a] == batch:
                b_axis = a
                break
    if b_axis is None and ndim >= 2:
        b_axis = 1
    if b_axis is not None and _div(shape[b_axis], dpsz):
        spec[b_axis] = dp
    cands = sorted(range((b_axis or 1) + 1, ndim), key=lambda a: -shape[a])
    for a in cands:
        if spec[a] is None and _div(shape[a], msz):
            spec[a] = "model"
            break
    return tuple(spec)


def cache_shardings(cache, mesh, batch: int = 0) -> Dict[str, Spec]:
    """{keystr path: spec} of every leaf of a serving cache."""
    from repro_torch.checkpoint.ckpt import leaf_paths

    return {path: cache_spec(path, tuple(leaf.shape), mesh, batch)
            for path, leaf in leaf_paths(cache)}


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

class ActivationConstraint:
    """The residual-stream constraint (``models/shardctx.py``).

    ``spec(shape)`` is the reference's: mode="2d": (B, S, d) — batch over
    the DP axes, seq over ``model`` when divisible (Megatron-SP);
    mode="fsdp": batch over every axis; None for a tensor the reference
    leaves alone (not 3-D).  Called on a tensor it checks that the tensor
    lies on ``device`` (the slice's, when given) and returns it as it is:
    the one-process mesh computes each batch slice whole on one device, so
    the placement the spec describes is a check, not a move."""

    def __init__(self, mesh, seq_shard: bool = True, mode: str = "2d",
                 device: Optional[torch.device] = None):
        self.mode, self.seq_shard = mode, seq_shard
        self.dp, self.dpsz = _dp(mesh, mode)
        self.msz = mesh.shape.get("model", 1)
        self.device = None if device is None else canonical(device)

    def spec(self, shape) -> Optional[Spec]:
        if len(shape) != 3:
            return None
        b, s, _ = shape
        bspec = self.dp if _div(b, self.dpsz) else None
        sspec = "model" if (self.mode == "2d" and self.seq_shard and _div(s, self.msz)) else None
        return (bspec, sspec, None)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        _on(x, self.device, "residual")
        return x


class NamedConstraint:
    """The MoE dispatch path's named constraints (``models/shardctx.py``).

    ``spec(shape, kind)`` is the reference's: in "2d" the expert axis over
    'model' —
      moe_dispatch (G, Tg, E, C) -> (dp, None, 'model', None)
      moe_expert   (G, E, C, d)  -> (dp, 'model', None, None)
      moe_out      (G, Tg, d)    -> (dp, None, None)
    — other modes the group axis only; None where the reference leaves the
    tensor alone.  Called, it checks the device, as ActivationConstraint."""

    def __init__(self, mesh, mode: str = "2d", device: Optional[torch.device] = None):
        self.mode = mode
        self.dp, self.dpsz = _dp(mesh, mode)
        self.msz = mesh.shape.get("model", 1)
        self.device = None if device is None else canonical(device)

    def spec(self, shape, kind: str) -> Optional[Spec]:
        ndim = len(shape)
        gspec = self.dp if _div(shape[0], self.dpsz) else None
        if self.mode != "2d":
            return (gspec,) + (None,) * (ndim - 1)
        if kind == "moe_dispatch" and ndim == 4 and _div(shape[2], self.msz):
            return (gspec, None, "model", None)
        if kind == "moe_expert" and ndim == 4 and _div(shape[1], self.msz):
            return (gspec, "model", None, None)
        if kind == "moe_out" and ndim == 3:
            return (gspec, None, None)
        return None

    def __call__(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        _on(x, self.device, kind)
        return x


def _on(x: torch.Tensor, device: Optional[torch.device], what: str) -> None:
    if device is not None and canonical(x.device) != device:
        raise RuntimeError(f"a {what} tensor on {x.device}, its batch slice on {device}")


def make_activation_constraint(mesh, seq_shard: bool = True, mode: str = "2d",
                               device=None) -> ActivationConstraint:
    return ActivationConstraint(mesh, seq_shard, mode, device)


def make_named_constraint(mesh, mode: str = "2d", device=None) -> NamedConstraint:
    return NamedConstraint(mesh, mode, device)
