"""A model's parameters and its AdamW state placed on a device mesh as the
blocks that ``launch/sharding.py::param_spec`` gives each mesh position
(the port's counterpart of ``jax.device_put(params, param_shardings)``).

A parameter's spec is decided on its stacked JAX leaf; a mesh position
holds a *box* of that stacked leaf (per axis, the slice its coordinates
along the spec's axis names pick, the first name slowest).  The port keeps
one tensor a layer, so each per-layer piece ``stacked[index]`` is held at
a position as the part of the box inside it: the box's extent over the
piece's own axes if ``index`` lies inside the box's stacked axes, nothing
otherwise.  Replicated leaves (and axes) give every position the same box,
each as a copy of its own on the position's device.

:class:`MeshParams` holds the blocks and the compute models: one ``LM`` a
device that runs a batch slice, into which :meth:`MeshParams.gather`
copies every parameter from its blocks (a device that already holds the
gathered copy takes no second one).  The optimizer state mirrors the
blocks: ``{"m": {name: [block]}, "v": {name: [block]}, "step": [int32 a
position]}``.  :func:`gather_train_state` reads both back as whole leaves
(the mesh-free checkpoint); :func:`restore_train_state` scatters whole
leaves into the blocks, so a state saved on one mesh shape restores on any
other.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import canonical
from repro_torch.launch.sharding import Spec, param_specs

Box = Tuple[slice, ...]


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def positions(mesh) -> List[Dict[str, int]]:
    """Every mesh position's coordinates {axis: index}, in the order of
    ``mesh.devices.reshape(-1)`` (row-major, the first axis slowest)."""
    shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    out = []
    for flat in range(math.prod(shape)):
        coord, rest = {}, flat
        for a, n in reversed(list(zip(mesh.axis_names, shape))):
            coord[a] = rest % n
            rest //= n
        out.append(coord)
    return out


def positions_along(mesh, names: Tuple[str, ...]) -> List[int]:
    """The flat positions over ``names``, every other axis at index 0, in
    the order of the index an axis split over ``names`` gives them (the
    first name slowest): where that axis's slices live."""
    def index(c):
        i = 0
        for a in names:
            i = i * mesh.shape[a] + c[a]
        return i

    held = [(index(c), i) for i, c in enumerate(positions(mesh))
            if all(c[a] == 0 for a in mesh.axis_names if a not in names)]
    return [i for _, i in sorted(held)]


def stacked_box(spec: Spec, shape: Tuple[int, ...], mesh, coord: Dict[str, int]) -> Box:
    """The box of a stacked leaf of ``shape`` sharded by ``spec`` that the
    position at ``coord`` holds."""
    box = []
    for entry, n in zip(spec, shape):
        names = _names(entry)
        parts, idx = 1, 0
        for a in names:
            idx = idx * mesh.shape[a] + coord[a]
            parts *= mesh.shape[a]
        size = n // parts
        box.append(slice(idx * size, (idx + 1) * size))
    return tuple(box)


def piece_box(box: Box, index: Tuple[int, ...]) -> Optional[Box]:
    """The part of a stacked leaf's ``box`` inside the per-layer piece
    ``stacked[index]``, over the piece's own axes; None if none of it is."""
    for sl, i in zip(box, index):
        if not sl.start <= i < sl.stop:
            return None
    return box[len(index):]


def layout(model, mesh, mode: str = "2d") -> Dict[str, List[Optional[Box]]]:
    """{port name: each position's box of the parameter, or None}."""
    coords = positions(mesh)
    out = {}
    for name, (spec, shape, index) in param_specs(model, mesh, mode).items():
        out[name] = [piece_box(stacked_box(spec, shape, mesh, c), index) for c in coords]
    return out


def box_key(box: Box) -> Tuple[Tuple[int, int], ...]:
    return tuple((s.start, s.stop) for s in box)


def scatter(full: torch.Tensor, boxes: List[Optional[Box]], devices) -> List[Optional[torch.Tensor]]:
    """``full``'s block at each position, a copy on the position's device."""
    return [None if box is None else full[box].to(dev, copy=True).contiguous()
            for box, dev in zip(boxes, devices)]


def unique_boxes(boxes: List[Optional[Box]]) -> List[Tuple[int, Box]]:
    """(the first position holding it, box) for each distinct box, in mesh
    order: every element of the leaf exactly once."""
    seen, out = set(), []
    for p, box in enumerate(boxes):
        if box is not None and box_key(box) not in seen:
            seen.add(box_key(box))
            out.append((p, box))
    return out


def replicate(model: nn.Module, device) -> nn.Module:
    """A copy of ``model`` whose parameters and buffers live on ``device``
    (each copied there once, never through the source device); ``model``
    itself if it is there already."""
    device = canonical(device)
    first = next(model.parameters())
    if canonical(first.device) == device:
        return model
    memo = {id(p): nn.Parameter(p.detach().to(device, copy=True), requires_grad=p.requires_grad)
            for p in model.parameters()}
    memo.update({id(b): b.to(device, copy=True) for b in model.buffers()})
    return copy.deepcopy(model, memo)


class MeshParams:
    """A model's parameters as blocks on ``mesh`` (see the module doc).

    ``blocks[name][p]``: position ``p``'s block (None where it holds none
    of the parameter); ``boxes`` the same positions' boxes of the per-layer
    piece; ``shapes[name]`` the whole parameter's shape.  ``model`` (an
    ``LM`` built to train, the source of the blocks) becomes the compute
    model of its own device."""

    def __init__(self, model: nn.Module, mesh, mode: str = "2d"):
        self.mesh, self.mode = mesh, mode
        self.devices = [canonical(d) for d in mesh.devices.reshape(-1)]
        self.boxes = layout(model, mesh, mode)
        named = dict(model.named_parameters())
        self.shapes = {n: tuple(p.shape) for n, p in named.items()}
        # positions that hold the same box on the same device share one
        # reduced gradient: {name: [(box, device, [positions])]}
        self.owners = {}
        for n, boxes in self.boxes.items():
            groups: Dict[tuple, Tuple[Box, torch.device, List[int]]] = {}
            for p, box in enumerate(boxes):
                if box is not None:
                    key = (box_key(box), self.devices[p])
                    groups.setdefault(key, (box, self.devices[p], []))[2].append(p)
            self.owners[n] = list(groups.values())
        with torch.no_grad():
            self.blocks = {n: scatter(p.detach(), self.boxes[n], self.devices)
                           for n, p in named.items()}
        self._models = {canonical(named[next(iter(named))].device): model}
        self._gathered = set()          # devices whose compute model holds the blocks

    def names(self):
        return self.blocks.keys()

    def compute_model(self, device) -> nn.Module:
        """The compute model on ``device`` (made from the first one the
        first time, then refreshed by :meth:`gather`)."""
        device = canonical(device)
        if device not in self._models:
            self._models[device] = replicate(next(iter(self._models.values())), device)
        return self._models[device]

    def gather(self, device) -> Tuple[nn.Module, int]:
        """(the compute model on ``device`` holding every parameter gathered
        from its blocks, the bytes copied); nothing is copied if it holds
        them since the last update of the blocks."""
        model = self.compute_model(device)
        device = canonical(device)
        if device in self._gathered:
            return model, 0
        moved = 0
        with torch.no_grad():
            for name, p in model.named_parameters():
                for pos, box in unique_boxes(self.boxes[name]):
                    p[box].copy_(self.blocks[name][pos])
                    moved += p[box].numel() * p.element_size()
        self._gathered.add(device)
        return model, moved

    def updated(self):
        """Mark every compute model stale (after the blocks changed)."""
        self._gathered.clear()

    def full(self, name: str, device=None) -> torch.Tensor:
        """Parameter ``name`` whole, assembled from its blocks on ``device``
        (position 0's by default)."""
        return assemble(self.blocks[name], self.boxes[name], self.shapes[name],
                        device or self.devices[0])

    def state_dict(self, device=None) -> Dict[str, torch.Tensor]:
        return {n: self.full(n, device) for n in self.blocks}

    def block_bytes(self) -> List[int]:
        """The bytes of parameter blocks each position holds."""
        out = [0] * len(self.devices)
        for blocks in self.blocks.values():
            for p, b in enumerate(blocks):
                if b is not None:
                    out[p] += b.numel() * b.element_size()
        return out


def assemble(blocks, boxes, shape, device) -> torch.Tensor:
    """A leaf whole from its blocks (each distinct box once)."""
    first = next(b for b in blocks if b is not None)
    out = torch.empty(shape, dtype=first.dtype, device=device)
    for pos, box in unique_boxes(boxes):
        out[box] = blocks[pos].to(device)
    return out


def place_train_state(model: nn.Module, opt: Dict, mesh, mode: str = "2d"):
    """(MeshParams, the AdamW state as blocks) of a model built to train and
    its state (``launch/steps.py::init_train_state``)."""
    params = MeshParams(model, mesh, mode)
    with torch.no_grad():
        mopt = {k: {n: scatter(opt[k][n], params.boxes[n], params.devices) for n in params.names()}
                for k in ("m", "v")}
        mopt["step"] = [opt["step"].to(d, copy=True) for d in params.devices]
    return params, mopt


def gather_train_state(params: MeshParams, opt: Dict, device=None):
    """({name: f32}, {"m", "v", "step"}): the whole state on ``device``
    (position 0's by default), as a one-device run holds it."""
    device = device or params.devices[0]
    full = {k: {n: assemble(opt[k][n], params.boxes[n], params.shapes[n], device)
                for n in params.names()} for k in ("m", "v")}
    full["step"] = opt["step"][0].to(device)
    return params.state_dict(device), full


def restore_train_state(params: MeshParams, opt: Dict, whole_params, whole_opt) -> None:
    """Scatter a whole state (``gather_train_state``'s form: tensors on any
    device) into the blocks of ``params`` and ``opt``, in place."""
    with torch.no_grad():
        for n in params.names():
            for blocks, full in ((params.blocks[n], whole_params[n]),
                                 (opt["m"][n], whole_opt["m"][n]),
                                 (opt["v"][n], whole_opt["v"][n])):
                for b, box in zip(blocks, params.boxes[n]):
                    if b is not None:
                        b.copy_(full[box])
        for s in opt["step"]:
            s.copy_(whole_opt["step"])
    params.updated()
