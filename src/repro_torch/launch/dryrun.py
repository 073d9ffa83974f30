"""Dry run: trace every (arch × shape × mesh) cell on the meta device (the
counterpart of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 forced host devices and
records XLA's memory, cost and collectives a chip, for GSPMD's placement.
The port places differently (``launch/steps.py``): parameters and their
AdamW state live as blocks a mesh position (``launch/placement.py``), and
every batch slice runs forward and backward whole on a compute model
gathered on its position's device; serving runs each data row's slots on a
whole copy of the model.  This dry run records that placement as it is:

* the abstract state (``abstract_train_state``: f32 masters, or the serving
  model ``abstract_params``) on the meta device — no tensor holds data;
* placed with ``MeshParams`` on a mesh of meta entries
  (``make_production_mesh``), each entry standing for a distinct chip;
* one batch slice's step traced under ``launch/op_analysis.py``: every
  slice has one shape, so one traced slice stands for all.  A train cell
  on one position traces ``make_train_step`` whole; on a mesh, the mesh
  step's own pieces (``launch/steps.py``) for the largest position: its
  slice's forward and backward (``slice_forward``, ``slice_grads``), its
  share of the global norm (``grad_norm``) and AdamW on its blocks
  (``update_position``) — the work that position does in the mesh step
  (tracing the mesh step whole would run every slice on the one meta
  device).  Prefill and decode trace ``make_prefill_step`` /
  ``make_decode_step`` with the kernels on (their wrappers' meta branches
  count each launch);
* the copies a mesh step makes, predicted from the placement: ``stats``
  ``{"gathered", "reduced"}`` equals ``train_step.stats`` after a real
  step on the same devices.

A cell the port refuses by a named limit (``steps.py::check_moe_groups``,
a kernel's ``KernelRefusal``) is recorded as ``refused``; any other
exception is an error.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import all_arch_names, get_config
from repro_torch.device import canonical
from repro_torch.kernels._build import KernelRefusal
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.launch.op_analysis import Analysis, OpAnalysis
from repro_torch.launch.placement import MeshParams, box_key, positions_along, unique_boxes
from repro_torch.launch.sharding import batch_spec
from repro_torch.launch.steps import (
    TOTAL_STEPS,
    StepOptions,
    abstract_train_state,
    balance_means,
    batch_slices,
    check_moe_groups,
    grad_norm,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    mesh_size,
    slice_forward,
    slice_grads,
    update_position,
)
from repro_torch.models import model as M
from repro_torch.optim.adamw import clip_scale

META = SH.META


class Refused(Exception):
    """A cell the port refuses by a named limit (its message names it)."""


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _box_elems(box) -> int:
    return math.prod(s.stop - s.start for s in box)


def mesh_tag(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None) -> str:
    if mesh_shape is not None:
        return "x".join(str(n) for n in mesh_shape)
    return "pod2x16x16" if multi_pod else "16x16"


def meta_mesh(multi_pod: bool = False, mesh_shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """The production mesh of meta entries, or one of ``mesh_shape``
    (``(data, model)``, or ``(pod, data, model)``)."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    return DeviceMesh(np.full(tuple(mesh_shape), META, dtype=object), axes)


def identities(mesh, devices=None) -> List:
    """Each position's device identity for the predicted copies: the
    devices the positions stand for (``devices``, a flat list in mesh
    order), else the mesh's own, where each meta entry is a chip of its own.
    Two positions of one identity share a compute model and a gradient."""
    devs = list(mesh.devices.reshape(-1)) if devices is None else list(devices)
    return [(d.type, p) if d.type == "meta" else canonical(d)
            for p, d in enumerate(torch.device(x) for x in devs)]


def mesh_traffic(params: MeshParams, ids: List, slice_pos: List[int], microbatches: int = 1):
    """The copies a mesh train step makes, from the placement.

    Returns (stats, copies): ``stats`` the step's ``{"gathered",
    "reduced"}`` bytes over the whole mesh (``train_step.stats``: each
    device running a slice gathers every leaf from its distinct blocks once
    a step; each slice of each microbatch sends every leaf's gradient piece
    to each (box, device) owner group); ``copies`` each leaf's (kind,
    pieces, bytes, group size) into or out of one slice position a step,
    the group the blocks it is gathered from or the owners it is reduced
    onto."""
    gathered = reduced = 0
    copies = []
    for name, boxes in params.boxes.items():
        esize = next(b for b in params.blocks[name] if b is not None).element_size()
        uniq = unique_boxes(boxes)
        g_bytes = sum(_box_elems(b) for _, b in uniq) * esize
        owners = {(box_key(b), ids[p]): _box_elems(b) for p, b in enumerate(boxes) if b is not None}
        r_bytes = sum(owners.values()) * esize
        gathered += g_bytes
        reduced += r_bytes
        copies.append(("gathered", len(uniq), g_bytes, len(uniq)))
        copies.append(("reduced", len(owners) * microbatches, r_bytes * microbatches, len(owners)))
    n_models = len({ids[p] for p in slice_pos})
    stats = {"gathered": n_models * gathered,
             "reduced": microbatches * len(slice_pos) * reduced}
    return stats, copies


def _sliced(batch: Dict[str, torch.Tensor], rows: int) -> Dict[str, torch.Tensor]:
    return {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=META)
            for k, v in batch.items()}


def _trace_train(cfg, shape, mesh, opts, ids):
    model, opt = abstract_train_state(cfg)
    model_bytes = _nbytes(dict(model.named_parameters()))
    batch = SH.train_input_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    n = mesh_size(mesh)
    mb = max(opts.microbatch, 1)
    if n == 1:
        with OpAnalysis() as mode:
            out = make_train_step(cfg, None, opts)(model, opt, batch)
        args = [3 * model_bytes + 4 + _nbytes(batch)]
        return dict(analysis=mode.result, args=args, slice_pos=[0], pos=0, gathered_model=0,
                    stats={"gathered": 0, "reduced": 0}, copies=[],
                    state=3 * model_bytes + 4, step_scale=1, out=_nbytes(out[2]))
    slices = batch_slices(mesh, batch, opts.sharding_mode)
    try:
        check_moe_groups(cfg, b * s, len(slices))
    except ValueError as e:
        raise Refused(str(e)) from e
    params = MeshParams(model, mesh, opts.sharding_mode)
    blocks = params.block_bytes()
    slice_pos = [p for p, _, _ in slices]
    rows = (b // mb) // len(slices)
    sub = _sliced(batch, rows)
    args = [3 * blk + 4 + (_nbytes(sub) if p in slice_pos else 0) for p, blk in enumerate(blocks)]
    pos = max(slice_pos, key=lambda p: args[p])
    # the position's own m, v and step count (arguments, made before the trace)
    mine = [x for x in params.names() if params.blocks[x][pos] is not None]
    opt = {"m": {x: {pos: torch.zeros_like(params.blocks[x][pos])} for x in mine},
           "v": {x: {pos: torch.zeros_like(params.blocks[x][pos])} for x in mine},
           "step": {pos: torch.zeros((), dtype=torch.int32, device=META)}}
    count = torch.zeros((), dtype=torch.float32, device=META)   # C, counted before the step
    with OpAnalysis() as mode:
        total = None
        for _ in range(mb):    # the position's slice of each microbatch
            nll, bal = slice_forward(cfg, mesh, opts, model, sub, META)
            ft, _ = balance_means([bal], META)
            grads = slice_grads(cfg, opts, model, nll, bal, ft, count, len(slices))
            total = grads if total is None else {x: total[x] + g for x, g in grads.items()}
        # the gradient blocks the position owns, then the mesh step's update there
        mesh_grads = {x: {pos: total[x][params.boxes[x][pos]]} for x in mine}
        clip = clip_scale(grad_norm(params, mesh_grads, positions={pos}), opts.adamw)
        update_position(params, pos, mesh_grads, opt, clip, opts.adamw, TOTAL_STEPS)
    stats, copies = mesh_traffic(params, ids, slice_pos, mb)
    n_models = len({ids[p] for p in slice_pos})
    # the step's metrics: loss, ce, aux, tokens, grad_norm and lr, 0-d f32 each
    return dict(analysis=mode.result, args=args, slice_pos=slice_pos, pos=pos,
                gathered_model=model_bytes, stats=stats, copies=copies,
                state=sum(3 * blk + 4 for blk in blocks) + n_models * model_bytes,
                step_scale=len(slices), out=6 * _nbytes(nll))


def _trace_serve(cfg, shape, mesh, opts, ids):
    model = M.abstract_params(cfg)
    model_bytes = _nbytes(dict(model.named_parameters()))
    b = shape.global_batch
    entry = batch_spec((b,), mesh)[0]
    names = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
    slice_pos = positions_along(mesh, names)
    cell = dataclasses.replace(shape, global_batch=b // len(slice_pos))
    if shape.kind == "prefill":
        inputs = SH.prefill_input_specs(cfg, cell)
        cache = SH.abstract_cache(cfg, cell)
        with OpAnalysis() as mode:
            logits, _ = make_prefill_step(cfg, mesh, opts)(model, inputs, cache)
    else:
        inputs = SH.decode_input_specs(cfg, cell)
        cache = inputs.pop("cache")
        with OpAnalysis() as mode:
            logits, _ = make_decode_step(cfg, mesh, opts)(model, inputs["token"], cache,
                                                          inputs["pos"])
    per_slice = model_bytes + _nbytes(cache) + sum(_nbytes(v) for v in inputs.values())
    args = [per_slice if p in slice_pos else 0 for p in range(mesh_size(mesh))]
    return dict(analysis=mode.result, args=args, slice_pos=slice_pos, pos=slice_pos[0],
                gathered_model=0, stats={"gathered": 0, "reduced": 0}, copies=[],
                state=(len({ids[p] for p in slice_pos}) * model_bytes
                       + len(slice_pos) * _nbytes(cache)),
                step_scale=len(slice_pos), out=_nbytes(logits))


def trace_cell(arch: str, shape_name, multi_pod: bool = False, opts: StepOptions = StepOptions(),
               mesh_shape: Optional[Sequence[int]] = None, *, cfg=None, devices=None) -> Dict:
    """Trace one cell (module doc).  Returns the record dict.

    ``shape_name`` names one of ``SHAPES`` or is a ``ShapeCell``; ``cfg``
    replaces ``get_config(arch)``; ``mesh_shape`` replaces the production
    mesh; ``devices`` (a flat list in mesh order) names the devices the
    positions stand for, for the predicted copies (each a chip of its own
    by default)."""
    cfg = cfg or get_config(arch)
    shape = shape_name if isinstance(shape_name, SH.ShapeCell) else SH.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_tag(multi_pod, mesh_shape),
           "kind": shape.kind, "params": cfg.param_count()}
    skip = SH.cell_supported(cfg, shape)
    if skip:
        rec["skipped"] = skip
        return rec
    mesh = meta_mesh(multi_pod, mesh_shape)
    n = mesh_size(mesh)
    if opts.sharding_mode == "auto":
        # the per-arch mode is a train-cell default; serving uses 2d
        mode = cfg.sharding_mode if shape.kind == "train" else "2d"
        opts = dataclasses.replace(opts, sharding_mode=mode)
    rec["sharding_mode"] = opts.sharding_mode
    rec["n_chips"] = n
    t0 = time.perf_counter()
    ids = identities(mesh, devices)
    try:
        if shape.kind == "train":
            t = _trace_train(cfg, shape, mesh, opts, ids)
        else:
            t = _trace_serve(cfg, shape, mesh, opts, ids)
    except (Refused, KernelRefusal) as e:
        rec["refused"] = str(e)
        return rec
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    a: Analysis = t["analysis"]
    for copy in t["copies"]:
        a.collective(*copy)
    args, pos = t["args"], t["pos"]
    temp = a.peak_live_bytes
    at_slice = args[pos] + t["gathered_model"] + temp
    rest = max((x for p, x in enumerate(args) if p not in t["slice_pos"]), default=0)
    rec["memory_analysis"] = {
        "argument_size_in_bytes": int(args[pos]),
        "output_size_in_bytes": int(t["out"]),   # state and cache are updated in place
        "temp_size_in_bytes": int(temp),
    }
    rec["cost_analysis"] = {"flops": a.flops, "bytes accessed": a.hbm_bytes}
    rec["collectives"] = a.collectives
    rec["hlo_analysis"] = {
        "flops_per_chip": a.flops,
        "hbm_bytes_per_chip": a.hbm_bytes,
        "collective_bytes_per_chip": a.total_collective_bytes(),
        "collectives": a.collectives,
        "collective_by_group": {str(k): v for k, v in a.collective_by_group.items()},
    }
    rec["gathered_model_bytes"] = int(t["gathered_model"])
    rec["stats"] = t["stats"]
    rec["state_bytes"] = int(t["state"])
    rec["largest_position_bytes"] = int(max(at_slice, rest))
    rec["slices"] = len(t["slice_pos"])
    rec["step_flops"] = a.flops * t["step_scale"]
    rec["aten_flops"] = a.aten_flops
    rec["kernel_launches"] = dict(a.kernel_launches)
    rec["kernel_flops"] = dict(a.kernel_flops)
    return rec


def _line(rec: Dict) -> str:
    gib = 2.0 ** 30
    ma = rec["memory_analysis"]
    st = rec["stats"]
    return (f"  ok: trace {rec['trace_s']}s flops={rec['cost_analysis']['flops']:.3e}"
            f" args={ma['argument_size_in_bytes'] / gib:.2f}GiB"
            f" temp={ma['temp_size_in_bytes'] / gib:.2f}GiB"
            f" gathered_model={rec['gathered_model_bytes'] / gib:.2f}GiB"
            f" largest={rec['largest_position_bytes'] / gib:.2f}GiB\n"
            f"  a step: gathered {st['gathered'] / gib:.2f} GiB, reduced {st['reduced'] / gib:.2f}"
            f" GiB over {rec['n_chips']} positions; kernels {rec['kernel_launches']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SH.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun/torch")
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--sharding-mode", default="auto", choices=["auto", "2d", "fsdp"])
    # the reference's flag, kept so its command lines run: the port's
    # activation constraints only check devices, so it changes no record
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    opts = StepOptions(ce_chunk=args.ce_chunk, seq_shard_activations=not args.no_seq_shard,
                       sharding_mode=args.sharding_mode)
    archs = all_arch_names() if (args.all or not args.arch) else [args.arch]
    shape_names = list(SH.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shape_names:
            for mp in meshes:
                tag = mesh_tag(mp)
                name = f"{arch}_{shape_name}_{tag}{args.tag}"
                print(f"=== {name} ===", flush=True)
                try:
                    rec = trace_cell(arch, shape_name, mp, opts)
                except Exception:  # noqa: BLE001
                    failures += 1
                    rec = {"arch": arch, "shape": shape_name, "mesh": tag,
                           "error": traceback.format_exc()}
                    print(rec["error"], flush=True)
                with open(os.path.join(args.out, name + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                if "skipped" in rec:
                    print(f"  SKIP: {rec['skipped']}", flush=True)
                elif "refused" in rec:
                    print(f"  REFUSED: {rec['refused']}", flush=True)
                elif "error" not in rec:
                    print(_line(rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
