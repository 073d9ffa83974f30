"""Data-parallel trainer with an int8 + error-feedback gradient sync (the
JAX package's ``launch/compressed_train.py``).

The reference is a ``shard_map`` step whose only cross-device traffic is
the once-per-step gradient all-reduce, compressed to int8 with an
error-feedback buffer (``optim/compress.py``).  Here one process drives
the positions of the mesh axis: each holds a batch slice, runs the
reference's *local* ``loss_fn`` on it (its own mean, as inside
``shard_map``) on its device, and the per-position gradients meet in
``psum_int8`` (or, with ``compress=False``, an exact sum in position
order divided by the count).  The loss is the mean over the positions.

Parameters and the AdamW state are replicated: position 0's model (the
one given) takes the update, and every other device's copy is refreshed
from it (the same bits each replica would compute from the same mean
gradient); a device that already holds the model takes no second copy.
The error buffer is **one a position**: the reference declares it
replicated (``out_specs=P()`` with the replication check off), yet each
device keeps its own from step to step, and reading it on the host gives
shard 0's.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.device import canonical
from repro_torch.launch.placement import positions_along, replicate
from repro_torch.launch.steps import StepOptions, loss_fn
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.compress import psum_int8
from repro_torch.optim.schedule import warmup_cosine


def axis_devices(mesh, axis: str = "data") -> List[torch.device]:
    """The devices of the positions along ``axis`` (the others at 0)."""
    flat = mesh.devices.reshape(-1)
    return [canonical(flat[p]) for p in positions_along(mesh, (axis,))]


def init_error(params, mesh, axis: str = "data") -> List[Dict[str, torch.Tensor]]:
    """Zero error-feedback buffers, one dict a position along ``axis``."""
    return [{n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for n, p in params.named_parameters()} for dev in axis_devices(mesh, axis)]


def make_compressed_train_step(cfg, mesh, axis: str = "data",
                               opts: StepOptions = StepOptions(),
                               total_steps: int = 10_000,
                               compress: bool = True):
    """(params, opt_state, err, batch) -> (params, opt_state, err, metrics).

    ``params`` is a model built to train on the first position's device,
    ``opt_state`` its AdamW state; ``err`` the error buffers, one a
    position along ``axis`` (``init_error``); the batch splits over
    ``axis`` along its first axis."""
    devices = axis_devices(mesh, axis)
    replicas: Dict[torch.device, torch.nn.Module] = {}

    def replica(params, dev):
        if dev == canonical(params.device):
            return params
        if dev not in replicas:
            replicas[dev] = replicate(params, dev)
        return replicas[dev]

    def step(params, opt_state, err, batch):
        n = len(devices)
        if canonical(params.device) != devices[0]:
            raise ValueError(f"params are on {params.device}, the first position on {devices[0]}")
        if len(err) != n:
            raise ValueError(f"{len(err)} error buffers for {n} positions along {axis!r}")
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows does not split over {n} positions")
        per = b // n
        grads, losses = [], []
        for i, dev in enumerate(devices):
            model = replica(params, dev)
            sub = {k: torch.as_tensor(v)[i * per:(i + 1) * per].to(dev) for k, v in batch.items()}
            leaves = dict(model.named_parameters())
            with torch.enable_grad():
                loss, _ = loss_fn(model, cfg, sub, opts)
                g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads.append({name: torch.zeros_like(p) if gi is None else gi
                          for (name, p), gi in zip(leaves.items(), g)})
            losses.append(loss.detach())
        if compress:
            red, err = psum_int8(grads, err)
            mean = red[0]
        else:
            mean = {}
            for name in grads[0]:
                tot = grads[0][name]
                for g in grads[1:]:
                    tot = tot + g[name].to(devices[0])
                mean[name] = tot / n
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x.to(devices[0])
        loss = loss / n
        lr_scale = warmup_cosine(opt_state["step"], total=total_steps)
        params, opt_state, om = adamw_update(params, mean, opt_state, opts.adamw, lr_scale)
        with torch.no_grad():
            for model in replicas.values():
                for q, p in zip(model.parameters(), params.parameters()):
                    q.copy_(p)
        return params, opt_state, err, {"loss": loss, **om}

    return step
