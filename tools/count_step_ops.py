#!/usr/bin/env python3
"""Count the ATen operations one train step dispatches on one device and
over meshes of that device (launch/steps.py), each one a kernel launch on
the card: the host work a step asks for, which a mesh of positions on one
card multiplies.

    python3 tools/count_step_ops.py [--device cpu|cuda] [--layers 28]

qwen3-0.6b's reduced config with its full 28 layers (d 64, vocab 256),
batch 8 x 32, f32; the second step of each mesh is counted (the first
builds what it caches).  Prints one line a mesh shape.
"""
import argparse
import dataclasses
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.placement import place_train_state  # noqa: E402
from repro_torch.launch.steps import StepOptions, init_train_state, make_train_step  # noqa: E402
from repro_torch.testing import train_batches  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=28)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), num_layers=args.layers)
    dev = torch.device(args.device)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in train_batches(cfg, 1, 8, 32)[0].items()}
    for shape in ((1, 1), (2, 1), (2, 2), (4, 2)):
        params, opt = init_train_state(cfg, device=dev)
        mesh = make_host_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        if shape != (1, 1):
            params, opt = place_train_state(params, opt, mesh)
        step = make_train_step(cfg, mesh, StepOptions(ce_chunk=16))
        params, opt, _ = step(params, opt, batch)
        with Count() as count:
            step(params, opt, batch)
        print(f"mesh {shape}: {count.n} aten ops a step ({cfg.num_layers} layers, "
              f"{sum(p.numel() for p in init_train_state(cfg, device=dev)[0].parameters())} "
              f"parameters, {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
