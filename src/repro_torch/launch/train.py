"""End-to-end trainer: data pipeline -> train step -> checkpoints, under
the fault-tolerance supervisor (the JAX package's ``launch/train.py``).

Runs on the card unless ``--device`` names another.  ``--data-par`` and
``--model-par`` build a ``(data, model)`` mesh of that many positions, all
on the one device (``[dev] * n``, the counterpart of the reference's
forced host devices); above one position the state lives as blocks on the
mesh (``launch/placement.py``) and the mesh train step runs
(``launch/steps.py``).  The checkpoint is mesh-free: ``{"params": {name:
f32}, "opt": {"m", "v", "step"}}``, gathered on save and placed by name on
restore, so ``--resume auto`` restarts from the newest one on any mesh
shape; the token stream restarts at its step.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \
      --steps 20 --ckpt-dir /tmp/ckpt --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu \
      --data-par 2 --model-par 2
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step, restore
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import canonical, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.placement import (
    MeshParams,
    gather_train_state,
    place_train_state,
    restore_train_state,
)
from repro_torch.launch.steps import StepOptions, init_train_state, make_train_step, mesh_size
from repro_torch.runtime.fault import RetryPolicy, Supervisor, guard_finite


def build(cfg, mesh, opts: StepOptions, total_steps: int):
    """(params, opt, step, device): the train state on ``mesh`` (placed as
    blocks if it has more than one position) and its train step; ``device``
    is position 0's, where the batches and the metrics live."""
    dev = canonical(resolve_device(mesh.devices.reshape(-1)[0]))
    params, opt = init_train_state(cfg, device=dev)
    if mesh_size(mesh) > 1:
        params, opt = place_train_state(params, opt, mesh, opts.sharding_mode)
    step = make_train_step(cfg, mesh, opts, total_steps=total_steps)
    return params, opt, step, dev


def add_stub_inputs(batch, cfg, rng):
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (batch["tokens"].shape[0], cfg.encoder_seq, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (batch["tokens"].shape[0], cfg.num_patches, cfg.d_model), np.float32)
    return batch


def checkpoint_tree(params, opt):
    """What a checkpoint holds: the parameters by name and the AdamW state,
    whole (gathered from the blocks on a mesh)."""
    if isinstance(params, MeshParams):
        whole, whole_opt = gather_train_state(params, opt)
        return {"params": whole, "opt": whole_opt}
    return {"params": dict(params.named_parameters()), "opt": opt}


def load_checkpoint(directory, step, params, opt, device):
    """Restore checkpoint ``step`` into ``params`` (in place) and return the
    restored optimizer state, on ``device`` (on a mesh: into the blocks)."""
    if isinstance(params, MeshParams):
        shapes = {n: torch.empty(s, device="meta") for n, s in params.shapes.items()}
        like = {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                          "step": torch.empty((), dtype=torch.int32,
                                                              device="meta")}}
        restored, _ = restore(directory, step, like,
                              place_fn=lambda path, v: torch.from_numpy(v))
        restore_train_state(params, opt, restored["params"], restored["opt"])
        return opt
    restored, _ = restore(directory, step, checkpoint_tree(params, opt),
                          place_fn=lambda path, v: torch.from_numpy(v).to(device))
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(restored["params"][name])
    return restored["opt"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ce-chunk", type=int, default=64)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject one failure at this step (fault-tolerance test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    # every position of the mesh on the one device
    mesh = make_host_mesh(args.data_par, args.model_par,
                          devices=[dev] * (args.data_par * args.model_par))
    opts = StepOptions(ce_chunk=min(args.ce_chunk, args.seq_len))

    params, opt, train_step, dev = build(cfg, mesh, opts, args.steps)
    state = {"params": params, "opt": opt}

    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume == "auto":
        s = latest_step(args.ckpt_dir)
        if s is not None:
            state["opt"] = load_checkpoint(args.ckpt_dir, s, params, state["opt"], dev)
            start = s
            print(f"resumed from step {s}", flush=True)

    pipe = TokenPipeline(
        args.seed, args.global_batch, args.seq_len, cfg.vocab_size, start_step=start
    )
    rng = np.random.default_rng(123)
    injected = {"done": start > 0}
    history = []

    def step_fn(i):
        if args.fail_at_step == i and not injected["done"]:
            injected["done"] = True
            raise RuntimeError("injected node failure")
        batch = add_stub_inputs(next(pipe), cfg, rng)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        state["params"], state["opt"], metrics = train_step(state["params"], state["opt"], batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            guard_finite("loss", metrics["loss"])
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save_async(i + 1, checkpoint_tree(state["params"], state["opt"]),
                           extra={"step": i + 1})
        return metrics

    def restore_fn(reason):
        print(f"RESTORE after: {reason}", flush=True)
        if not mgr:
            return 0
        mgr.wait()
        s = latest_step(args.ckpt_dir) or 0
        if s:
            state["opt"] = load_checkpoint(args.ckpt_dir, s, state["params"], state["opt"], dev)
        pipe.step = s
        # drain the prefetch queue so batches realign with the restored step
        pipe.close()
        new_pipe = TokenPipeline(
            args.seed, args.global_batch, args.seq_len, cfg.vocab_size, start_step=s
        )
        nonlocal_pipe(new_pipe)
        return s

    def nonlocal_pipe(p):
        nonlocal pipe
        pipe = p

    def on_metrics(i, metrics):
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            history.append((i, loss))
            print(f"step {i:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f}",
                  flush=True)

    sup = Supervisor(step_fn, restore_fn, RetryPolicy(max_retries=3, backoff_s=0.1),
                     on_metrics=on_metrics)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    sup.run(start, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    if mgr:
        mgr.save_sync(args.steps, checkpoint_tree(state["params"], state["opt"]),
                      extra={"step": args.steps})
    tok_s = args.global_batch * args.seq_len * (args.steps - start) / max(dt, 1e-9)
    print(json.dumps({
        "arch": cfg.name, "steps": args.steps, "wall_s": round(dt, 2),
        "tokens_per_s": round(tok_s, 1), "failures": sup.failures,
        "final_loss": history[-1][1] if history else None,
    }), flush=True)
    pipe.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
