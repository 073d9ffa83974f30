"""Step builders, the serving half (the JAX package's ``launch/steps.py``):
``make_prefill_step`` and ``make_decode_step``, what the server runs.

The train step, its chunked cross-entropy and ``StepOptions``' optimizer
settings come with the training slice (ROADMAP item 11).  A mesh enters
the reference through its parameter and activation shardings
(``launch/sharding.py``), which are not ported yet: here a mesh must hold
one device, and a larger one raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Knobs the perf loop turns (the reference's, less ``adamw``)."""

    ce_chunk: int = 512            # sequence chunk of the chunked CE
    seq_shard_activations: bool = True   # Megatron-SP residual sharding
    sharding_mode: str = "2d"      # "2d" (TP+FSDP) | "fsdp" (pure DP/FSDP)
    grad_shard_constraint: bool = False  # pin grads to param sharding (RS > AR)
    microbatch: int = 0            # >0: grad-accumulation microbatches
    aux_weight: float = 0.01


def mesh_device(mesh) -> torch.device:
    """The one device of ``mesh``; raises for a larger mesh."""
    devices = mesh.devices.reshape(-1)
    if devices.size != 1:
        raise NotImplementedError(
            f"a {mesh.shape} mesh: the port serves on one device until launch/sharding.py's "
            "parameter and activation specs are ported (ROADMAP item 11)")
    return devices[0]


def make_prefill_step(cfg, mesh=None, opts: StepOptions = StepOptions()):
    """(params, batch, cache) -> (last logits, filled cache)."""
    if mesh is not None:
        mesh_device(mesh)

    def prefill_step(params, batch, cache):
        return M.prefill(params, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg, mesh=None, opts: StepOptions = StepOptions()):
    """(params, token, cache, pos) -> (logits, new cache). One new token."""
    if mesh is not None:
        mesh_device(mesh)

    def decode_step(params, token, cache, pos):
        return M.decode_step(params, cfg, token, cache, pos)

    return decode_step
