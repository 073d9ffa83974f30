"""AdamW with global-norm clipping (the JAX package's ``optim/adamw.py``).

Parameters are a mapping of names to tensors, or a module (its
``named_parameters``); the state mirrors them: ``{"m": {name: f32},
"v": {name: f32}, "step": int32}``.  The bias corrections, the clip and
the learning rate are f32 tensors, as in the reference, so a step never
waits on the host.  ``adamw_update`` writes the parameters and the state
in place and returns them (the reference returns new trees).

**Which leaves decay.**  The reference decays a leaf iff ``p.ndim >= 2``.
Its layer stacks hold each layer's leaf along leading axes, so a layer's
norm scale is an ``(L, d)`` leaf there, and is decayed; only the leaves
outside the stacks (``final_norm``, a hybrid tail's blocks) keep their
1-D shape and are spared.  The port holds one module a layer, so a
parameter's rank is that of the JAX leaf less its stacked axes:
``decays`` counts them back from the name (``models/convert.py``), which
reproduces the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from repro_torch.models.convert import _jax_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def named(params) -> Dict[str, torch.Tensor]:
    """``params`` (a module, or a mapping of names to tensors) as a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies: the reference's ``ndim >= 2`` on the
    JAX leaf, whose rank adds the stacked axes the port's name indexes."""
    return len(_jax_path(name)[1]) + p.dim() >= 2


def adamw_init(params) -> Dict:
    leaves = named(params)
    device = next(iter(leaves.values())).device if leaves else None
    return {
        "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def adamw_scalars(step: torch.Tensor, cfg: AdamWConfig, lr_scale=1.0):
    """(the next step, the bias corrections 1 - b1^t and 1 - b2^t, the
    learning rate), f32 tensors on ``step``'s device."""
    f32 = torch.float32
    step = step + 1
    t = step.to(f32)
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=t.device), t)
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=t.device), t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=f32, device=t.device)
    return step, b1t, b2t, lr


def adamw_leaf_update(p, g, m, v, clip, b1t, b2t, lr, cfg: AdamWConfig, decay: bool) -> None:
    """One leaf's (or one block of it) AdamW update, in place."""
    g = g.float() * clip
    m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
    upd = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
    if decay:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)


def clip_scale(gnorm: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)


def adamw_update(
    params,
    grads: Mapping[str, torch.Tensor],
    state: Dict,
    cfg: AdamWConfig,
    lr_scale=1.0,
) -> Tuple[object, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, state, metrics)."""
    leaves = named(params)
    gnorm = global_norm([grads[n] for n in leaves])
    clip = clip_scale(gnorm, cfg)
    step, b1t, b2t, lr = adamw_scalars(state["step"], cfg, lr_scale)
    with torch.no_grad():
        for n, p in leaves.items():
            adamw_leaf_update(p, grads[n], state["m"][n], state["v"][n], clip, b1t, b2t, lr, cfg,
                              decays(n, p))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
