"""Carry the JAX package's model parameters into the port.

``params_from_jax(tree, cfg)`` takes the tree of the JAX ``init_params``
(nested dicts, each leaf an array: numpy, or anything ``np.asarray``
reads) and returns the port's :class:`~repro_torch.models.model.LM` with
those weights.  The JAX stacks hold every layer's leaf along a leading
(L, ...) axis; here each layer is a module, so ``stack/attn/w_q`` (L, d,
H·hd) fills ``stack.<i>.attn.w_q`` for each i.  Each leaf is cast once to
the dtype the port keeps it in (``models/layers.py``), the cast the JAX
model makes at each use.  A missing or an extra leaf, or a leaf of another
shape, raises and names the leaf by its JAX path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import LM


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, prefix + (str(key),))
    else:
        yield "/".join(prefix), tree


def _jax_path(name: str) -> Tuple[str, int]:
    """'stack.3.attn.w_q' -> ('stack/attn/w_q', 3); 'embed' -> ('embed', -1)."""
    parts = name.split(".")
    if parts[0] == "stack":
        return "/".join(["stack"] + parts[2:]), int(parts[1])
    return "/".join(parts), -1


def params_from_jax(tree: Dict, cfg, device=None, kernels: bool = True) -> LM:
    """The port's model on ``device`` (CUDA unless named) holding ``tree``'s
    weights."""
    model = LM(cfg, device=resolve_device(device), kernels=kernels)
    params = dict(model.named_parameters())
    want: Dict[str, Tuple[int, ...]] = {}
    for name, p in params.items():
        path, layer = _jax_path(name)
        want[path] = ((cfg.num_layers,) if layer >= 0 else ()) + tuple(p.shape)
    got = {path: np.asarray(leaf) for path, leaf in _flatten(tree)}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing:
        raise KeyError(f"the JAX tree lacks {missing} for {cfg.name}")
    if extra:
        raise KeyError(f"the JAX tree has {extra}, which {cfg.name} has no place for")
    for path, shape in want.items():
        if got[path].shape != shape:
            raise ValueError(f"{path} has shape {got[path].shape}, {cfg.name} needs {shape}")
    with torch.no_grad():
        for name, p in params.items():
            path, layer = _jax_path(name)
            leaf = got[path][layer] if layer >= 0 else got[path]
            p.copy_(torch.from_numpy(np.array(leaf, dtype=np.float32)).to(p.dtype))
    return model
