"""Carry the JAX package's model parameters into the port.

``params_from_jax(tree, cfg)`` takes the tree of the JAX ``init_params``
(nested dicts and lists, each leaf an array: numpy, or anything
``np.asarray`` reads) and returns the port's
:class:`~repro_torch.models.model.LM` with those weights.

The JAX stacks hold every layer's (or unit's) leaf along leading axes and
the port holds one module a layer, so a number in a port name is one of
two things.  Where the JAX tree has a list (the hybrid unit's ``mix``,
``mlp``, ``ln_mix``, ``ln_mlp`` and the hybrid ``tail``), it is that list's
index and stays in the path; everywhere else it indexes a stacked axis.
So ``stack.3.attn.w_q`` is row 3 of ``stack/attn/w_q`` (L, d, H·hd), vlm's
``stack.1.self.2.attn.w_q`` is ``stack/self/attn/w_q[1, 2]``, hybrid's
``stack.units.4.mix.0.w_x`` is ``stack/units/mix/0/w_x[4]``, its
``stack.tail.1.mix.w_x`` is ``stack/tail/1/mix/w_x``, audio's
``stack.decoder.5.self.w_q`` is ``stack/decoder/self/w_q[5]``.  Each leaf
is cast once to the dtype the port keeps it in (``models/layers.py``), the
cast the JAX model makes at each use.  A missing or an extra leaf, or a
leaf of another shape, raises and names the leaf by its JAX path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import LM

# the keys whose values are lists in the JAX tree (models/transformer.py's hybrid stack)
JAX_LISTS = ("mix", "mlp", "ln_mix", "ln_mlp", "tail")


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _jax_path(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A port parameter name -> (its JAX path, its index along the stacked
    axes): 'stack.3.attn.w_q' -> ('stack/attn/w_q', (3,)); 'embed' ->
    ('embed', ())."""
    path, index = [], []
    for part in name.split("."):
        if part.isdigit() and not (path and path[-1] in JAX_LISTS):
            index.append(int(part))
        else:
            path.append(part)
    return "/".join(path), tuple(index)


def stacked_leaves(named) -> Dict[str, Tuple[int, ...]]:
    """{JAX path: the stacked leaf's shape} of a mapping of port names to
    tensors: each stacked axis one past the largest index the names give
    it."""
    want: Dict[str, Tuple[int, ...]] = {}
    for name, p in named.items():
        path, index = _jax_path(name)
        lead = want.get(path, (0,) * len(index))[:len(index)]
        want[path] = tuple(max(n, i + 1) for n, i in zip(lead, index)) + tuple(p.shape)
    return want


def params_from_jax(tree: Dict, cfg, device=None, kernels: bool = True,
                    master: bool = False) -> LM:
    """The port's model on ``device`` (CUDA unless named) holding ``tree``'s
    weights; ``master`` keeps them in f32, to train (``LM``)."""
    model = LM(cfg, device=resolve_device(device), kernels=kernels, master=master)
    params = dict(model.named_parameters())
    want = stacked_leaves(params)
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
            path, index = _jax_path(name)
            leaf = got[path][index]
            p.copy_(torch.from_numpy(np.array(leaf, dtype=np.float32)).to(p.dtype))
    return model
