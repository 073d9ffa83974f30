"""Activation-sharding context (a copy of the JAX package's
``models/shardctx.py``).

Model code stays mesh-agnostic; a launcher may install a constraint
function for the duration of a call.  ``constrain`` is called by the
layer stacks on the residual carry, ``constrain_named`` on the MoE
dispatch path; with no context installed both are the identity.  Over a
mesh the launchers install ``launch/sharding.py``'s constraints, which
carry the reference's spec for each tensor and check that it lies on its
batch slice's device, leaving its values alone.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_CONSTRAIN: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
_NAMED: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None


def constrain(x: torch.Tensor) -> torch.Tensor:
    return x if _CONSTRAIN is None else _CONSTRAIN(x)


def constrain_named(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Named constraint point (e.g. MoE dispatch/expert tensors)."""
    return x if _NAMED is None else _NAMED(x, kind)


@contextlib.contextmanager
def activation_sharding(
    fn: Callable[[torch.Tensor], torch.Tensor],
    named: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None,
):
    global _CONSTRAIN, _NAMED
    prev, prev_named = _CONSTRAIN, _NAMED
    _CONSTRAIN, _NAMED = fn, named
    try:
        yield
    finally:
        _CONSTRAIN, _NAMED = prev, prev_named
