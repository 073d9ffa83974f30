"""Int8 gradient compression with error feedback (the JAX package's
``optim/compress.py``): symmetric per-tensor int8 quantization, the int8
all-reduce over the positions of a mesh axis, and its payload size.

The pattern: per leaf, a symmetric int8 quantization with one scale shared
over the axis (the largest of the shards' scales, the reference's
``pmax``), an integer sum of the int8 payloads (4x fewer bytes than f32),
the mean dequantized, and the quantization error carried into the next
step (error feedback keeps the bias bounded).  The port drives every
position from one process, so :func:`psum_int8` takes one gradient dict
and one error buffer a position and returns one result a position.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x = x.float()
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def psum_int8(grads: Sequence[Mapping[str, torch.Tensor]],
              error: Optional[Sequence[Mapping[str, torch.Tensor]]] = None
              ) -> Tuple[List[Dict[str, torch.Tensor]], List[Dict[str, torch.Tensor]]]:
    """All-reduce gradients over the positions of a mesh axis in int8 with
    error feedback: ``grads[i]`` and ``error[i]`` are position i's (dicts of
    tensors on its device; ``error`` None: zeros).  Returns (the mean
    gradients, f32, one dict a position; the new error buffers, one a
    position).  Per leaf, as the reference: ``g32 = g + e``; ``scale`` the
    largest over the positions of ``max(|g32|) (at least 1e-12) / 127``;
    ``q = clip(round(g32 / scale), -127, 127)`` in int8 (round half to
    even, as ``jnp.round``); ``e' = g32 - q·scale`` (rounded once, as the
reference's fused multiply-add); the int32 sum of the
    q over the positions times ``scale / n``.  The sum is of integers, so
    its order does not matter: given the same per-position inputs the
    result is the reference's bit for bit."""
    n = len(grads)
    error = error if error is not None else [None] * n
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    new_err: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for name in grads[0]:
        g32 = [g[name].float() + (e[name] if e is not None else 0.0)
               for g, e in zip(grads, error)]
        home = g32[0].device
        # divisors as device tensors: CUDA divides by a host scalar through
        # its reciprocal, which is not the reference's division
        scales = [torch.clamp(torch.max(torch.abs(x)), min=1e-12) / _full(127.0, x) for x in g32]
        scale = torch.stack([s.to(home) for s in scales]).max()          # the pmax
        q = []
        for i, x in enumerate(g32):
            sc = scale.to(x.device)
            q.append(torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8))
            # g32 - q·scale rounded once, as XLA's fused multiply-add: the
            # product of an int8 and an f32 and its difference from g32 are
            # exact in f64
            new_err[i][name] = (x.double() - q[-1].double() * sc.double()).float()
        tot = q[0].to(torch.int32)
        for qi in q[1:]:
            tot = tot + qi.to(home).to(torch.int32)                    # the int8 payload
        mean = (tot.float() * scale) / _full(float(n), tot)
        for i, x in enumerate(g32):
            out[i][name] = mean.to(x.device, copy=True)
    return out, new_err


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def compressed_bytes(grads) -> int:
    """Payload bytes of one int8 all-reduce of ``grads`` (a mapping or a
    sequence of tensors): one byte an element."""
    leaves = grads.values() if isinstance(grads, Mapping) else grads
    return sum(x.numel() for x in leaves)
