"""Int8 gradient compression (the JAX package's ``optim/compress.py``):
symmetric per-tensor int8 quantization and the payload size of one int8
all-reduce.

``psum_int8``, the all-reduce itself over a named mesh axis with an
error-feedback buffer, needs the compressed trainer's mesh and comes with
it (ROADMAP item 11f-c).
"""
from __future__ import annotations

from typing import Mapping, Tuple

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


def compressed_bytes(grads) -> int:
    """Payload bytes of one int8 all-reduce of ``grads`` (a mapping or a
    sequence of tensors): one byte an element."""
    leaves = grads.values() if isinstance(grads, Mapping) else grads
    return sum(x.numel() for x in leaves)
