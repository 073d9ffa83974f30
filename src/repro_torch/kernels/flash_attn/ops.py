"""Public op: flash attention in the model layout.

``flash_sdpa`` mirrors ``models/attention._sdpa``: q (B,S,H,hd), k/v
(B,T,KVH,hd) -> (B,S,H,hd), with ``sm_scale = 1/√hd``.  Heads are
flattened into the kernel's batch; query head h reads kv head h // g, so
kv is not repeated.  Nothing is padded: the kernel masks the ragged edges
itself, so keys past T never count, with or without ``causal`` (the JAX
package's op pads k with zero keys that only the causal mask hides).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda


def heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B·H, S, hd), contiguous: the kernel's layout."""
    b, s, h, hd = x.shape
    return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()


def flash_sdpa(
    q: torch.Tensor,   # (B, Sq, H, hd)
    k: torch.Tensor,   # (B, Skv, KVH, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    device=None,
) -> torch.Tensor:
    """(B, Sq, H, hd) attention output on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    b, sq, h, hd = q.shape
    q, k, v = (heads_first(x.to(dev)) for x in (q, k, v))
    out = flash_attention_cuda(q, k, v, causal=causal, sm_scale=1.0 / (hd ** 0.5),
                               window=window)
    return out.reshape(b, h, sq, hd).transpose(1, 2)
