"""Attention: the plain scaled-dot-product core and its causal / local mask.

Shapes, as the JAX package's ``models/attention.py``:

  q     (B, S, H, hd)
  k, v  (B, T, KVH, hd), H = G·KVH: query heads [j·G, (j+1)·G) share kv head j

Only ``_sdpa`` and ``_causal_mask`` are ported so far (ROADMAP queue 1
item 11); ``kernels/flash_attn/ops.py::flash_sdpa`` is the kernel drop-in
for ``_sdpa`` with this mask.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def _sdpa(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KVH,hd); mask broadcastable to (B,H,S,T)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q = q.reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    if mask is not None:
        # mask: (B|1, H|1, s, t) -> insert the GQA group axis
        scores = torch.where(mask[:, :, None], scores, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def _causal_mask(s: int, t: int, q_offset, window: int = 0, device=None) -> torch.Tensor:
    """(1, 1, s, t) bool; window > 0 = local attention."""
    qpos = q_offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m = m & (kpos > qpos - window)
    return m[None, None]
