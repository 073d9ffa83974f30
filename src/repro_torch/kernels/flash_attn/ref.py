"""Plain PyTorch version of the flash attention kernel: the whole (Sq, Skv)
score matrix at once, in f32.

Semantics of the JAX package's ``attention_ref``: the masked score is
NEG, a row with no visible key gives 0, the output is in q.dtype.  k and v
may hold BH / g heads (GQA): query head i reads kv head i // g.
"""
from __future__ import annotations

import torch

NEG = -1e30   # a masked score; models/attention.py imports it from here


def flash_attention_plain(
    q: torch.Tensor,        # (BH, Sq, hd)
    k: torch.Tensor,        # (BH / g, Skv, hd)
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float = 1.0,
    window: int = 0,
) -> torch.Tensor:
    """(BH, Sq, hd) in q.dtype."""
    g = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kf) * sm_scale
    q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask[None], s, NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", w, vf)
    return torch.where(mask.any(dim=1)[None, :, None], out, 0.0).to(q.dtype)
