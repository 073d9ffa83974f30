"""RWKV6 "Finch" time mixing: the chunked WKV core.

Recurrence per head (state S ∈ R^{K×V}, per-channel decay w_t ∈ (0,1)^K):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

evaluated in the chunked linear-attention form of the JAX package's
``models/rwkv6.py``: within a chunk of C tokens the pairwise decays are a
masked (C, C) product of (r ⊙ e^{L}) and (k ⊙ e^{-L}) with the inverse
factor clamped at ±CLAMP; between chunks the (K, K) state carries.  Only
``_chunked_wkv`` is ported so far (ROADMAP queue 1 item 11);
``kernels/wkv/ops.py::wkv`` is its kernel drop-in.
"""
from __future__ import annotations

import torch

CLAMP = 30.0  # max |log| of the intra-chunk inverse decay factor


def _chunked_wkv(r, k, v, logw, u, chunk: int):
    """Chunked RWKV6 core.  r,k,v: (B,T,H,K); logw: (B,T,H,K) (≤0); u: (H,K).
    Returns (B,T,H,K) outputs. T % chunk == 0 (caller pads)."""
    b, t, h, kk = r.shape
    n = t // chunk
    rc = r.reshape(b, n, chunk, h, kk)
    kc = k.reshape(b, n, chunk, h, kk)
    vc = v.reshape(b, n, chunk, h, kk)
    lw = logw.reshape(b, n, chunk, h, kk).float()

    # cumulative log decay within chunk, exclusive of the current token
    lcum = torch.cumsum(lw, dim=2) - lw           # (B,N,C,H,K), ≤ 0, first row 0
    ltot = lw.sum(dim=2)                          # (B,N,H,K)

    ri = rc * torch.exp(lcum).to(rc.dtype)                              # r_i e^{lcum_i}
    kj = kc * torch.exp(torch.clamp(-(lcum + lw), -CLAMP, CLAMP)).to(kc.dtype)
    scores = torch.einsum("bnihk,bnjhk->bnhij", ri.float(), kj.float())
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    scores = torch.where(mask, scores, 0.0)       # strictly past
    # bonus diagonal: the current token contributes through u
    diag = torch.einsum("bnihk,bnihk->bnih", rc.float(), (kc * u.to(kc.dtype)).float())
    intra = torch.einsum("bnhij,bnjhk->bnihk", scores, vc.float())
    intra = intra + diag[..., None] * vc.float()

    # inter-chunk: carry the state S (B,H,K,K) across chunks
    k_carry = kc * torch.exp(
        torch.clamp(ltot[:, :, None] - (lcum + lw), max=CLAMP)).to(kc.dtype)
    s = torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device)
    inter = []
    for i in range(n):
        inter.append(torch.einsum("bihk,bhkv->bihv", ri[:, i].float(), s))
        s = s * torch.exp(ltot[:, i])[..., None] + torch.einsum(
            "bihk,bihv->bhkv", k_carry[:, i].float(), vc[:, i].float())
    inter = torch.stack(inter, dim=1)             # (B,N,C,H,K)

    out = (intra + inter).reshape(b, t, h, kk)
    return out.to(r.dtype)
