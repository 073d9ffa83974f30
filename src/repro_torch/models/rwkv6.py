"""RWKV6 "Finch" — attention-free time mixing with data-dependent decay (the
JAX package's ``models/rwkv6.py``).

Recurrence per head (state S ∈ R^{K×V}, per-channel decay w_t ∈ (0,1)^K):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

Prefill uses the **chunked linear-attention form**: within a chunk of C
tokens the pairwise decay products exp(L_t − L_τ) (τ ≤ t, so the exponent
is ≤ 0) are applied as a masked (C, C) product of (r ⊙ e^{L−L₀}) and
(k ⊙ e^{L₀−L}) with the inverse factor clamped at ±CLAMP; between chunks
the (K, K) state carries.  Decode is the exact one-step recurrence.

The chunked form runs where the layer's ``kernels`` flag sends it.  With
``kernels=True`` (the default) it is the WKV op,
``kernels/wkv/ops.py::wkv``: the hand-written kernel on a CUDA tensor, its
plain version on a CPU tensor; a refusal raises, nothing falls back.  The
op is given r, k, v in f32 with the log decays in the f32 the reference
computes them in (the kernel takes all four in one dtype, and works in f32
either way), and its output is rounded to the compute dtype where the
reference rounds it.  With ``kernels=False`` it is the JAX package's own
``_chunked_wkv``, which in bf16 also rounds r·e^{L} and k·e^{−L} to bf16,
so there the two agree within a tolerance.  The op takes T that is not a
multiple of the chunk, reading the tokens past T as the reference's zero
padding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.wkv.ops import wkv
from repro_torch.kernels.wkv.ref import CLAMP
from repro_torch.models.layers import RMSNorm, _device, cdtype, dense_init, full, rmsnorm


class RWKVLayer(nn.Module):
    """The JAX ``rwkv_layer_init`` dict as a module.  The matmul weights
    and the token-shift factors are kept in the compute dtype; the decay
    LoRA (``decay_w0``, ``decay_a``, ``decay_b``) and ``bonus_u`` in f32,
    where the reference uses them."""

    def __init__(self, generator, cfg, device=None, kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        d = cfg.d_model
        hs = cfg.rwkv_head_size
        h = d // hs
        lora = max(32, d // 16)
        dt = cdtype(cfg)
        g, dev = generator, device
        self.ln_t = RMSNorm(d, device=dev)
        self.ln_c = RMSNorm(d, device=dev)
        # time-mix token-shift interpolation factors
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, full((d,), 0.5, dtype=dt, device=dev))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, dense_init(g, (d, d), dtype=dt, device=dev))
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        self.decay_w0 = full((d,), -6.0, device=dev)
        self.decay_a = dense_init(g, (d, lora), scale=0.01, device=dev)
        self.decay_b = dense_init(g, (lora, d), scale=0.01, device=dev)
        self.bonus_u = full((h, hs), 0.0, device=dev)
        self.ln_x = RMSNorm(d, device=dev)
        # channel mix
        self.cmu_r = full((d,), 0.5, dtype=dt, device=dev)
        self.cmu_k = full((d,), 0.5, dtype=dt, device=dev)
        self.cw_r = dense_init(g, (d, d), dtype=dt, device=dev)
        self.cw_k = dense_init(g, (d, cfg.d_ff), dtype=dt, device=dev)
        self.cw_v = dense_init(g, (cfg.d_ff, d), dtype=dt, device=dev)
        self.kernels = kernels


def rwkv_layer_init(generator, cfg, device=None, kernels: bool = True) -> RWKVLayer:
    return RWKVLayer(generator, cfg, device=device, kernels=kernels)


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted right by one along time; position 0 filled with `last`
    (zeros at sequence start, the previous token in decode)."""
    if x.shape[1] == 1:
        return last[:, None] if last is not None else torch.zeros_like(x)
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


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


def time_mix(
    p, cfg, x: torch.Tensor,
    state: Optional[dict] = None,     # decode: {"s": (B,H,K,K), "last_t": (B,d)}
) -> Tuple[torch.Tensor, Optional[dict]]:
    b, t, d = x.shape
    hs = cfg.rwkv_head_size
    h = d // hs
    last = state["last_t"] if state is not None else None
    xx = _token_shift(x, last)
    xr = _mix(x, xx, p.mu_r) @ p.w_r.to(x.dtype)
    xk = _mix(x, xx, p.mu_k) @ p.w_k.to(x.dtype)
    xv = _mix(x, xx, p.mu_v) @ p.w_v.to(x.dtype)
    xg = _mix(x, xx, p.mu_g) @ p.w_g.to(x.dtype)
    xw = _mix(x, xx, p.mu_w)
    logw = -torch.exp(
        p.decay_w0.float() + (torch.tanh(xw.float() @ p.decay_a) @ p.decay_b)
    )                                              # (B,T,d) ≤ 0, f32

    r = xr.reshape(b, t, h, hs)
    k = xk.reshape(b, t, h, hs)
    v = xv.reshape(b, t, h, hs)
    lw = logw.reshape(b, t, h, hs)
    u = p.bonus_u

    new_state = None
    if state is not None and t == 1:               # exact decode recurrence
        s = state["s"]                             # (B,H,K,V) f32
        r1, k1, v1 = r[:, 0], k[:, 0], v[:, 0]
        lw1 = lw[:, 0].float()
        kv = torch.einsum("bhk,bhv->bhkv", k1.float(), v1.float())
        out = torch.einsum("bhk,bhkv->bhv", r1.float(), s + u[None, :, :, None] * kv)
        s = s * torch.exp(lw1)[..., None] + kv
        o = out[:, None].reshape(b, 1, d).to(x.dtype)
        new_state = {"s": s, "last_t": x[:, -1]}
    else:                                          # chunked parallel form
        chunk = cfg.rwkv_chunk
        if p.kernels:
            f32 = torch.float32
            o = wkv(r.to(f32), k.to(f32), v.to(f32), lw, u, chunk=chunk, device=x.device)
            o = o.to(x.dtype).reshape(b, t, d)
        else:
            pad = (-t) % chunk
            if pad:
                r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, lw))
            o = _chunked_wkv(r, k, v, lw, u, chunk)[:, :t].reshape(b, t, d)
        if state is not None:
            raise NotImplementedError("prefill->state handoff uses decode path")

    o = rmsnorm(p.ln_x, o, cfg.norm_eps)
    o = o * F.silu(xg)
    return o @ p.w_o.to(x.dtype), new_state


def channel_mix(p, cfg, x: torch.Tensor, state: Optional[dict] = None):
    last = state["last_c"] if state is not None else None
    xx = _token_shift(x, last)
    xr = _mix(x, xx, p.cmu_r)
    xk = _mix(x, xx, p.cmu_k)
    rgate = torch.sigmoid(xr @ p.cw_r.to(x.dtype))
    kk = torch.square(torch.relu(xk @ p.cw_k.to(x.dtype)))
    out = rgate * (kk @ p.cw_v.to(x.dtype))
    new_state = {"last_c": x[:, -1]} if state is not None else None
    return out, new_state


def rwkv_layer(p, cfg, x, state: Optional[dict] = None):
    h, st_t = time_mix(p, cfg, rmsnorm(p.ln_t, x, cfg.norm_eps), state)
    x = x + h
    h, st_c = channel_mix(p, cfg, rmsnorm(p.ln_c, x, cfg.norm_eps), state)
    x = x + h
    new_state = None
    if state is not None:
        new_state = {**(st_t or {}), **(st_c or {})}
    return x, new_state


def rwkv_init_state(cfg, batch: int, device=None):
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = d // hs
    return {
        "s": torch.zeros((batch, h, hs, hs), dtype=torch.float32, device=device),
        "last_t": torch.zeros((batch, d), dtype=cdtype(cfg), device=device),
        "last_c": torch.zeros((batch, d), dtype=cdtype(cfg), device=device),
    }
