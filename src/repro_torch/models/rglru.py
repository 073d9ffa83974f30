"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; the
JAX package's ``models/rglru.py``).

Elementwise diagonal recurrence:

    a_t = exp(c · r_t · log σ(Λ))          (r_t = σ(W_a x_t), c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Being diagonal-affine, prefill evaluates it as a scan of the affine maps
(a, b) in ⌈log₂ T⌉ doubling steps (``linear_scan``, in place of the
reference's ``lax.associative_scan``; the two associate the products in
another order, so they agree to f32 rounding); decode is the exact
one-step update.  The full recurrent block is Griffin's: {linear branch,
gate branch} → short causal conv1d → RG-LRU → ⊙ GeLU(gate) → linear out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _device, cdtype, dense_init, full, param

C_EXP = 8.0


class RGLRUBlock(nn.Module):
    """The JAX ``rglru_block_init`` dict as a module.  w_x, w_gate, conv_w,
    conv_b and w_out are kept in the compute dtype (the reference casts
    them at use); the recurrence's parameters (``lru_*``) in f32, where the
    reference uses them."""

    def __init__(self, generator, cfg, device=None):
        super().__init__()
        device = _device(generator, device)
        d = cfg.d_model
        w = cfg.lru_width or d
        dt = cdtype(cfg)
        g = generator
        self.w_x = dense_init(g, (d, w), dtype=dt, device=device)
        self.w_gate = dense_init(g, (d, w), dtype=dt, device=device)
        self.conv_w = dense_init(g, (cfg.conv_width, w), scale=0.1, dtype=dt, device=device)
        self.conv_b = full((w,), 0.0, dtype=dt, device=device)
        # σ(Λ) ∈ (.88, .99)
        self.lru_lambda = param(torch.linspace(2.0, 5.0, w, dtype=torch.float32, device=device))
        self.lru_wa = dense_init(g, (w, w), scale=0.01, device=device)
        self.lru_ba = full((w,), 0.0, device=device)
        self.lru_wi = dense_init(g, (w, w), scale=0.01, device=device)
        self.lru_bi = full((w,), 0.0, device=device)
        self.w_out = dense_init(g, (w, d), dtype=dt, device=device)


def rglru_block_init(generator, cfg, device=None) -> RGLRUBlock:
    return RGLRUBlock(generator, cfg, device=device)


def _conv1d(p, x: torch.Tensor, state: Optional[torch.Tensor]):
    """Causal depthwise conv, width cw. x (B,T,W). state: (B, cw-1, W) history."""
    cw = p.conv_w.shape[0]
    if state is None:
        hist = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        hist = state.to(x.dtype)
    xx = torch.cat([hist, x], dim=1)
    out = sum(
        xx[:, i : i + x.shape[1]] * p.conv_w[i].to(x.dtype) for i in range(cw)
    ) + p.conv_b.to(x.dtype)
    new_state = xx[:, -(cw - 1):] if cw > 1 else hist
    return out, new_state


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the affine maps h ↦ a·h + b, composed
    (a1, b1) then (a2, b2) as (a1·a2, b1·a2 + b2): Hillis–Steele doubling,
    ⌈log₂ T⌉ steps of whole-tensor ops.  The b of position t is h_t from
    h_{-1} = 0."""
    t = a.shape[1]
    step = 1
    while step < t:
        b = torch.cat([b[:, :step], b[:, :-step] * a[:, step:] + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return a, b


def _rglru(p, x: torch.Tensor, h0: Optional[torch.Tensor]):
    """x (B,T,W) -> (out, h_last). A scan over T (f32 state)."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.lru_wa + p.lru_ba)
    i = torch.sigmoid(xf @ p.lru_wi + p.lru_bi)
    log_a = C_EXP * r * F.logsigmoid(p.lru_lambda)          # ≤ 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)

    if x.shape[1] == 1 and h0 is not None:                  # decode
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None].to(x.dtype), h

    if h0 is not None:
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None], gated[:, 1:]], dim=1)
    _, hh = linear_scan(a, gated)
    return hh.to(x.dtype), hh[:, -1]


def rglru_block(
    p, cfg, x: torch.Tensor,
    state: Optional[dict] = None,   # {"conv": (B,cw-1,W), "h": (B,W)}
) -> Tuple[torch.Tensor, Optional[dict]]:
    branch = x @ p.w_x.to(x.dtype)
    gate = x @ p.w_gate.to(x.dtype)
    conv_state = state["conv"] if state is not None else None
    h0 = state["h"] if state is not None else None
    branch, new_conv = _conv1d(p, branch, conv_state)
    rec, h_last = _rglru(p, branch, h0)
    # jax.nn.gelu's default is the tanh approximation
    out = (rec * F.gelu(gate, approximate="tanh")) @ p.w_out.to(x.dtype)
    new_state = {"conv": new_conv, "h": h_last} if state is not None else None
    return out, new_state


def rglru_init_state(cfg, batch: int, device=None):
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=cdtype(cfg), device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
