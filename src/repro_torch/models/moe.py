"""Mixture-of-Experts layer with einsum (dispatch-tensor) routing (the JAX
package's ``models/moe.py``).

Routing IS a KNN join (DESIGN.md §4): every token's activation joins
against the expert rows of the router matrix under dot-product similarity
with k = num_experts_per_tok — R = tokens, S = router rows.  ``route`` is
that join: the k largest router probabilities of each token, descending,
ties to the lower expert id (``lax.top_k``'s order; a stable descending
sort gives it, ``torch.topk`` promises no order among equal values).  The
same top k as ``core/topk.py::topk_update`` on one block
(``tests/test_torch_moe.py``).

Dispatch is the Mesh-TensorFlow/Switch dispatch einsum with the K axis
collapsed before the capacity one-hot: the (G, Tg, E) assignment and gate
matrices first, then one (G, Tg, E, C) dispatch tensor.  Tokens are cut
into groups of at most ``moe_group_size`` (the largest divisor of the
token count that fits); a token past its expert's capacity C is dropped,
in token order.  A decode step (one token) has C = 1 and runs the expert
products over all E experts, as the reference does.

The load-balance loss of a layer is ``E·K·Σ_e frac_tokens_e·frac_probs_e``
over all its tokens.  A step that splits a batch over devices
(``launch/steps.py``) needs the two means apart to form the whole batch's
product: inside :func:`record_balance` every ``moe_ffn`` call appends its
``(frac_tokens, frac_probs)`` (the first detached: it comes from the top-k
assignment and carries no gradient, as in the reference).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _device, cdtype, dense_init
from repro_torch.models.shardctx import constrain_named


class MoE(nn.Module):
    """The JAX ``moe_init`` dict as a module: router (d, E), w_gate and
    w_up (E, d, ff), w_down (E, ff, d), all in the compute dtype (the
    reference casts each to the activations' dtype at use)."""

    def __init__(self, generator, cfg, device=None):
        super().__init__()
        device = _device(generator, device)
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        dt = cdtype(cfg)
        self.router = dense_init(generator, (d, e), scale=0.02, dtype=dt, device=device)
        self.w_gate = dense_init(generator, (e, d, ff), dtype=dt, device=device)
        self.w_up = dense_init(generator, (e, d, ff), dtype=dt, device=device)
        self.w_down = dense_init(generator, (e, ff, d), dtype=dt, device=device)


_BALANCE: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def record_balance():
    """Collect each ``moe_ffn`` call's (frac_tokens, frac_probs), in call
    order (one entry a MoE layer of a forward), into the yielded list."""
    global _BALANCE
    prev, _BALANCE = _BALANCE, []
    try:
        yield _BALANCE
    finally:
        _BALANCE = prev


def moe_init(generator, cfg, device=None) -> MoE:
    return MoE(generator, cfg, device=device)


def top_experts(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, descending,
    equal values in index order, and their indices (int64)."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def route(p, cfg, xf: torch.Tensor):
    """The KNN-join step: tokens xf (G, Tg, d) against the router's E rows.
    Returns (probs (G, Tg, E) f32, top_p (G, Tg, K) renormalised, top_e
    (G, Tg, K) expert ids)."""
    logits = (xf @ p.router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_experts(probs, cfg.num_experts_per_tok)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def group_size(t: int, cfg) -> int:
    """The largest group size <= ``moe_group_size`` that divides t."""
    tg = min(cfg.moe_group_size, t)
    while t % tg:
        tg -= 1
    return tg


def moe_ffn(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). Top-k routing + capacity dispatch."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    tg = group_size(t, cfg)
    g = t // tg
    cap = max(int(tg * k / e * cfg.capacity_factor), 1)

    xf = x.reshape(g, tg, d)
    probs, top_p, top_e = route(p, cfg, xf)

    # collapse K before the capacity one-hot: (G, Tg, E) assignment + gates
    sel_k = F.one_hot(top_e, e).float()                    # (G, Tg, K, E)
    assign = sel_k.sum(dim=2)                              # (G, Tg, E) ∈ {0,1}
    gates = torch.einsum("gtke,gtk->gte", sel_k, top_p)    # (G, Tg, E)

    # position within each expert's buffer (token-major priority)
    pos = torch.cumsum(assign, dim=1) - assign             # (G, Tg, E)
    keep = (pos < cap) & (assign > 0)
    pos = torch.where(keep, pos, 0.0).long()
    dispatch = F.one_hot(pos, cap).to(x.dtype) * keep[..., None].to(x.dtype)
    dispatch = constrain_named(dispatch, "moe_dispatch")  # (G, Tg, E, C)
    combine = dispatch * gates[..., None].to(x.dtype)

    xe = torch.einsum("gtec,gtd->gecd", dispatch, xf)      # (G, E, C, d)
    xe = constrain_named(xe, "moe_expert")
    h_g = torch.einsum("gecd,edf->gecf", xe, p.w_gate.to(x.dtype))
    h_u = torch.einsum("gecd,edf->gecf", xe, p.w_up.to(x.dtype))
    h = F.silu(h_g) * h_u
    ye = torch.einsum("gecf,efd->gecd", h, p.w_down.to(x.dtype))
    ye = constrain_named(ye, "moe_expert")
    y = torch.einsum("gtec,gecd->gtd", combine, ye)
    y = constrain_named(y, "moe_out")

    # load-balance auxiliary loss (Switch): E * Σ_e f_e · P_e
    frac_tokens = assign.mean(dim=(0, 1)) / k              # (E,)
    frac_probs = probs.mean(dim=(0, 1))
    if _BALANCE is not None:
        _BALANCE.append((frac_tokens.detach(), frac_probs))
    aux = e * torch.sum(frac_tokens * frac_probs) * k

    return y.reshape(b, s, d), aux
