"""Attention: GQA / MQA / MHA with RoPE, qk-norm, bias, causal / local /
cross / bidirectional masking, and KV-cache prefill & decode paths (the
JAX package's ``models/attention.py``).

Shapes:
  x        (B, S, d)
  q        (B, S, H, hd);  k, v (B, T, KVH, hd) with H = G·KVH: query heads
           [j·G, (j+1)·G) share kv head j
  cache    {"k": (B, S_max, KVH, hd), "v": ...} + an integer position

The attention core runs where the module's ``kernels`` flag sends it.
With ``kernels=True`` (the default) it is the flash attention op,
``kernels/flash_attn/ops.py::flash_sdpa``: the hand-written kernel on a
CUDA tensor, its plain version on a CPU tensor; a refusal by the kernel
raises, nothing falls back.  With ``kernels=False`` it is the JAX
package's own plain math, ``_sdpa`` over a boolean mask.  Both compute the
same function: a masked score weighs exactly 0 in ``_sdpa`` (NEG), so the
kernel route cuts the masked keys instead (decode: the keys up to the
position, with ``causal=False``, since the kernel's causal mask aligns
query row 0 with key 0).  In bf16 ``_sdpa`` rounds the scores and the
probabilities to bf16 and the kernel keeps the scores in f32, so there
the two agree within a tolerance, not bit for bit.

Caches are updated in place and returned (the reference returns new
arrays): a decode step writes one position of each layer's cache.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attn.ops import flash_sdpa
from repro_torch.kernels.flash_attn.ref import NEG
from repro_torch.models.layers import RMSNorm, _device, cdtype, dense_init, full, rmsnorm, rope


class Attention(nn.Module):
    """The JAX ``attn_init`` dict as a module: w_q, w_k, w_v, w_o (in the
    compute dtype), b_q/b_k/b_v (qkv_bias), q_norm/k_norm (qk_norm), gate
    (cross, f32)."""

    def __init__(self, generator, cfg, cross: bool = False, device=None, kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        d = cfg.d_model
        hd = cfg.resolved_head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        dt = cdtype(cfg)
        self.w_q = dense_init(generator, (d, h * hd), dtype=dt, device=device)
        self.w_k = dense_init(generator, (d, kvh * hd), dtype=dt, device=device)
        self.w_v = dense_init(generator, (d, kvh * hd), dtype=dt, device=device)
        self.w_o = dense_init(generator, (h * hd, d), dtype=dt, device=device)
        if cfg.qkv_bias:
            self.b_q = full((h * hd,), 0.0, dtype=dt, device=device)
            self.b_k = full((kvh * hd,), 0.0, dtype=dt, device=device)
            self.b_v = full((kvh * hd,), 0.0, dtype=dt, device=device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device=device)
            self.k_norm = RMSNorm(hd, device=device)
        if cross:
            self.gate = full((), 0.0, device=device)   # llama-3.2-vision tanh gate
        self.kernels = kernels


def attn_init(generator, cfg, cross: bool = False, device=None, kernels: bool = True) -> Attention:
    return Attention(generator, cfg, cross=cross, device=device, kernels=kernels)


def _project_qkv(p, cfg, x, kv_x):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    q = x @ p.w_q.to(x.dtype)
    k = kv_x @ p.w_k.to(x.dtype)
    v = kv_x @ p.w_v.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.b_q.to(x.dtype)
        k = k + p.b_k.to(x.dtype)
        v = v + p.b_v.to(x.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, kv_x.shape[1], kvh, hd)
    v = v.reshape(b, kv_x.shape[1], kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return q, k, v


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


CHUNKED_ATTN_MIN_SEQ = 8192  # default; per-arch override via cfg.chunked_attn_min_seq


def _sdpa_chunked(q, k, v, window: int = 0, causal: bool = True, chunk: int = 0):
    """Query-chunked causal attention: O(chunk·T) peak score memory.

    Each step computes one (chunk, T) stripe of the scores, softmaxes it
    exactly (the whole kv is visible to each row) and discards it; a
    Python loop over the chunks in place of the reference's ``lax.scan``.
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    chunk = chunk or max(512, min(2048, s // 2))
    chunk = min(chunk, s)
    if s % chunk:
        return _sdpa(q, k, v, _causal_mask(s, t, 0, window, q.device) if causal else None)
    outs = []
    for i in range(s // chunk):
        m = _causal_mask(chunk, t, i * chunk, window, q.device) if causal else None
        outs.append(_sdpa(q[:, i * chunk:(i + 1) * chunk], k, v, m))
    return torch.cat(outs, dim=1)


def _full_seq_sdpa(q, k, v, window: int, mode: str, min_seq: int = 0, kernels: bool = False):
    """Full-sequence self-attention; query-chunked above the size cutoff
    (the plain route; the kernel keeps one query tile's scores on chip)."""
    s = q.shape[1]
    causal = mode != "full"
    if kernels:
        return flash_sdpa(q, k, v, causal=causal, window=window if causal else 0,
                          device=q.device)
    if s >= (min_seq or CHUNKED_ATTN_MIN_SEQ):
        return _sdpa_chunked(q, k, v, window=window, causal=causal)
    if causal:
        return _sdpa(q, k, v, _causal_mask(s, s, 0, window, q.device))
    return _sdpa(q, k, v, None)


def self_attention(
    p,
    cfg,
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str = "causal",            # causal | local | full
    cache: Optional[dict] = None,    # decode/prefill KV cache, updated in place
    cache_pos=None,                  # decode position (an int or a 0-d tensor)
) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, x, x)
    if not cfg.learned_pos:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    window = cfg.local_window if mode == "local" else (cfg.sliding_window or 0)
    min_seq = getattr(cfg, "chunked_attn_min_seq", 0)
    new_cache = None
    if cache is not None and "slot_pos" in cache:
        # rolling-window cache (local attention): O(window) memory & decode
        # FLOPs regardless of context length.  Keys carry RoPE at absolute
        # positions; slot_pos[w] records which absolute position each slot
        # holds (-1 = empty), so masking survives wrap-around.
        ck, cv, sp = cache["k"], cache["v"], cache["slot_pos"]
        w = ck.shape[1]
        if s == 1:
            pos = int(cache_pos)
            slot = pos % w
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
            sp[slot] = pos
            wnd = window or w
            m = (sp >= 0) & (sp <= pos) & (sp > pos - wnd)
            if p.kernels:
                # the visible slots; a softmax does not depend on the keys' order.
                # A meta cache holds no positions: as many slots as the card
                # path passes, the first min(pos + 1, w, wnd)
                if ck.is_meta:
                    seen = slice(0, min(pos + 1, w, wnd))
                else:
                    seen = torch.nonzero(m).squeeze(1)
                out = flash_sdpa(q, ck[:, seen].to(q.dtype), cv[:, seen].to(q.dtype),
                                 causal=False, device=q.device)
            else:
                out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), m[None, None, None, :])
        else:
            out = _full_seq_sdpa(q, k, v, window, mode, min_seq, p.kernels)
            keep = min(w, s)
            pos_kept = torch.arange(s - keep, s, device=x.device)
            slots = pos_kept % w
            ck[:, slots] = k[:, -keep:].to(ck.dtype)
            cv[:, slots] = v[:, -keep:].to(cv.dtype)
            sp[slots] = pos_kept.to(sp.dtype)
        new_cache = {"k": ck, "v": cv, "slot_pos": sp}
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        if s == 1:  # decode: append to cache, score against everything so far
            pos = int(cache_pos)
            # the reference's dynamic_update_slice clamps the start: a position
            # past the cache's end overwrites its last slot
            slot = min(pos, ck.shape[1] - 1)
            ck[:, slot] = k[:, 0].to(ck.dtype)
            cv[:, slot] = v[:, 0].to(cv.dtype)
            if p.kernels:
                # the reference's mask (kpos <= pos, inside the window) gives
                # every other key a weight of exactly 0: cut them away
                lo = max(0, pos - window + 1) if window else 0
                out = flash_sdpa(q, ck[:, lo:pos + 1].to(q.dtype), cv[:, lo:pos + 1].to(q.dtype),
                                 causal=False, device=q.device)
            else:
                kpos = torch.arange(ck.shape[1], device=x.device)[None, :]
                m = kpos <= pos
                if window:
                    m = m & (kpos > pos - window)
                out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), m[None, None])
        else:       # prefill: causal over the fresh keys, then store
            out = _full_seq_sdpa(q, k, v, window, mode, min_seq, p.kernels)
            ck.zero_()
            cv.zero_()
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
    else:
        out = _full_seq_sdpa(q, k, v, window, mode, min_seq, p.kernels)

    y = out.reshape(b, s, h * hd) @ p.w_o.to(x.dtype)
    return y, new_cache


def cross_attention(
    p,
    cfg,
    x: torch.Tensor,
    kv,
    gated: bool = False,
) -> torch.Tensor:
    """x (B,S,d) attends to kv (B,T,d) (stub frame/patch embeddings), or to a
    precomputed {"k","v"} cross cache."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if isinstance(kv, dict):
        q = x @ p.w_q.to(x.dtype)
        if cfg.qkv_bias:
            q = q + p.b_q.to(x.dtype)
        q = q.reshape(b, s, h, hd)
        if cfg.qk_norm:
            q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k, v = kv["k"].to(x.dtype), kv["v"].to(x.dtype)
    else:
        q, k, v = _project_qkv(p, cfg, x, kv)
    if p.kernels:
        out = flash_sdpa(q, k, v, causal=False, device=q.device)
    else:
        out = _sdpa(q, k, v, None)
    y = out.reshape(b, s, h * hd) @ p.w_o.to(x.dtype)
    if gated:
        y = torch.tanh(p.gate).to(x.dtype) * y
    return y


def cross_kv(p, cfg, kv_x: torch.Tensor) -> dict:
    """Precompute cross-attention K/V once per request (prefill-time)."""
    b, t, _ = kv_x.shape
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = kv_x @ p.w_k.to(kv_x.dtype)
    v = kv_x @ p.w_v.to(kv_x.dtype)
    if cfg.qkv_bias:
        k = k + p.b_k.to(kv_x.dtype)
        v = v + p.b_v.to(kv_x.dtype)
    k = k.reshape(b, t, kvh, hd)
    v = v.reshape(b, t, kvh, hd)
    if cfg.qk_norm:
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return {"k": k, "v": v}
