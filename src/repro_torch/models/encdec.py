"""Whisper-style encoder-decoder backbone, conv frontend stubbed (the JAX
package's ``models/encdec.py``).

Encoder: precomputed frame embeddings (B, T_enc, d) — the stub replaces
the two-conv mel frontend — plus fixed sinusoidal positions, then
bidirectional pre-LN transformer layers (GELU MLPs).

Decoder: learned positional embeddings, causal self-attention + cross
attention onto the encoder output.  Serving keeps a self-KV cache and a
cross-KV cache computed once per request (``decoder_cross_kv``).  The
layers are ``nn.ModuleList``s (the reference stacks them and scans);
caches keep the reference's stacked (L, ...) layout.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.attention import attn_init, cross_attention, cross_kv, self_attention
from repro_torch.models.layers import (
    GeluMLP,
    LayerNorm,
    _device,
    cdtype,
    gelu_mlp,
    layernorm,
    sinusoidal_pos,
)
from repro_torch.models.shardctx import constrain
from repro_torch.models.transformer import _maybe_remat


class EncLayer(nn.Module):
    """The JAX ``enc_layer_init`` dict: ln1, attn, ln2, mlp."""

    def __init__(self, generator, cfg, device=None, kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        self.ln1 = LayerNorm(cfg.d_model, device=device)
        self.attn = attn_init(generator, cfg, device=device, kernels=kernels)
        self.ln2 = LayerNorm(cfg.d_model, device=device)
        self.mlp = GeluMLP(generator, cfg.d_model, cfg.d_ff, dtype=cdtype(cfg), device=device)


class DecLayer(nn.Module):
    """The JAX ``dec_layer_init`` dict: ln1, self, ln2, cross (its tanh gate
    unused, as in the reference), ln3, mlp."""

    def __init__(self, generator, cfg, device=None, kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        self.ln1 = LayerNorm(cfg.d_model, device=device)
        self.self = attn_init(generator, cfg, device=device, kernels=kernels)
        self.ln2 = LayerNorm(cfg.d_model, device=device)
        self.cross = attn_init(generator, cfg, cross=True, device=device, kernels=kernels)
        self.ln3 = LayerNorm(cfg.d_model, device=device)
        self.mlp = GeluMLP(generator, cfg.d_model, cfg.d_ff, dtype=cdtype(cfg), device=device)


def enc_layer_init(generator, cfg, device=None, kernels: bool = True) -> EncLayer:
    return EncLayer(generator, cfg, device=device, kernels=kernels)


def dec_layer_init(generator, cfg, device=None, kernels: bool = True) -> DecLayer:
    return DecLayer(generator, cfg, device=device, kernels=kernels)


class EncDec(nn.Module):
    """The JAX ``encdec_init`` tree: encoder (one module a layer), enc_ln,
    decoder."""

    def __init__(self, generator, cfg, device=None, kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        self.encoder = nn.ModuleList(enc_layer_init(generator, cfg, device=device, kernels=kernels)
                                     for _ in range(cfg.num_encoder_layers))
        self.enc_ln = LayerNorm(cfg.d_model, device=device)
        self.decoder = nn.ModuleList(dec_layer_init(generator, cfg, device=device, kernels=kernels)
                                     for _ in range(cfg.num_layers))


def encdec_init(generator, cfg, device=None, kernels: bool = True) -> EncDec:
    return EncDec(generator, cfg, device=device, kernels=kernels)


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, d) stub embeddings -> encoder output (B, T_enc, d)."""
    t = frames.shape[1]
    x = frames + sinusoidal_pos(t, cfg.d_model, device=frames.device).to(frames.dtype)
    positions = torch.arange(t, device=frames.device)

    def body(p, x):
        x = constrain(x)
        h, _ = self_attention(p.attn, cfg, layernorm(p.ln1, x, cfg.norm_eps), positions,
                              mode="full")
        x = x + h
        return constrain(x + gelu_mlp(p.mlp, layernorm(p.ln2, x, cfg.norm_eps)))

    body = _maybe_remat(body, cfg)
    for p in params.encoder:
        x = body(p, x)
    return layernorm(params.enc_ln, x, cfg.norm_eps)


def decode_stack(
    params, cfg, x: torch.Tensor, positions,
    enc_out: Optional[torch.Tensor] = None,    # training/prefill path
    cross_caches=None,                         # decode path: stacked {"k","v"}
    self_caches=None,                          # stacked (L, ...), updated in place
    cache_pos=None,
):
    def body(i, p, x, kv):
        x = constrain(x)
        self_c = None if self_caches is None else {n: c[i] for n, c in self_caches.items()}
        h, _ = self_attention(p.self, cfg, layernorm(p.ln1, x, cfg.norm_eps), positions,
                              cache=self_c, cache_pos=cache_pos)
        x = x + h
        x = x + cross_attention(p.cross, cfg, layernorm(p.ln2, x, cfg.norm_eps), kv)
        return constrain(x + gelu_mlp(p.mlp, layernorm(p.ln3, x, cfg.norm_eps)))

    body = _maybe_remat(body, cfg)
    for i, p in enumerate(params.decoder):
        kv = enc_out if cross_caches is None else {n: c[i] for n, c in cross_caches.items()}
        x = body(i, p, x, kv)
    return x, self_caches


def decoder_cross_kv(params, cfg, enc_out: torch.Tensor):
    """Per-decoder-layer cross K/V (stacked) from the encoder output."""
    kvs = [cross_kv(p.cross, cfg, enc_out) for p in params.decoder]
    return {name: torch.stack([kv[name] for kv in kvs]) for name in ("k", "v")}
