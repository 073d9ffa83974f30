"""Unified model API (the JAX package's ``models/model.py``), for the
``dense`` and ``ssm`` families.

  init_params(generator, cfg)             — a model (``LM``) on the generator's device
  forward(params, cfg, batch)             — logits + aux (teacher-forced)
  hidden_states(params, cfg, batch)       — final-norm hidden states + aux
  make_serve_cache / prefill / decode_step — serving paths

``params`` is an :class:`LM`, the JAX parameter tree as modules (its
``state_dict`` keys are the JAX paths, with the layer index after
``stack``).  ``batch`` holds ``tokens`` (B, S) integers.  The training loss
(``loss_fn``) comes with the training slice (ROADMAP item 11).

``LM(..., kernels=False)`` runs the JAX package's plain attention and
chunked time mix on whatever device it is on, in place of the flash
attention and WKV kernels; it is for tests and replays only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import RMSNorm, cdtype, embed_init, rmsnorm
from repro_torch.models.transformer import make_cache, unported


class LM(nn.Module):
    """embed (V, d), final_norm, lm_head (d, V) unless tied, pos_embed
    (learned_pos), stack (one module a layer).  ``generator`` None leaves the
    weights uninitialised on ``device``, to be filled by
    ``models/convert.py`` or ``load_state_dict``."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None,
                 kernels: bool = True):
        super().__init__()
        if cfg.family not in transformer.PORTED_FAMILIES:
            raise unported(cfg.family)
        device = generator.device if generator is not None else torch.device(device or "cpu")
        g, dt = generator, cdtype(cfg)
        self.embed = embed_init(g, (cfg.vocab_size, cfg.d_model), dtype=dt, device=device)
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = embed_init(g, (cfg.d_model, cfg.vocab_size), dtype=dt, device=device)
        if cfg.learned_pos:
            self.pos_embed = embed_init(g, (32768, cfg.d_model), dtype=dt, device=device)
        if cfg.family == "dense":
            self.stack = transformer.dense_stack_init(g, cfg, device=device, kernels=kernels)
        else:
            self.stack = transformer.rwkv_stack_init(g, cfg, device=device, kernels=kernels)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(generator: torch.Generator, cfg, kernels: bool = True) -> LM:
    """A model with random weights drawn from ``generator``, on its device."""
    return LM(cfg, generator=generator, kernels=kernels)


# ---------------------------------------------------------------------------
# forward (teacher-forced eval)
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens, offset: int = 0):
    x = params.embed[tokens.long()].to(cdtype(cfg))
    if cfg.learned_pos:
        s = tokens.shape[1]
        x = x + params.pos_embed[int(offset):int(offset) + s].to(x.dtype)[None]
    return x


def _unembed(params, cfg, x):
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return (x @ w.to(x.dtype)).float()


def _stack(params, cfg, x, positions, caches=None, cache_pos=None):
    if cfg.family == "dense":
        return transformer.dense_stack_apply(params.stack, cfg, x, positions,
                                             caches=caches, cache_pos=cache_pos)
    return transformer.rwkv_stack_apply(params.stack, cfg, x, caches=caches)


@torch.inference_mode()
def hidden_states(params, cfg, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states (B, S, d) + aux loss — pre-unembed."""
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x, _, aux = _stack(params, cfg, _embed(params, cfg, tokens), positions)
    return rmsnorm(params.final_norm, x, cfg.norm_eps), aux


def unembed_weight(params, cfg):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


@torch.inference_mode()
def forward(params, cfg, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, S, V) f32 + aux loss."""
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x, _, aux = _stack(params, cfg, _embed(params, cfg, tokens), positions)
    return _unembed(params, cfg, x), aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_serve_cache(cfg, batch: int, max_seq: int, device=None):
    """The serving cache on ``device`` (CUDA unless named)."""
    return {"kv": make_cache(cfg, batch, max_seq, device=resolve_device(device))}


@torch.inference_mode()
def prefill(params, cfg, batch: Dict, cache) -> Tuple[torch.Tensor, Dict]:
    """Run the full prompt; returns (last-position logits, filled cache).

    ssm: the reference runs the chunked form without a state and returns
    the cache as it was (its ``time_mix`` cannot hand a state over), so
    decode starts from that cache and not from the prompt; the port does
    the same, to give the reference's tokens (ROADMAP queue 3)."""
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens)
    new_cache = dict(cache)
    if cfg.family == "dense":
        x, new_cache["kv"], _ = _stack(params, cfg, x, positions, caches=cache["kv"])
    else:
        x, _, _ = _stack(params, cfg, x, positions, caches=None)
    return _unembed(params, cfg, x[:, -1:]), new_cache


@torch.inference_mode()
def decode_step(params, cfg, token, cache, pos) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1) at position ``pos`` (an int) with the cache."""
    token = torch.as_tensor(token, device=params.device)
    positions = torch.full((1, 1), int(pos), dtype=torch.int32, device=token.device)
    x = _embed(params, cfg, token, offset=pos)
    new_cache = dict(cache)
    x, new_cache["kv"], _ = _stack(params, cfg, x, positions, caches=cache["kv"],
                                   cache_pos=pos)
    return _unembed(params, cfg, x), new_cache
