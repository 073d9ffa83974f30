"""Unified model API over all families (the JAX package's
``models/model.py``).

  init_params(generator, cfg)             — a model (``LM``) on the generator's device
  abstract_params(cfg)                    — the same on the meta device (no data)
  forward(params, cfg, batch)             — logits + aux (teacher-forced)
  loss_fn(params, cfg, batch)             — full-logits CE + 0.01·aux
  hidden_states(params, cfg, batch)       — final-norm hidden states + aux
  train_hidden_states(params, cfg, batch) — the same with autograd on (the loss)
  make_serve_cache / prefill / decode_step — serving paths

``params`` is an :class:`LM`, the JAX parameter tree as modules (its
``state_dict`` keys are the JAX paths with the stacked axes' indices
written in: ``stack.<i>.attn.w_q``, vlm's ``stack.<u>.self.<j>.…``,
hybrid's ``stack.units.<u>.mix.<i>.…``; ``models/convert.py``).
``batch`` holds ``tokens`` (B, S) integers, plus the family stubs: frames
(B, T_enc, d) for audio, patches (B, P, d) for vlm.  The training loss
(``launch/steps.py::loss_fn``) differentiates ``train_hidden_states``;
``hidden_states`` and ``forward`` run in inference mode, for serving.

``LM(..., master=True)`` is the model a train step updates: every
parameter in f32 with ``requires_grad``, as the reference's f32 master
parameters, each cast to the compute dtype at its use (the serving model
keeps each weight in the dtype of its use, ``models/layers.py``).

``LM(..., kernels=False)`` runs the JAX package's plain attention and
chunked time mix on whatever device it is on, in place of the flash
attention and WKV kernels; it is for tests and replays only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import RMSNorm, cdtype, embed_init, rmsnorm
from repro_torch.models.transformer import make_cache

_STACKS = {
    "dense": transformer.dense_stack_init,
    "moe": transformer.dense_stack_init,
    "vlm": transformer.vlm_stack_init,
    "hybrid": transformer.hybrid_stack_init,
    "ssm": transformer.rwkv_stack_init,
    "audio": encdec.encdec_init,
}


class LM(nn.Module):
    """embed (V, d), final_norm, lm_head (d, V) unless tied, pos_embed
    (learned_pos), stack (the family's layer stack).  ``generator`` None
    leaves the weights uninitialised on ``device`` (CUDA unless named), to
    be filled by ``models/convert.py`` or ``load_state_dict``.
    ``master`` keeps every parameter in f32 with ``requires_grad``."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None, device=None,
                 kernels: bool = True, master: bool = False):
        super().__init__()
        if cfg.family not in _STACKS:
            raise ValueError(cfg.family)
        device = generator.device if generator is not None else resolve_device(device)
        if master:   # the weights are stored in f32; the forward casts at each use
            cfg = dataclasses.replace(cfg, dtype="float32")
        g, dt = generator, cdtype(cfg)
        self.embed = embed_init(g, (cfg.vocab_size, cfg.d_model), dtype=dt, device=device)
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = embed_init(g, (cfg.d_model, cfg.vocab_size), dtype=dt, device=device)
        if cfg.learned_pos:
            self.pos_embed = embed_init(g, (32768, cfg.d_model), dtype=dt, device=device)
        self.stack = _STACKS[cfg.family](g, cfg, device=device, kernels=kernels)
        if master:
            for p in self.parameters():
                p.requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(generator: torch.Generator, cfg, kernels: bool = True,
                master: bool = False) -> LM:
    """A model with random weights drawn from ``generator``, on its device."""
    return LM(cfg, generator=generator, kernels=kernels, master=master)


def abstract_params(cfg, kernels: bool = True, master: bool = False) -> LM:
    """The model on the meta device: every parameter's shape and dtype, no
    data (the reference's ``jax.eval_shape`` of ``init_params``)."""
    return LM(cfg, device="meta", kernels=kernels, master=master)


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


def _stub(params, batch, name, dtype):
    """A family stub (frames, patches) of ``batch`` on the model's device."""
    return torch.as_tensor(batch[name], device=params.device).to(dtype)


def _teacher_forced(params, cfg, batch):
    """The last hidden states (B, S, d), pre final norm, + aux."""
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens)
    if cfg.family in ("dense", "moe"):
        x, _, aux = transformer.dense_stack_apply(params.stack, cfg, x, positions)
    elif cfg.family == "vlm":
        pkv = transformer.vlm_patch_kv(params.stack, cfg, _stub(params, batch, "patches", x.dtype))
        x, _, aux = transformer.vlm_stack_apply(params.stack, cfg, x, positions, pkv)
    elif cfg.family == "hybrid":
        x, _, aux = transformer.hybrid_stack_apply(params.stack, cfg, x, positions)
    elif cfg.family == "ssm":
        x, _, aux = transformer.rwkv_stack_apply(params.stack, cfg, x)
    else:   # audio
        enc_out = encdec.encode(params.stack, cfg, _stub(params, batch, "frames", x.dtype))
        x, _ = encdec.decode_stack(params.stack, cfg, x, positions, enc_out=enc_out)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def train_hidden_states(params, cfg, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states (B, S, d) + aux loss — pre-unembed — under
    the caller's grad mode: what the training loss differentiates."""
    x, aux = _teacher_forced(params, cfg, batch)
    return rmsnorm(params.final_norm, x, cfg.norm_eps), aux


@torch.inference_mode()
def hidden_states(params, cfg, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states (B, S, d) + aux loss — pre-unembed."""
    return train_hidden_states(params, cfg, batch)


def unembed_weight(params, cfg):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


@torch.inference_mode()
def forward(params, cfg, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, S, V) f32 + aux loss (MoE load balance,
    summed over the layers)."""
    x, aux = _teacher_forced(params, cfg, batch)
    return _unembed(params, cfg, x), aux


def loss_fn(params, cfg, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Mean cross-entropy of the full (B, S, V) f32 logits over the valid
    (label >= 0) positions, plus 0.01 · aux, under the caller's grad mode.
    The train step's loss is the chunked one (``launch/steps.py::loss_fn``),
    which never holds the full logits."""
    x, aux = _teacher_forced(params, cfg, batch)
    logits = _unembed(params, cfg, x)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    valid = (labels >= 0).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    ce = -(ll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux, "tokens": valid.sum()}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_serve_cache(cfg, batch: int, max_seq: int, device=None):
    """The serving cache on ``device`` (CUDA unless named): ``kv`` (the
    family's, ``transformer.make_cache``), and for vlm and audio ``cross``
    (per unit or decoder layer: the patches' or the encoder's K/V)."""
    device = resolve_device(device)
    cache = {"kv": make_cache(cfg, batch, max_seq, device=device)}
    if cfg.family in ("vlm", "audio"):
        if cfg.family == "vlm":
            n, t = cfg.num_layers // cfg.cross_attn_every, cfg.num_patches
        else:
            n, t = cfg.num_layers, cfg.encoder_seq
        shape = (n, batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["cross"] = {name: torch.zeros(shape, dtype=cdtype(cfg), device=device)
                          for name in ("k", "v")}
    return cache


def _store(cache, kv):
    """Write freshly computed cross K/V into the cache's (in place)."""
    for name, value in kv.items():
        cache[name].copy_(value)
    return cache


@torch.inference_mode()
def prefill(params, cfg, batch: Dict, cache) -> Tuple[torch.Tensor, Dict]:
    """Run the full prompt; returns (last-position logits, filled cache).

    ssm: the reference runs the chunked form without a state and returns
    the cache as it was (its ``time_mix`` cannot hand a state over), so
    decode starts from that cache and not from the prompt; hybrid: the
    RG-LRU blocks start from the cache's state (a slot's previous
    request's after its first); the port does the same, to give the
    reference's tokens (ROADMAP queue 3)."""
    tokens = torch.as_tensor(batch["tokens"], device=params.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens)
    new_cache = dict(cache)
    if cfg.family in ("dense", "moe"):
        x, new_cache["kv"], _ = transformer.dense_stack_apply(params.stack, cfg, x, positions,
                                                              caches=cache["kv"])
    elif cfg.family == "vlm":
        pkv = transformer.vlm_patch_kv(params.stack, cfg, _stub(params, batch, "patches", x.dtype))
        new_cache["cross"] = _store(cache["cross"], pkv)
        x, new_cache["kv"], _ = transformer.vlm_stack_apply(params.stack, cfg, x, positions,
                                                            new_cache["cross"], caches=cache["kv"])
    elif cfg.family == "hybrid":
        x, new_cache["kv"], _ = transformer.hybrid_stack_apply(params.stack, cfg, x, positions,
                                                               caches=cache["kv"])
    elif cfg.family == "ssm":
        x, _, _ = transformer.rwkv_stack_apply(params.stack, cfg, x, caches=None)
    else:   # audio
        enc_out = encdec.encode(params.stack, cfg, _stub(params, batch, "frames", x.dtype))
        new_cache["cross"] = _store(cache["cross"], encdec.decoder_cross_kv(params.stack, cfg,
                                                                            enc_out))
        x, new_cache["kv"] = encdec.decode_stack(params.stack, cfg, x, positions,
                                                 cross_caches=new_cache["cross"],
                                                 self_caches=cache["kv"])
    return _unembed(params, cfg, x[:, -1:]), new_cache


@torch.inference_mode()
def decode_step(params, cfg, token, cache, pos) -> Tuple[torch.Tensor, Dict]:
    """One token (B, 1) at position ``pos`` (an int) with the cache."""
    token = torch.as_tensor(token, device=params.device)
    positions = torch.full((1, 1), int(pos), dtype=torch.int32, device=token.device)
    x = _embed(params, cfg, token, offset=pos)
    new_cache = dict(cache)
    kw = dict(caches=cache["kv"], cache_pos=pos)
    if cfg.family in ("dense", "moe"):
        x, new_cache["kv"], _ = transformer.dense_stack_apply(params.stack, cfg, x, positions, **kw)
    elif cfg.family == "vlm":
        x, new_cache["kv"], _ = transformer.vlm_stack_apply(params.stack, cfg, x, positions,
                                                            cache["cross"], **kw)
    elif cfg.family == "hybrid":
        x, new_cache["kv"], _ = transformer.hybrid_stack_apply(params.stack, cfg, x, positions,
                                                               **kw)
    elif cfg.family == "ssm":
        x, new_cache["kv"], _ = transformer.rwkv_stack_apply(params.stack, cfg, x,
                                                             caches=cache["kv"])
    else:   # audio
        x, new_cache["kv"] = encdec.decode_stack(params.stack, cfg, x, positions,
                                                 cross_caches=cache["cross"],
                                                 self_caches=cache["kv"], cache_pos=pos)
    return _unembed(params, cfg, x), new_cache
