"""Layer stacks of the decoder families (the JAX package's
``models/transformer.py``), for the ``dense`` and ``ssm`` families.

The reference stacks each family's per-layer parameters along a leading
axis and runs ``lax.scan`` over it; here the layers are an
``nn.ModuleList`` and a Python loop runs over them.  Caches keep the
reference's stacked layout, (L, B, S_max, KVH, hd) tensors for attention
and (L, B, ...) for rwkv6's state, and each layer updates its slice in
place.

The ``moe``, ``vlm``, ``hybrid`` and ``audio`` families are not ported yet
(ROADMAP item 11): their builders raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import attn_init, self_attention
from repro_torch.models.layers import RMSNorm, _device, cdtype, rmsnorm, swiglu, swiglu_init
from repro_torch.models.rwkv6 import rwkv_init_state, rwkv_layer, rwkv_layer_init
from repro_torch.models.shardctx import constrain

PORTED_FAMILIES = ("dense", "ssm")


def unported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family!r} model family is not ported to PyTorch yet (ROADMAP item 11); "
        f"the port runs {', '.join(PORTED_FAMILIES)}")


# ---------------------------------------------------------------------------
# single decoder layer (dense)
# ---------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """The JAX ``layer_init`` dict as a module: ln1, attn, ln2, mlp."""

    def __init__(self, generator, cfg, cross: bool = False, moe: bool = False, device=None,
                 kernels: bool = True):
        super().__init__()
        if moe:
            raise unported("moe")
        device = _device(generator, device)
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = attn_init(generator, cfg, cross=cross, device=device, kernels=kernels)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype=cdtype(cfg), device=device)


def layer_init(generator, cfg, cross: bool = False, moe: bool = False, device=None,
               kernels: bool = True) -> DecoderLayer:
    return DecoderLayer(generator, cfg, cross=cross, moe=moe, device=device, kernels=kernels)


def layer_apply(
    p, cfg, x, positions, *, moe: bool, mode: str = "causal",
    cache=None, cache_pos=None,
):
    if moe:
        raise unported("moe")
    h, new_cache = self_attention(
        p.attn, cfg, rmsnorm(p.ln1, x, cfg.norm_eps), positions,
        mode=mode, cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    h = swiglu(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))
    return x + h, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# dense stack
# ---------------------------------------------------------------------------

def dense_stack_init(generator, cfg, device=None, kernels: bool = True) -> nn.ModuleList:
    if cfg.family != "dense":
        raise unported(cfg.family)
    return nn.ModuleList(layer_init(generator, cfg, device=device, kernels=kernels)
                         for _ in range(cfg.num_layers))


def _layer_cache(caches, i: int):
    return None if caches is None else {name: c[i] for name, c in caches.items()}


def dense_stack_apply(params, cfg, x, positions, caches=None, cache_pos=None):
    """caches: stacked (L, ...) KV dicts or None, updated in place.
    Returns (x, caches, aux)."""
    moe = cfg.family == "moe"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params):
        x, _, a = layer_apply(p, cfg, constrain(x), positions, moe=moe,
                              cache=_layer_cache(caches, i), cache_pos=cache_pos)
        x = constrain(x)
        aux = aux + a
    return x, caches, aux


# ---------------------------------------------------------------------------
# rwkv (ssm) stack
# ---------------------------------------------------------------------------

def rwkv_stack_init(generator, cfg, device=None, kernels: bool = True) -> nn.ModuleList:
    return nn.ModuleList(rwkv_layer_init(generator, cfg, device=device, kernels=kernels)
                         for _ in range(cfg.num_layers))


def rwkv_stack_apply(params, cfg, x, caches=None):
    """caches: the stacked (L, ...) state or None, updated in place."""
    for i, p in enumerate(params):
        st = _layer_cache(caches, i)
        x, new_st = rwkv_layer(p, cfg, constrain(x), st)
        x = constrain(x)
        if st is not None:
            for name, value in new_st.items():
                st[name].copy_(value)
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def make_cache(cfg, batch: int, max_seq: int, device=None):
    """Decode/prefill cache of one model family, stacked over the layers."""
    dt = cdtype(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    n = cfg.num_layers
    if cfg.family == "dense":
        shape = (n, batch, max_seq, kvh, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.family == "ssm":
        st = rwkv_init_state(cfg, batch, device=device)
        return {name: x[None].repeat((n,) + (1,) * x.dim()) for name, x in st.items()}
    raise unported(cfg.family)
