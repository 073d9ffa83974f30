"""Layer stacks of every decoder family (the JAX package's
``models/transformer.py``).

The reference stacks each family's per-layer parameters along a leading
axis and runs ``lax.scan`` over pattern units:

  dense / moe : unit = 1 layer
  vlm         : unit = (cross_attn_every-1) self layers + 1 cross layer
  hybrid      : unit = block_pattern (e.g. rglru, rglru, attn), plus an
                explicit tail for L % |pattern|
  ssm (rwkv6) : unit = 1 rwkv layer

Here the units are an ``nn.ModuleList`` (the hybrid unit's blocks a
``ModuleList`` of their own, as the reference's lists) and a Python loop
runs over them.  Caches keep the reference's stacked layout — (L, B,
S_max, KVH, hd) for attention, (U, n_self, ...) for vlm, the hybrid's
{"units": [(U, ...) per block of the pattern], "tail": [...]} with a
``slot_pos`` rolling window for local attention and {conv, h} for RG-LRU,
(L, B, ...) for rwkv6's state — and each layer updates its slice in place.

Where the reference rematerialises a scanned body (``_maybe_remat``:
``cfg.remat``, the full configs' default), the port checkpoints the same
body with ``torch.utils.checkpoint``: its activations are recomputed in
backward instead of kept.  That only matters where autograd records
(training); a serving call runs the body as it is.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models.attention import attn_init, cross_attention, cross_kv, self_attention
from repro_torch.models.layers import RMSNorm, _device, cdtype, rmsnorm, swiglu, swiglu_init
from repro_torch.models.moe import moe_ffn, moe_init
from repro_torch.models.rglru import rglru_block, rglru_block_init, rglru_init_state
from repro_torch.models.rwkv6 import rwkv_init_state, rwkv_layer, rwkv_layer_init
from repro_torch.models.shardctx import constrain


# remat_policy "dots": the reference's dots_with_no_batch_dims_saveable keeps
# the outputs of matmuls without batch dimensions (x @ w: aten.mm / addmm;
# the attention and expert einsums are batched, aten.bmm, and recomputed)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg):
    """``fn`` checkpointed where ``cfg.remat`` asks for it and autograd
    records; ``remat_policy="dots"`` keeps the matmuls' outputs."""
    if not cfg.remat:
        return fn
    kw = {}
    if getattr(cfg, "remat_policy", "full") == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _copy_state(cache, new):
    """Write a block's new recurrent state into its cache slice."""
    if cache is not None:
        for name, value in new.items():
            cache[name].copy_(value)


# ---------------------------------------------------------------------------
# single decoder layer (dense / moe / + optional cross)
# ---------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """The JAX ``layer_init`` dict as a module: ln1, attn, ln2, mlp (SwiGLU,
    or the MoE layer)."""

    def __init__(self, generator, cfg, cross: bool = False, moe: bool = False, device=None,
                 kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = attn_init(generator, cfg, cross=cross, device=device, kernels=kernels)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        if moe:
            self.mlp = moe_init(generator, cfg, device=device)
        else:
            self.mlp = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype=cdtype(cfg),
                                   device=device)


def layer_init(generator, cfg, cross: bool = False, moe: bool = False, device=None,
               kernels: bool = True) -> DecoderLayer:
    return DecoderLayer(generator, cfg, cross=cross, moe=moe, device=device, kernels=kernels)


def layer_apply(
    p, cfg, x, positions, *, moe: bool, mode: str = "causal",
    cache=None, cache_pos=None,
):
    h, new_cache = self_attention(
        p.attn, cfg, rmsnorm(p.ln1, x, cfg.norm_eps), positions,
        mode=mode, cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    if moe:
        h, aux = moe_ffn(p.mlp, cfg, rmsnorm(p.ln2, x, cfg.norm_eps))
    else:
        h, aux = swiglu(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps)), _zero(x)
    return x + h, new_cache, aux


def cross_layer_init(generator, cfg, device=None, kernels: bool = True) -> DecoderLayer:
    """The JAX ``cross_layer_init`` dict: ln1, attn (with the tanh gate),
    ln2, mlp."""
    return layer_init(generator, cfg, cross=True, device=device, kernels=kernels)


def cross_layer_apply(p, cfg, x, kv):
    h = cross_attention(p.attn, cfg, rmsnorm(p.ln1, x, cfg.norm_eps), kv, gated=True)
    x = x + h
    return x + swiglu(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# dense / moe stack
# ---------------------------------------------------------------------------

def dense_stack_init(generator, cfg, device=None, kernels: bool = True) -> nn.ModuleList:
    moe = cfg.family == "moe"
    return nn.ModuleList(layer_init(generator, cfg, moe=moe, device=device, kernels=kernels)
                         for _ in range(cfg.num_layers))


def _slice(caches, *index):
    """One layer's (or unit's) view of stacked caches, or None."""
    return None if caches is None else {name: c[index] for name, c in caches.items()}


def dense_stack_apply(params, cfg, x, positions, caches=None, cache_pos=None):
    """caches: stacked (L, ...) KV dicts or None, updated in place.
    Returns (x, caches, aux)."""
    moe = cfg.family == "moe"

    def body(p, x, cache):
        x, _, a = layer_apply(p, cfg, constrain(x), positions, moe=moe, cache=cache,
                              cache_pos=cache_pos)
        return constrain(x), a

    body = _maybe_remat(body, cfg)
    aux = _zero(x)
    for i, p in enumerate(params):
        x, a = body(p, x, _slice(caches, i))
        aux = aux + a
    return x, caches, aux


# ---------------------------------------------------------------------------
# vlm stack: units of (cross_attn_every-1) self layers + 1 cross layer
# ---------------------------------------------------------------------------

class VLMUnit(nn.Module):
    """One unit of the JAX ``vlm_stack_init`` tree: ``self`` (the unit's
    self layers) and ``cross``."""

    def __init__(self, generator, cfg, device=None, kernels: bool = True):
        super().__init__()
        n_self = cfg.cross_attn_every - 1
        self.self = nn.ModuleList(layer_init(generator, cfg, device=device, kernels=kernels)
                                  for _ in range(n_self))
        self.cross = cross_layer_init(generator, cfg, device=device, kernels=kernels)


def vlm_stack_init(generator, cfg, device=None, kernels: bool = True) -> nn.ModuleList:
    n_units = cfg.num_layers // cfg.cross_attn_every
    return nn.ModuleList(VLMUnit(generator, cfg, device=device, kernels=kernels)
                         for _ in range(n_units))


def vlm_stack_apply(params, cfg, x, positions, patch_kv, caches=None, cache_pos=None):
    """patch_kv: the per-unit cross {"k","v"} (U, B, P, KVH, hd); caches: the
    (U, n_self, ...) KV dicts or None, updated in place."""
    def body(u, unit, x, pkv):
        for j, sp in enumerate(unit.self):
            x, _, _ = layer_apply(sp, cfg, constrain(x), positions, moe=False,
                                  cache=_slice(caches, u, j), cache_pos=cache_pos)
            x = constrain(x)
        return constrain(cross_layer_apply(unit.cross, cfg, x, pkv))

    body = _maybe_remat(body, cfg)
    for u, unit in enumerate(params):
        x = body(u, unit, x, _slice(patch_kv, u))
    return x, caches, _zero(x)


def vlm_patch_kv(params, cfg, patches):
    """Per-unit cross K/V (stacked over the units) from the stub patch
    embeddings (B, P, d)."""
    b, n, _ = patches.shape
    shape = (len(params), b, n, cfg.num_kv_heads, cfg.resolved_head_dim)
    out = {name: patches.new_empty(shape) for name in ("k", "v")}
    for u, unit in enumerate(params):
        for name, value in cross_kv(unit.cross.attn, cfg, patches).items():
            out[name][u] = value
    return out


# ---------------------------------------------------------------------------
# hybrid (recurrentgemma) stack: pattern units + explicit tail
# ---------------------------------------------------------------------------

def _mixer(generator, cfg, kind, device, kernels):
    if kind == "rglru":
        return rglru_block_init(generator, cfg, device=device)
    return attn_init(generator, cfg, device=device, kernels=kernels)


class HybridUnit(nn.Module):
    """One unit of the JAX ``hybrid_unit_init`` tree: the lists mix, mlp,
    ln_mix, ln_mlp, one entry a block of the pattern."""

    def __init__(self, generator, cfg, device=None, kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        pat = cfg.block_pattern
        self.mix = nn.ModuleList(_mixer(generator, cfg, kind, device, kernels) for kind in pat)
        self.mlp = nn.ModuleList(
            swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype=cdtype(cfg), device=device)
            for _ in pat)
        self.ln_mix = nn.ModuleList(RMSNorm(cfg.d_model, device=device) for _ in pat)
        self.ln_mlp = nn.ModuleList(RMSNorm(cfg.d_model, device=device) for _ in pat)


def hybrid_unit_init(generator, cfg, device=None, kernels: bool = True) -> HybridUnit:
    return HybridUnit(generator, cfg, device=device, kernels=kernels)


class HybridBlock(nn.Module):
    """One entry of the JAX hybrid ``tail`` list: mix, mlp, ln_mix, ln_mlp."""

    def __init__(self, generator, cfg, kind, device=None, kernels: bool = True):
        super().__init__()
        device = _device(generator, device)
        self.mix = _mixer(generator, cfg, kind, device, kernels)
        self.mlp = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype=cdtype(cfg), device=device)
        self.ln_mix = RMSNorm(cfg.d_model, device=device)
        self.ln_mlp = RMSNorm(cfg.d_model, device=device)


class HybridStack(nn.Module):
    """The JAX ``hybrid_stack_init`` tree: ``units`` and, where the pattern
    does not divide the depth, ``tail``."""

    def __init__(self, generator, cfg, device=None, kernels: bool = True):
        super().__init__()
        pat = cfg.block_pattern
        n_units, n_tail = divmod(cfg.num_layers, len(pat))
        self.units = nn.ModuleList(hybrid_unit_init(generator, cfg, device=device, kernels=kernels)
                                   for _ in range(n_units))
        if n_tail:
            self.tail = nn.ModuleList(HybridBlock(generator, cfg, pat[i], device=device,
                                                  kernels=kernels) for i in range(n_tail))


def hybrid_stack_init(generator, cfg, device=None, kernels: bool = True) -> HybridStack:
    return HybridStack(generator, cfg, device=device, kernels=kernels)


def _hybrid_block(kind, p_mix, p_mlp, ln_mix, ln_mlp, cfg, x, positions, cache, cache_pos):
    """One block; its cache slice (or None) is updated in place."""
    if kind == "rglru":
        h, new_state = rglru_block(p_mix, cfg, rmsnorm(ln_mix, x, cfg.norm_eps), cache)
        _copy_state(cache, new_state)
    else:
        h, _ = self_attention(
            p_mix, cfg, rmsnorm(ln_mix, x, cfg.norm_eps), positions,
            mode="local", cache=cache, cache_pos=cache_pos,
        )
    x = x + h
    return x + swiglu(p_mlp, rmsnorm(ln_mlp, x, cfg.norm_eps))


def hybrid_stack_apply(params, cfg, x, positions, caches=None, cache_pos=None):
    """caches: {"units": [stacked (U, ...) per block], "tail": [...]} or
    None, updated in place."""
    pat = cfg.block_pattern

    def body(u, unit, x):
        for i, kind in enumerate(pat):
            c_i = None if caches is None else _slice(caches["units"][i], u)
            x = _hybrid_block(kind, unit.mix[i], unit.mlp[i], unit.ln_mix[i], unit.ln_mlp[i],
                              cfg, constrain(x), positions, c_i, cache_pos)
        return constrain(x)

    body = _maybe_remat(body, cfg)
    for u, unit in enumerate(params.units):
        x = body(u, unit, x)
    for i, p in enumerate(getattr(params, "tail", ())):
        c_i = None if caches is None else caches["tail"][i]
        x = _hybrid_block(pat[i], p.mix, p.mlp, p.ln_mix, p.ln_mlp, cfg, x, positions, c_i,
                          cache_pos)
    return x, caches, _zero(x)


# ---------------------------------------------------------------------------
# rwkv (ssm) stack
# ---------------------------------------------------------------------------

def rwkv_stack_init(generator, cfg, device=None, kernels: bool = True) -> nn.ModuleList:
    return nn.ModuleList(rwkv_layer_init(generator, cfg, device=device, kernels=kernels)
                         for _ in range(cfg.num_layers))


def rwkv_stack_apply(params, cfg, x, caches=None):
    """caches: the stacked (L, ...) state or None, updated in place."""
    def body(p, x, st):
        x, new_st = rwkv_layer(p, cfg, constrain(x), st)
        return constrain(x), new_st

    body = _maybe_remat(body, cfg)
    for i, p in enumerate(params):
        st = _slice(caches, i)
        x, new_st = body(p, x, st)
        _copy_state(st, new_st)
    return x, caches, _zero(x)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def _stacked(tree, *lead):
    """``tree``'s leaves repeated along new leading axes ``lead``."""
    return {name: x.expand(*lead, *x.shape).clone() for name, x in tree.items()}


def make_cache(cfg, batch: int, max_seq: int, device=None):
    """Decode/prefill cache of one model family, in the reference's layout."""
    dt = cdtype(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def kv(seq):
        return {"k": torch.zeros((batch, seq, kvh, hd), dtype=dt, device=device),
                "v": torch.zeros((batch, seq, kvh, hd), dtype=dt, device=device)}

    if cfg.family in ("dense", "moe", "audio"):  # audio: decoder self-KV
        return _stacked(kv(max_seq), cfg.num_layers)
    if cfg.family == "vlm":
        n_units = cfg.num_layers // cfg.cross_attn_every
        return _stacked(kv(max_seq), n_units, cfg.cross_attn_every - 1)
    if cfg.family == "ssm":
        return _stacked(rwkv_init_state(cfg, batch, device=device), cfg.num_layers)
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_units, n_tail = divmod(cfg.num_layers, len(pat))
        window = min(cfg.local_window or max_seq, max_seq)

        def block_cache(kind):
            if kind == "rglru":
                return rglru_init_state(cfg, batch, device=device)
            c = kv(window)
            c["slot_pos"] = torch.full((window,), -1, dtype=torch.int32, device=device)
            return c

        return {"units": [_stacked(block_cache(kind), n_units) for kind in pat],
                "tail": [block_cache(pat[i]) for i in range(n_tail)]}
    raise ValueError(cfg.family)
