"""Common model building blocks: norms, embeddings, RoPE, MLPs, initializers
(the JAX package's ``models/layers.py``).

Parameters live in ``nn.Module``s whose parameter names are the JAX
package's dict keys (``scale``, ``w_gate``, ...), so ``models/convert.py``
carries a JAX parameter tree onto a model path for path.  The modules
only hold parameters: the functions take such a module where the JAX
ones take a dict (``p.w_gate`` for ``p["w_gate"]``).  Initializers draw from an explicit ``torch.Generator``
with the JAX distributions; the numbers differ from ``jax.random``'s, so
the parity tests carry the JAX weights over instead.

Weights are kept in the dtype of their use.  The JAX package keeps every
parameter in f32 and casts a matmul weight to the activations' dtype at
each use (``p["w_q"].astype(x.dtype)``); the port casts it once, when it
is made or converted, which gives the same numbers without reading the
weights again in f32 at every step.  Parameters that are used in f32
(norm scales, rwkv6's decay LoRA and bonus) stay f32.  A serving model
needs no gradient: every parameter has ``requires_grad=False``.  A model
built to train (``models/model.py::LM(master=True)``) stores every weight
in f32 with ``requires_grad``, and the same casts at each use give the
reference's f32 masters.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def cdtype(cfg) -> torch.dtype:
    """The compute dtype of ``cfg`` ("bfloat16" -> torch.bfloat16)."""
    return getattr(torch, cfg.dtype)


def param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


# ---------------------------------------------------------------------------
# initializers: ``generator`` None gives uninitialised storage on ``device``
# (filled by models/convert.py or load_state_dict)
# ---------------------------------------------------------------------------

def dense_init(generator: Optional[torch.Generator], shape, scale: Optional[float] = None,
               dtype=torch.float32, device=None) -> nn.Parameter:
    """normal · 1/√fan_in (or ``scale``), drawn in f32, stored in ``dtype``."""
    if generator is None:
        return param(torch.empty(shape, dtype=dtype, device=device))
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return param((x * scale).to(dtype))


def embed_init(generator: Optional[torch.Generator], shape, dtype=torch.float32,
               device=None) -> nn.Parameter:
    """normal · 0.02, drawn in f32, stored in ``dtype``."""
    return dense_init(generator, shape, scale=0.02, dtype=dtype, device=device)


def full(shape, value: float, dtype=torch.float32, device=None) -> nn.Parameter:
    return param(torch.full(shape, value, dtype=dtype, device=device))


def _device(generator, device):
    return generator.device if generator is not None else device


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = full((d,), 1.0, device=device)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * p.scale
    return out.to(dt)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = full((d,), 1.0, device=device)
        self.bias = full((d,), 0.0, device=device)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    return out.to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (f32)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    def __init__(self, generator, d: int, ff: int, dtype=torch.float32, device=None):
        super().__init__()
        device = _device(generator, device)
        self.w_gate = dense_init(generator, (d, ff), dtype=dtype, device=device)
        self.w_up = dense_init(generator, (d, ff), dtype=dtype, device=device)
        self.w_down = dense_init(generator, (ff, d), dtype=dtype, device=device)


def swiglu_init(generator, d: int, ff: int, dtype=torch.float32, device=None) -> SwiGLU:
    return SwiGLU(generator, d, ff, dtype=dtype, device=device)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p.w_gate.to(x.dtype))
    u = x @ p.w_up.to(x.dtype)
    return (g * u) @ p.w_down.to(x.dtype)


class GeluMLP(nn.Module):
    def __init__(self, generator, d: int, ff: int, dtype=torch.float32, device=None):
        super().__init__()
        device = _device(generator, device)
        self.w_in = dense_init(generator, (d, ff), dtype=dtype, device=device)
        self.b_in = full((ff,), 0.0, dtype=dtype, device=device)
        self.w_out = dense_init(generator, (ff, d), dtype=dtype, device=device)
        self.b_out = full((d,), 0.0, dtype=dtype, device=device)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ p.w_in.to(x.dtype) + p.b_in.to(x.dtype), approximate="tanh")
    return h @ p.w_out.to(x.dtype) + p.b_out.to(x.dtype)
