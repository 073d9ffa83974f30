"""Flash attention: the CUDA kernel's wrapper.

``flash_attention_cuda`` takes the arguments of the JAX package's
``flash_attention_pallas``: q (BH, Sq, hd), k and v (BH, Skv, hd),
``causal``, ``sm_scale`` and ``window``; k and v may also hold BH / g
heads, query head i reading kv head i // g (GQA without repeating kv).
No padding: Sq and Skv may be any length.  On CUDA tensors it launches the
hand-written kernels of ``../csrc/flash_attn.cu``: f32 in fp32 FMAs
(``flash_attn_simt.cuh``), bf16 on the tensor cores (``mma.sync``
bf16 x bf16 with f32 accumulators, as the Pallas kernel's products).  On
CPU tensors it runs the plain version (``ref.flash_attention_plain``).
Nothing falls back: a CUDA tensor that the kernels cannot take raises.
``flash_attention_cuda.launches`` counts the launches of both kernels,
``flash_attention_cuda.bf16_launches`` those of the tensor-core kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, launch
from repro_torch.kernels.flash_attn.ref import flash_attention_plain

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_float,)


def flash_attention_cuda(
    q: torch.Tensor,   # (BH, Sq, hd) f32 or bf16
    k: torch.Tensor,   # (BH / g, Skv, hd), q's dtype
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float = 1.0,
    window: int = 0,
) -> torch.Tensor:
    """(BH, Sq, hd) in q.dtype: softmax(q kᵀ · sm_scale, masked) v."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda runs on cuda or cpu tensors, got {q.device}")
    dev = q.device
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("q, k and v must be 3-d: (BH, S, hd)")
    bh, sq, hd = q.shape
    kvh, skv = k.shape[0], k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one the kernel takes: {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if kvh < 1 or bh % kvh:
        raise ValueError(f"q's {bh} heads are not a multiple of k's {kvh}")
    check("q", q, q.dtype, (bh, sq, hd), dev)
    check("k", k, q.dtype, (kvh, skv, hd), dev)
    check("v", v, q.dtype, (kvh, skv, hd), dev)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the kernel's grid (65,535)")

    out = torch.empty_like(q)
    if bh * sq == 0:
        return out
    launch("flash_attn", _ARGTYPES, dev,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           _DTYPES[q.dtype], bh, sq, skv, hd, bh // kvh, int(bool(causal)), int(window),
           float(sm_scale))
    flash_attention_cuda.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_cuda.bf16_launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.bf16_launches = 0
