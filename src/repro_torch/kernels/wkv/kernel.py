"""Chunked RWKV6 time mixing (WKV): the CUDA kernel's wrapper.

``wkv_cuda`` takes the arguments of the JAX package's ``wkv_pallas``:
r, k, v and lw (BH, T, K), u (BH, K) and the chunk.  T need not be a
multiple of the chunk: the kernel reads tokens past T as zeros, as the
reference's padding.  On CUDA tensors it launches the hand-written kernel
of ``../csrc/wkv.cu``; on CPU tensors it runs the plain version
(``ref.wkv_plain``).  Nothing falls back: a CUDA tensor that the kernel
cannot take raises.  ``wkv_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, launch
from repro_torch.kernels.wkv.ref import wkv_plain

HEAD_SIZES = (16, 32, 64)
CHUNKS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5


def wkv_cuda(
    r: torch.Tensor,    # (BH, T, K) f32 or bf16
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,   # (BH, T, K) log decays, ≤ 0
    u: torch.Tensor,    # (BH, K) f32 per-head bonus
    chunk: int = 128,
) -> torch.Tensor:
    """(BH, T, K) outputs in r.dtype, computed in f32."""
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, lw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_cuda runs on cuda or cpu tensors, got {r.device}")
    dev = r.device
    if r.dim() != 3:
        raise ValueError("r, k, v and lw must be 3-d: (BH, T, K)")
    bh, t, kk = r.shape
    if kk not in HEAD_SIZES:
        raise ValueError(f"head size {kk} is not one the kernel takes: {HEAD_SIZES}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} is not one the kernel takes: {CHUNKS}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"r has dtype {r.dtype}; the kernel takes float32 or bfloat16")
    for name, x in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        check(name, x, r.dtype, (bh, t, kk), dev)
    check("u", u, torch.float32, (bh, kk), dev)
    if any(x.data_ptr() % 16 for x in (r, k, v, lw, u)):
        raise ValueError("r, k, v, lw and u must start on a 16-byte boundary")

    out = torch.empty_like(r)
    if bh * t == 0:
        return out
    launch("wkv", _ARGTYPES, dev,
           r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
           out.data_ptr(), _DTYPES[r.dtype], bh, t, kk, chunk)
    wkv_cuda.launches += 1
    return out


wkv_cuda.launches = 0
