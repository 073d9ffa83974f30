"""Flash attention: the CUDA kernel's wrapper.

``flash_attention_cuda`` takes the arguments of the JAX package's
``flash_attention_pallas``: q (BH, Sq, hd), k and v (BH, Skv, hd),
``causal``, ``sm_scale`` and ``window``; k and v may also hold BH / g
heads, query head i reading kv head i // g (GQA without repeating kv).
Sq and Skv may be any length.  On CUDA tensors it launches the
hand-written kernels of ``../csrc/flash_attn.cu``, both on the tensor
cores: f32 in 3xTF32 (each f32 product as three TF32 ``mma.sync``
products, to f32's accuracy), bf16 as bf16 x bf16 with f32 accumulators
(the Pallas kernel's products).  The kernels take head widths
``KERNEL_WIDTHS``; any other width up to 256 is zero-padded to the next of
them (``pad_head_width``: zero columns add an exact 0 to every score and
give zero output columns, which are cut off; ``sm_scale`` stays the
caller's), at the cost of one copy of q, k, v and the output.  On CPU
tensors it runs the plain version (``ref.flash_attention_plain``).
Nothing falls back: a CUDA tensor that the kernels cannot take raises.
``flash_attention_cuda.launches`` counts the launches of both kernels,
``.f32_mma_launches`` those of the 3xTF32 kernel and ``.bf16_launches``
those of the bf16 kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, launch
from repro_torch.kernels.flash_attn.ref import flash_attention_plain

KERNEL_WIDTHS = (16, 32, 64, 128, 256)
MAX_HEAD_DIM = KERNEL_WIDTHS[-1]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535   # CUDA's limit on gridDim.y, the query tiles'; gridDim.x (BH) is 2^31 - 1
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_float,)


def query_tile(width: int, dtype: torch.dtype) -> int:
    """Query rows a CTA of the kernel at ``width`` takes (``Cfg<HD>::BQ``):
    the grid is (BH, ceil(Sq / query_tile))."""
    return 64 if dtype == torch.bfloat16 and width == 256 else 128


def kernel_width(hd: int) -> int:
    """The head width a kernel runs ``hd`` at: the least of KERNEL_WIDTHS ≥ hd."""
    for w in KERNEL_WIDTHS:
        if hd <= w:
            return w
    raise ValueError(f"head width {hd} exceeds the kernels' largest, {MAX_HEAD_DIM}")


def pad_head_width(x: torch.Tensor, width: int) -> torch.Tensor:
    """(..., hd) -> (..., width), zero columns after the hd real ones."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head width {hd} is not one the kernels take: 1 to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if kvh < 1 or bh % kvh:
        raise ValueError(f"q's {bh} heads are not a multiple of k's {kvh}")
    check("q", q, q.dtype, (bh, sq, hd), dev)
    check("k", k, q.dtype, (kvh, skv, hd), dev)
    check("v", v, q.dtype, (kvh, skv, hd), dev)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")

    width = kernel_width(hd)
    q_tiles = -(-sq // query_tile(width, q.dtype))
    if q_tiles > MAX_GRID_Y:
        raise ValueError(f"Sq={sq} makes {q_tiles} query tiles, past the kernel grid's "
                         f"gridDim.y limit ({MAX_GRID_Y:,}); BH is gridDim.x and takes any "
                         "int32 count")
    if width != hd:
        q, k, v = (pad_head_width(x, width) for x in (q, k, v))
    out = torch.empty_like(q)
    if bh * sq:
        launch("flash_attn", _ARGTYPES, dev,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               _DTYPES[q.dtype], bh, sq, skv, width, bh // kvh, int(bool(causal)), int(window),
               float(sm_scale))
        flash_attention_cuda.launches += 1
        if q.dtype == torch.bfloat16:
            flash_attention_cuda.bf16_launches += 1
        else:
            flash_attention_cuda.f32_mma_launches += 1
    return out[..., :hd].contiguous()   # out itself when nothing was padded


flash_attention_cuda.launches = 0
flash_attention_cuda.f32_mma_launches = 0
flash_attention_cuda.bf16_launches = 0
