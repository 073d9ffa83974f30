"""Tile-skipping blocked score matmul: the CUDA kernel's wrapper.

``knn_score_cuda`` takes the same arrays as the JAX package's
``knn_score_pallas`` (layout in ``ops.py``) and returns the (NR, NS) f32
scores.  On CUDA tensors it launches the hand-written kernel of
``../csrc/knn_score.cu``; on CPU tensors it runs the plain version
(``ref.knn_score_plain``).  Nothing falls back: a CUDA tensor that the
kernel cannot take raises.  ``s_tiles`` may be a column slice
``stack[:, c0:c1]`` of a contiguous stack, read in place.
``knn_score_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, launch
from repro_torch.kernels.knn_score.ref import knn_score_plain

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 10


def knn_score_cuda(
    r_tiles: torch.Tensor,   # (T+1, NR, tile) f32 — sentinel tile last, all zeros
    s_tiles: torch.Tensor,   # (T+1, NS, tile) f32, or a column slice of a larger stack
    active: torch.Tensor,    # (nR, nS, A) int32, ascending, sentinel T padding
    block_r: int = 256,
    block_s: int = 256,
) -> torch.Tensor:
    """(NR, NS) scores.  NR % block_r == NS % block_s == 0 (the op pads)."""
    if r_tiles.device.type == "cpu":
        return knn_score_plain(r_tiles, s_tiles, active, block_r=block_r, block_s=block_s)
    if r_tiles.device.type != "cuda":
        raise ValueError(f"knn_score_cuda runs on cuda or cpu tensors, got {r_tiles.device}")
    dev = r_tiles.device
    if r_tiles.dim() != 3 or s_tiles.dim() != 3 or active.dim() != 3:
        raise ValueError("r_tiles, s_tiles and active must be 3-d")
    t1, n_r, tile = r_tiles.shape
    n_s = s_tiles.shape[1]
    if block_r < 1 or block_s < 1:
        raise ValueError("block_r and block_s must be positive")
    if n_r < 1 or n_r % block_r or n_s < 1 or n_s % block_s:
        raise ValueError(f"NR={n_r} and NS={n_s} must be positive multiples of "
                         f"block_r={block_r} and block_s={block_s}")
    n_rb, n_sb = n_r // block_r, n_s // block_s
    check("r_tiles", r_tiles, torch.float32, (t1, n_r, tile), dev)
    # s_tiles: contiguous, or a column slice of a contiguous stack (s_ld rows a tile)
    check("s_tiles", s_tiles[:, :0], torch.float32, (t1, 0, tile), dev)
    s_ld, rem = divmod(s_tiles.stride(0), tile)
    if s_tiles.stride()[1:] != (tile, 1) or rem or s_ld < n_s:
        raise ValueError("s_tiles must be contiguous or a column slice of a contiguous stack, "
                         f"got strides {s_tiles.stride()}")
    check("active", active, torch.int32, (n_rb, n_sb, active.shape[2]), dev)
    if tile % 4 or r_tiles.data_ptr() % 16 or s_tiles.data_ptr() % 16:
        raise ValueError("the kernel reads 16 bytes at a time: tile must be a multiple of 4 "
                         f"(got {tile}) and r_tiles, s_tiles 16-byte aligned")

    out = torch.empty((n_r, n_s), dtype=torch.float32, device=dev)
    launch("knn_score", _ARGTYPES, dev,
           r_tiles.data_ptr(), s_tiles.data_ptr(), active.data_ptr(), out.data_ptr(),
           t1, n_r, n_s, s_ld, tile, n_rb, n_sb, active.shape[2], block_r, block_s)
    knn_score_cuda.launches += 1
    return out


knn_score_cuda.launches = 0
