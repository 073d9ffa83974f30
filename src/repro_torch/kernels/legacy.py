"""Launchers of the first CUDA designs of knn_topk, knn_score,
flash_attn (f32 and bf16), wkv and topk_merge's k <= 128 path
(``csrc/legacy/*_v1.cu``: one CTA per 256-row group walking S in order; a
CTA per 64 x 64 sub-tile with a 4 x 4 micro-tile; fp32 FMAs, bf16
converted at load; one CTA per b·h walking its chunks in order; one warp
a row).  On no path of the port: ``chip_smoke.py`` and the card tests run
them at the engine's and the models' shapes, to show that the present
kernels give bit for bit their outputs (flash_attn aside) and to
time each beside the design that replaced it.  They take the arguments of
``knn_topk_fused``, ``knn_score_cuda``, ``flash_attention_cuda``,
``wkv_cuda`` and ``topk_merge_cuda`` on CUDA tensors that those wrappers
have already checked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import launch

_TOPK_ARGTYPES = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 10
_SCORE_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9
_FLASH_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_float,)
_WKV_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5
_MERGE_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def knn_topk_v1(r_tiles, s_tiles, active, s_valid, s_ids, init_scores, init_ids, thr,
                nr_valid, block_r, block_s):
    """The sequential design's ((NR, k) scores, (NR, k) ids, (nR, 1) thr)."""
    dev = r_tiles.device
    t1, n_r, tile = r_tiles.shape
    n_s, k = s_tiles.shape[1], init_scores.shape[1]
    n_rb, n_sb = n_r // block_r, n_s // block_s
    out_s = torch.empty((n_r, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_r, k), dtype=torch.int32, device=dev)
    thr_out = torch.empty((n_rb, 1), dtype=torch.float32, device=dev)
    launch("knn_topk_v1", _TOPK_ARGTYPES, dev,
           r_tiles.data_ptr(), s_tiles.data_ptr(), active.data_ptr(), s_valid.data_ptr(),
           s_ids.data_ptr(), init_scores.data_ptr(), init_ids.data_ptr(), thr.data_ptr(),
           nr_valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), thr_out.data_ptr(),
           t1, n_r, n_s, tile, n_rb, n_sb, active.shape[2], k, block_r, block_s)
    return out_s, out_i, thr_out


def knn_score_v1(r_tiles, s_tiles, active, block_r, block_s):
    """The 64 x 64 sub-tile design's (NR, NS) scores."""
    dev = r_tiles.device
    t1, n_r, tile = r_tiles.shape
    n_s = s_tiles.shape[1]
    out = torch.empty((n_r, n_s), dtype=torch.float32, device=dev)
    launch("knn_score_v1", _SCORE_ARGTYPES, dev,
           r_tiles.data_ptr(), s_tiles.data_ptr(), active.data_ptr(), out.data_ptr(),
           t1, n_r, n_s, tile, n_r // block_r, n_s // block_s, active.shape[2], block_r, block_s)
    return out


def flash_attn_v1(q, k, v, causal=True, sm_scale=1.0, window=0):
    """The fp32-FMA design's (BH, Sq, hd) output in q.dtype (f32 or bf16);
    hd 32, 64, 128 or 256."""
    bh, sq, hd = q.shape
    out = torch.empty_like(q)
    launch("flash_attn_v1", _FLASH_ARGTYPES, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
           bh, sq, k.shape[1], hd, bh // k.shape[0], int(bool(causal)), int(window),
           float(sm_scale))
    return out


def wkv_v1(r, k, v, lw, u, chunk=128):
    """The sequential design's (BH, T, K) output in r.dtype."""
    bh, t, kk = r.shape
    out = torch.empty_like(r)
    launch("wkv_v1", _WKV_ARGTYPES, r.device,
           r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
           out.data_ptr(), _DTYPES[r.dtype], bh, t, kk, chunk)
    return out


def topk_merge_v1(state_scores, state_ids, cand_scores, cand_ids):
    """The warp-a-row design's ((N, k) scores, (N, k) ids); k <= 128."""
    n, k = state_scores.shape
    m = cand_scores.shape[1]
    out_s = torch.empty_like(state_scores)
    out_i = torch.empty_like(state_ids)
    launch("topk_merge_v1", _MERGE_ARGTYPES, state_scores.device,
           state_scores.data_ptr(), state_ids.data_ptr(), cand_scores.data_ptr(),
           cand_ids.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), n, k, m,
           0 if cand_ids.dim() == 1 else m)
    return out_s, out_i
