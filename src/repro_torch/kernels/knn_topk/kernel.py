"""Fused tile-skipping score → streaming top-k: the CUDA kernel's wrapper.

``knn_topk_fused`` takes the same arrays as the JAX package's
``knn_topk_pallas`` (layout in that module's docstring) and returns
((NR, k) scores, (NR, k) ids, (nR, 1) MinPruneScore per R block).  On CUDA
tensors it launches the hand-written kernel of ``../csrc/knn_topk.cu``; on
CPU tensors it runs the plain version (``ref.knn_topk_plain``).  Nothing
falls back: a CUDA tensor that the kernel cannot take raises.

The kernel splits the S walk: pass 1 scores and selects on a grid of
(128-row R tiles) x (P ranges of 128-column tiles), each range from an
empty state; pass 2 merges the P partial states in S order onto the init
state.  ``split_ranges`` picks P from the card's SM count.  Both passes
run in one wrapper call, counted once.

The kernel is built by ``kernels/_build.py`` (``nvcc`` for ``sm_90a``, a
plain C interface loaded with ``ctypes``) at its first use.
``knn_topk_fused.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, launch
from repro_torch.kernels.knn_topk.ref import knn_topk_plain

MAX_K = 128
MAX_BLOCK_R = 256
TILE_ROWS = 128          # rows of a pass-1 CTA (csrc/score_tile.cuh kTile)
CTAS_PER_SM = 2          # pass 1's occupancy aim
_ARGTYPES = (ctypes.c_void_p,) * 15 + (ctypes.c_int,) * 12


def split_ranges(n_rb: int, n_sb: int, block_r: int, block_s: int, n_sm: int):
    """(P ranges, column tiles a range) for pass 1: S cut into runs of
    128-column tiles.  A CTA takes one R tile and one range, CTAS_PER_SM of
    them fit an SM, so the time goes as waves x tiles a range; take the run
    length that minimises it, the longest among equals (fewer partial
    states to merge)."""
    r_tiles = n_rb * -(-block_r // TILE_ROWS)
    n_ct = n_sb * -(-block_s // TILE_ROWS)
    slots = CTAS_PER_SM * n_sm

    def cost(run):
        return -(-r_tiles * -(-n_ct // run) // slots) * run, -run

    run = min(range(1, n_ct + 1), key=cost)
    return -(-n_ct // run), run


def knn_topk_fused(
    r_tiles: torch.Tensor,      # (T+1, NR, tile) f32 — sentinel tile last, all zeros
    s_tiles: torch.Tensor,      # (T+1, NS, tile) f32
    active: torch.Tensor,       # (nR, nS, A) int32, ascending, sentinel T padding
    s_valid: torch.Tensor,      # (1, NS) int32
    s_ids: torch.Tensor,        # (1, NS) int32
    init_scores: torch.Tensor,  # (NR, k) f32
    init_ids: torch.Tensor,     # (NR, k) int32
    thr: torch.Tensor | None = None,       # (1, 1) f32 seed MinPruneScore
    nr_valid: torch.Tensor | None = None,  # (1,) int32 real R rows
    block_r: int = 256,
    block_s: int = 256,
):
    """((NR, k) scores, (NR, k) ids, (nR, 1) MinPruneScore per R block).
    NR % block_r == NS % block_s == 0 (the callers pad).

    Contract of the split walk: ``thr`` is at most the initial k-th score of
    every row < ``nr_valid`` (the init state's MinPruneScore, as every
    caller passes), and rows >= ``nr_valid`` are padding that is never
    offered (empty R rows score 0), so they stay as initialised.  Under it,
    the split walk gives the sequential walk's outputs bit for bit (the
    kernel's first, sequential design: ``csrc/legacy/knn_topk_v1.cu``)."""
    if r_tiles.device.type == "cpu":
        return knn_topk_plain(r_tiles, s_tiles, active, s_valid, s_ids, init_scores,
                              init_ids, thr=thr, nr_valid=nr_valid,
                              block_r=block_r, block_s=block_s)
    if r_tiles.device.type != "cuda":
        raise ValueError(f"knn_topk_fused runs on cuda or cpu tensors, got {r_tiles.device}")
    dev = r_tiles.device
    t1, n_r, tile = r_tiles.shape
    n_s = s_tiles.shape[1]
    k = init_scores.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}] for the fused kernel, got {k}; a larger k "
                         "takes knn_topk.ops.score_then_merge (knn_score_cuda, the candidate "
                         "mask, topk_merge_cuda), as SparseKNNIndex and knn_topk do")
    if not 1 <= block_r <= MAX_BLOCK_R or block_s < 1:
        raise ValueError(f"block_r must be in [1, {MAX_BLOCK_R}] and block_s >= 1")
    if n_r < 1 or n_r % block_r or n_s < 1 or n_s % block_s:
        raise ValueError(f"NR={n_r} and NS={n_s} must be positive multiples of "
                         f"block_r={block_r} and block_s={block_s}")
    n_rb, n_sb = n_r // block_r, n_s // block_s
    if thr is None:
        thr = torch.full((1, 1), float("-inf"), dtype=torch.float32, device=dev)
    if nr_valid is None:
        nr_valid = torch.full((1,), n_r, dtype=torch.int32, device=dev)
    check("r_tiles", r_tiles, torch.float32, (t1, n_r, tile), dev)
    check("s_tiles", s_tiles, torch.float32, (t1, n_s, tile), dev)
    if active.dim() != 3:
        raise ValueError("active must be (nR, nS, A)")
    check("active", active, torch.int32, (n_rb, n_sb, active.shape[2]), dev)
    check("s_valid", s_valid, torch.int32, (1, n_s), dev)
    check("s_ids", s_ids, torch.int32, (1, n_s), dev)
    check("init_scores", init_scores, torch.float32, (n_r, k), dev)
    check("init_ids", init_ids, torch.int32, (n_r, k), dev)
    check("thr", thr.reshape(1, 1), torch.float32, (1, 1), dev)
    check("nr_valid", nr_valid.reshape(1), torch.int32, (1,), dev)
    if tile % 4 or r_tiles.data_ptr() % 16 or s_tiles.data_ptr() % 16:
        raise ValueError("the kernel reads 16 bytes at a time: tile must be a multiple of 4 "
                         f"(got {tile}) and r_tiles, s_tiles 16-byte aligned")

    n_ranges, range_len = split_ranges(n_rb, n_sb, block_r, block_s,
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
    part_s = torch.empty((n_r, n_ranges, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_r, n_ranges, k), dtype=torch.int32, device=dev)
    offered = torch.empty((n_rb * -(-block_r // TILE_ROWS), n_ranges), dtype=torch.int32,
                          device=dev)
    out_s = torch.empty((n_r, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_r, k), dtype=torch.int32, device=dev)
    thr_out = torch.empty((n_rb, 1), dtype=torch.float32, device=dev)
    launch("knn_topk", _ARGTYPES, dev,
           r_tiles.data_ptr(), s_tiles.data_ptr(), active.data_ptr(), s_valid.data_ptr(),
           s_ids.data_ptr(), init_scores.data_ptr(), init_ids.data_ptr(), thr.data_ptr(),
           nr_valid.data_ptr(), part_s.data_ptr(), part_i.data_ptr(), offered.data_ptr(),
           out_s.data_ptr(), out_i.data_ptr(), thr_out.data_ptr(),
           t1, n_r, n_s, tile, n_rb, n_sb, active.shape[2], k, block_r, block_s,
           n_ranges, range_len)
    knn_topk_fused.launches += 1
    return out_s, out_i, thr_out


knn_topk_fused.launches = 0
