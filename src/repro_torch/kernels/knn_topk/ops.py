"""Public op: fused score→top-k with padding/active-list plumbing.

``knn_topk(r_block, s_block, ...)`` merges one S block into a running
top-k state without materializing the score matrix: densify into
dim-tiles, derive the active tile lists from occupancy, and run the fused
kernel.  The engine's cached query path skips this op and calls
``knn_topk_fused`` directly on S tiles stacked once at build time (one
launch covers every S block).

The fused kernel holds at most ``MAX_K`` (128) slots a row.  For a larger
k both go through ``join_topk`` to ``score_then_merge`` instead: the score
kernel, the candidate mask and the merge kernel over windows of S, which
give the fused kernel's outputs bit for bit.  The route is chosen by k
alone, on every device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topk import TopKState, init_topk, min_prune_score, pad_topk_state
from repro_torch.device import resolve_device
from repro_torch.kernels.knn_score.kernel import knn_score_cuda
from repro_torch.kernels.knn_score.ops import _pad_rows, active_lists, dense_tiles_with_sentinel
from repro_torch.kernels.knn_topk.kernel import MAX_K, knn_topk_fused
from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
from repro_torch.sparse.format import SparseBatch, tile_occupancy

MAX_SCORES = 1 << 24     # f32 scores a score_then_merge window holds (64 MiB, the
                         # planner's pair budget, core/engine.py PAIR_BUDGET)


def pad_state(state: TopKState, n_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a (N, k) top-k state to ``n_pad`` rows with empty (-inf, -1) slots."""
    padded = pad_topk_state(state, n_pad)
    return padded.scores, padded.ids


def score_then_merge(r_tiles, s_tiles, active, s_valid, s_ids, init_scores, init_ids,
                     block_r: int = 256, block_s: int = 256, max_scores: int = MAX_SCORES):
    """((NR, k) scores, (NR, k) ids) of ``knn_topk_fused`` on the same
    arrays, for any k.  S is walked in windows of whole S blocks, at most
    ``max_scores`` scores each: ``knn_score_cuda`` on the window (read in
    place from the stack), the candidate mask (score > 0 and ``s_valid``),
    then ``topk_merge_cuda`` inserting its columns into the running state,
    windows in S order.  Bit-identical to the fused kernel: the two score
    kernels share one ``fmaf`` chain (``csrc/score_tile.cuh``) and both
    merges insert in S order with incumbents winning ties.  No threshold:
    it only skips candidates that cannot enter."""
    n_r, n_s = r_tiles.shape[1], s_tiles.shape[1]
    width = max(1, max_scores // (n_r * block_s)) * block_s
    out_s, out_i = init_scores, init_ids
    for c0 in range(0, n_s, width):
        c1 = min(c0 + width, n_s)
        scores = knn_score_cuda(r_tiles, s_tiles[:, c0:c1],
                                active[:, c0 // block_s : c1 // block_s].contiguous(),
                                block_r=block_r, block_s=block_s)
        cand = torch.where((scores > 0) & (s_valid[:, c0:c1] > 0), scores, float("-inf"))
        out_s, out_i = topk_merge_cuda(out_s, out_i, cand, s_ids[0, c0:c1])
    return out_s, out_i


def join_topk(r_tiles, s_tiles, active, s_valid, s_ids, init_scores, init_ids, thr=None,
              nr_valid=None, block_r: int = 256, block_s: int = 256):
    """((NR, k) scores, (NR, k) ids) of ``knn_topk_fused`` on these
    arguments: the fused kernel for k <= ``MAX_K``, ``score_then_merge``
    for a larger k."""
    if init_scores.shape[1] > MAX_K:
        return score_then_merge(r_tiles, s_tiles, active, s_valid, s_ids, init_scores,
                                init_ids, block_r=block_r, block_s=block_s)
    return knn_topk_fused(r_tiles, s_tiles, active, s_valid, s_ids, init_scores, init_ids,
                          thr=thr, nr_valid=nr_valid, block_r=block_r, block_s=block_s)[:2]


def column_meta(
    n_valid: int, n_pad: int, s_offset: int = 0, s_valid: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((1, n_pad) valid int32, (1, n_pad) global-id int32) column metadata,
    on ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    valid = np.zeros(n_pad, np.int32)
    if s_valid is None:
        valid[:n_valid] = 1
    else:
        valid[:n_valid] = np.asarray(s_valid, np.int32)[:n_valid]
    ids = np.full(n_pad, -1, np.int32)
    ids[:n_valid] = s_offset + np.arange(n_valid, dtype=np.int32)
    return (torch.as_tensor(valid[None, :], device=device),
            torch.as_tensor(ids[None, :], device=device))


def knn_topk(
    r_block: SparseBatch,
    s_block: SparseBatch,
    k: Optional[int] = None,
    state: Optional[TopKState] = None,
    s_offset: int = 0,
    s_valid: Optional[np.ndarray] = None,
    tile: int = 128,
    block_r: int = 256,
    block_s: int = 256,
    device=None,
) -> TopKState:
    """Merge B_s's candidates into ``state`` (or a fresh k-state) on
    ``device`` (CUDA unless named); the blocks and the state are moved
    there.  The carried state's MinPruneScore seeds the kernel's
    threshold, so a chained stream of S blocks prunes later blocks with the
    earlier blocks' results (``join_topk``: k > ``MAX_K`` takes
    ``score_then_merge``)."""
    if r_block.dim != s_block.dim:
        raise ValueError(f"dim mismatch: {r_block.dim} vs {s_block.dim}")
    dev = resolve_device(device)
    r_block, s_block = r_block.to(dev), s_block.to(dev)
    n_r, n_s = r_block.num_vectors, s_block.num_vectors
    if state is None:
        if k is None:
            raise ValueError("pass k or an initial state")
        state = init_topk(n_r, k, device=dev)
    else:
        state = TopKState(state.scores.to(dev), state.ids.to(dev))

    thr = min_prune_score(state).reshape(1, 1)   # lower-bounds every row's k-th
    r_tiles = _pad_rows(dense_tiles_with_sentinel(r_block, tile), block_r)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(s_block, tile), block_s)
    nr_pad, ns_pad = r_tiles.shape[1], s_tiles.shape[1]
    r_occ = tile_occupancy(r_block, tile).cpu().numpy()
    s_occ = tile_occupancy(s_block, tile).cpu().numpy()
    active = torch.as_tensor(active_lists(r_occ, s_occ, block_r, block_s), device=dev)
    valid, ids = column_meta(n_s, ns_pad, s_offset=s_offset, s_valid=s_valid, device=dev)
    init_s, init_i = pad_state(state, nr_pad)
    out_s, out_i = join_topk(
        r_tiles, s_tiles, active, valid, ids, init_s, init_i,
        thr=thr, nr_valid=torch.full((1,), n_r, dtype=torch.int32, device=dev),
        block_r=block_r, block_s=block_s,
    )
    return TopKState(scores=out_s[:n_r], ids=out_i[:n_r])
