"""Public op: fused score→top-k with padding/active-list plumbing.

``knn_topk(r_block, s_block, ...)`` merges one S block into a running
top-k state without materializing the score matrix: densify into
dim-tiles, derive the active tile lists from occupancy, and run the fused
kernel.  The engine's cached query path skips this op and calls
``knn_topk_fused`` directly on S tiles stacked once at build time (one
launch covers every S block).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topk import TopKState, init_topk, min_prune_score, pad_topk_state
from repro_torch.device import resolve_device
from repro_torch.kernels.knn_score.ops import _pad_rows, active_lists, dense_tiles_with_sentinel
from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
from repro_torch.sparse.format import SparseBatch, tile_occupancy


def pad_state(state: TopKState, n_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a (N, k) top-k state to ``n_pad`` rows with empty (-inf, -1) slots."""
    padded = pad_topk_state(state, n_pad)
    return padded.scores, padded.ids


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
    earlier blocks' results."""
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
    out_s, out_i, _ = knn_topk_fused(
        r_tiles, s_tiles, active, valid, ids, init_s, init_i,
        thr=thr, nr_valid=torch.full((1,), n_r, dtype=torch.int32, device=dev),
        block_r=block_r, block_s=block_s,
    )
    return TopKState(scores=out_s[:n_r], ids=out_i[:n_r])
