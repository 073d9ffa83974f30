"""Dim-tile helpers of the tile index (the subset the fused-kernel join runs)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.format import DEFAULT_TILE, SparseBatch, num_tiles


def dense_r_tiles(r_block: SparseBatch, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """(T, |Br|, tile) dense dim-tiles of a block, on the block's device.

    One scatter-add into a zeroed row per vector; padding entries land in
    a discard slot past the last tile.  A row holds each dim at most once,
    so every slot receives at most one value and the result is exact and
    deterministic on CUDA too.
    """
    n = r_block.num_vectors
    d = r_block.dim
    t_total = num_tiles(d, tile)
    idx = r_block.indices.long()
    valid = idx < d
    slot = torch.where(valid, idx, torch.full_like(idx, t_total * tile))
    out = torch.zeros((n, t_total * tile + 1), dtype=torch.float32, device=idx.device)
    out.scatter_add_(1, slot, torch.where(valid, r_block.values.float(), 0.0))
    return out[:, : t_total * tile].reshape(n, t_total, tile).transpose(0, 1).contiguous()


def active_tile_list(occ_any: np.ndarray, bucket: int = 8) -> np.ndarray:
    """Host-side: the tiles with any R-block mass, padded with the sentinel
    tile id to a bucket multiple."""
    (tiles,) = np.nonzero(occ_any)
    n_tiles = occ_any.shape[0]
    pad = -(-max(len(tiles), 1) // bucket) * bucket
    out = np.full(pad, n_tiles, dtype=np.int32)
    out[: len(tiles)] = tiles
    return out
