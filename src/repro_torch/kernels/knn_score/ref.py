"""Plain PyTorch version of the tile-skipping score kernel, and the dense
oracle.

out[i, j] = Σ over the active list of block pair (i // block_r, j //
block_s) of dot(r_tiles[t, i], s_tiles[t, j]).  When the lists cover every
tile occupied by both blocks, this equals the dense dot product.
"""
from __future__ import annotations

import torch


def knn_score_plain(
    r_tiles: torch.Tensor,   # (T+1, NR, tile) f32 — sentinel tile last, all zeros
    s_tiles: torch.Tensor,   # (T+1, NS, tile) f32
    active: torch.Tensor,    # (nR, nS, A) int32
    block_r: int = 256,
    block_s: int = 256,
) -> torch.Tensor:
    """(NR, NS) f32 scores; per block pair one batched product over the
    pair's list, summed over the list."""
    n_r, n_s = r_tiles.shape[1], s_tiles.shape[1]
    out = torch.empty((n_r, n_s), dtype=torch.float32, device=r_tiles.device)
    act = active.long()
    for bi, i0 in enumerate(range(0, n_r, block_r)):
        rt_all = r_tiles[:, i0 : i0 + block_r]
        for bj, j0 in enumerate(range(0, n_s, block_s)):
            tiles = act[bi, bj]
            prod = torch.bmm(rt_all[tiles], s_tiles[tiles, j0 : j0 + block_s].transpose(1, 2))
            out[i0 : i0 + block_r, j0 : j0 + block_s] = prod.sum(dim=0)
    return out


def dense_oracle(r_tiles: torch.Tensor, s_tiles: torch.Tensor) -> torch.Tensor:
    """Full dense dot product (the sentinel tile is all zeros, so including
    it is safe)."""
    r = r_tiles.transpose(0, 1).reshape(r_tiles.shape[1], -1)
    s = s_tiles.transpose(0, 1).reshape(s_tiles.shape[1], -1)
    return (r @ s.T).float()
