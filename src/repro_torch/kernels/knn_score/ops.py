"""Public op: tile-skipping KNN scoring, with the tile plumbing shared by
the tile-skipping kernels: row padding, dense dim-tiles with a zero
sentinel tile, and the per-(R block, S block) active tile lists.

``knn_score(r_block, s_block)`` densifies two SparseBatches into
dim-tiles, derives the active tile lists from occupancy on the host, and
runs the score kernel (``kernel.knn_score_cuda``) on the op's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.knn_score.kernel import knn_score_cuda
from repro_torch.sparse.format import SparseBatch, tile_occupancy


def _pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[1]
    target = -(-n // block) * block
    if target == n:
        return x
    pad = torch.zeros((x.shape[0], target - n, x.shape[2]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def dense_tiles_with_sentinel(batch: SparseBatch, tile: int) -> torch.Tensor:
    """(T+1, N, tile4) — dense dim-tiles plus a trailing zero sentinel tile.

    Each tile's width is ``tile`` rounded up to a multiple of 4 with zero
    dims (tile4 == tile when tile % 4 == 0): the CUDA kernels read rows 16
    bytes at a time, and a zero dim adds exactly nothing to a score.  The
    tile index itself (occupancy, active lists) keeps ``tile``."""
    from repro_torch.core.index import dense_r_tiles

    t = dense_r_tiles(batch, tile)                 # (T, N, tile)
    return torch.nn.functional.pad(t, (0, -tile % 4, 0, 0, 0, 1))


def active_lists(
    r_occ: np.ndarray,  # (NR, T) bool occupancy
    s_occ: np.ndarray,  # (NS, T)
    block_r: int,
    block_s: int,
    bucket: int = 8,
) -> np.ndarray:
    """(nR, nS, A) int32 — tiles occupied by BOTH blocks, sentinel-padded.

    Host-side: the list lengths are data-dependent (this is the point — the
    kernel's work is proportional to them), so they are materialized
    concretely and bucketed to bound recompilation.

    Fully vectorized: one block-level any-reduce per side, one broadcast
    intersection, and a stable argsort to pack the occupied tile ids to the
    front of each list (ascending, exactly the nonzero order).  The former
    pure-Python O(nR·nS·T) nested loop dominated setup for large block
    grids.
    """
    t_total = r_occ.shape[1]

    def block_any(occ: np.ndarray, block: int) -> np.ndarray:
        n_blocks = -(-occ.shape[0] // block)
        padded = np.zeros((n_blocks * block, t_total), dtype=bool)
        padded[: occ.shape[0]] = occ
        return padded.reshape(n_blocks, block, t_total).any(axis=1)

    r_any = block_any(r_occ, block_r)                       # (nR, T)
    s_any = block_any(s_occ, block_s)                       # (nS, T)
    both = r_any[:, None, :] & s_any[None, :, :]            # (nR, nS, T)
    counts = both.sum(axis=-1)                              # (nR, nS)
    a_len = -(-max(int(counts.max(initial=1)), 1) // bucket) * bucket
    # stable argsort on ~both packs occupied tiles first, ascending tile id
    packed = np.argsort(~both, axis=-1, kind="stable").astype(np.int32)
    slot = np.arange(t_total, dtype=np.int32)
    packed = np.where(slot[None, None, :] < counts[..., None], packed, t_total)
    out = np.full((both.shape[0], both.shape[1], a_len), t_total, dtype=np.int32)
    w = min(a_len, t_total)
    out[:, :, :w] = packed[:, :, :w]
    return out


def knn_score(
    r_block: SparseBatch,
    s_block: SparseBatch,
    tile: int = 128,
    block_r: int = 256,
    block_s: int = 256,
    device=None,
) -> torch.Tensor:
    """(|Br|, |Bs|) exact dot-product scores via the tile-skipping kernel,
    on ``device`` (CUDA unless named); the blocks are moved there."""
    if r_block.dim != s_block.dim:
        raise ValueError(f"dim mismatch: {r_block.dim} vs {s_block.dim}")
    dev = resolve_device(device)
    r_block, s_block = r_block.to(dev), s_block.to(dev)
    r_tiles = _pad_rows(dense_tiles_with_sentinel(r_block, tile), block_r)
    s_tiles = _pad_rows(dense_tiles_with_sentinel(s_block, tile), block_s)
    r_occ = tile_occupancy(r_block, tile).cpu().numpy()
    s_occ = tile_occupancy(s_block, tile).cpu().numpy()
    active = torch.as_tensor(active_lists(r_occ, s_occ, block_r, block_s), device=dev)
    out = knn_score_cuda(r_tiles, s_tiles, active, block_r=block_r, block_s=block_s)
    return out[: r_block.num_vectors, : s_block.num_vectors]
