"""Improved inverted-index-based (IIIB) KNN join — the paper's Algorithm 4
in the masked-superset form (the PyTorch counterpart of
``repro.core.iiib``).

The tile index of each S block is built ONCE with *every* feature indexed
(a threshold-independent superset, in the datastore's dim-frequency-rank
order), with per-(row, tile) mass partial sums.  The paper's threshold
refinement (lines 8-14 of Create_Inverted_List_IIIB) is then a mask: with
``maxw_tile`` the per-tile maxWeight(B_r), row s's frequency-ordered
prefix bound is ``cumsum(maxw_tile * tilemass(s))``, and entry (s, t)
stays "indexed" iff that inclusive bound exceeds the live MinPruneScore.
The walk over the S blocks carries the TopKState AND the threshold, which
stays a device tensor: lists shrink by masking, never by rebuilding.  The
same per-tile products give the indexed score A (masked accumulator, what
the candidate test reads) and the exact dot (full accumulator, what
enters the top-k), so no rescue pass is needed.

Soundness (tile-granular Theorem 1): for any r, ``dot(r, s on masked
tiles) <= Σ_masked maxw_tile[t]·tilemass[s, t] = pref_ub(s) <= threshold
<= pruneScore(r)``, so a true candidate shares a kept feature (A > 0).

``iiib_join_block_uniform`` is the ring join's step (``core/ring.py``): a
per-pair index built with a block-uniform crossing tile, scored as a
dense prefix plus the indexed suffix.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.bf import block_ids
from repro_torch.core.index import TileIndex, dense_r_tiles, masked_tile_scores, tile_scores
from repro_torch.core.topk import NEG_INF, TopKState, merge_step, min_prune_score, prune_scores
from repro_torch.sparse.format import (
    SparseBatch,
    dim_frequency,
    frequency_permutation,
    max_weight_per_dim,
    num_tiles,
)


def prepare_r_block(r_block: SparseBatch, tile: int):
    """Per-R-block precomputation of the paper's IIIB: rank[d] = position
    of dim d in descending-frequency order (line 6), maxw[d] =
    maxWeight_d(B_r) in original dim space (line 7), and the rank-permuted
    dense R tiles."""
    rank, _ = frequency_permutation(dim_frequency(r_block))
    maxw = max_weight_per_dim(r_block)
    return rank, maxw, dense_r_tiles(r_block, tile, rank=rank)


# ---------------------------------------------------------------------------
# build-time structures (threshold-independent; the engine stacks them)
# ---------------------------------------------------------------------------

def s_frequency_rank(dim_freq: np.ndarray) -> np.ndarray:
    """(D,) host rank: dim -> position in descending S-side frequency order
    (stable), the build-once analogue of the paper's per-B_r reordering."""
    order = np.argsort(-np.asarray(dim_freq), kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return rank.astype(np.int32)


def tile_mass_host(
    idx: np.ndarray, val: np.ndarray, dim: int, rank: np.ndarray, tile: int
) -> np.ndarray:
    """(N, T) f32 — per-row value mass per rank-permuted dim-tile (host),
    the partial sums the threshold mask compares against."""
    t_total = num_tiles(dim, tile)
    valid = idx < dim
    p = np.where(valid, rank[np.minimum(idx, dim - 1)], t_total * tile)
    tid = np.minimum(p // tile, t_total)
    out = np.zeros((idx.shape[0], t_total + 1), np.float32)
    np.add.at(out, (np.arange(idx.shape[0])[:, None], tid), np.where(valid, val, 0.0))
    return out[:, :t_total]


def maxw_tiles(r_block: SparseBatch, rank: torch.Tensor, tile: int) -> torch.Tensor:
    """(T,) f32 — max maxWeight_d(B_r) per rank-permuted dim-tile (device);
    tiles the R block never touches get 0."""
    t_total = num_tiles(r_block.dim, tile)
    mw = max_weight_per_dim(r_block).float()
    out = torch.zeros(t_total * tile, dtype=torch.float32, device=mw.device)
    out.scatter_reduce_(0, rank.long(), mw, "amax", include_self=True)
    return out.reshape(t_total, tile).amax(dim=1)


# ---------------------------------------------------------------------------
# the masked block step (shared by the cached walk and the streaming loop)
# ---------------------------------------------------------------------------

def iiib_masked_block(
    state: TopKState,
    thr: torch.Tensor,          # scalar f32 — live MinPruneScore
    r_tiles: torch.Tensor,      # (T, |Br|, tile) rank-permuted dense R tiles
    index: TileIndex,           # threshold-FREE superset index of the S block
    tilemass: torch.Tensor,     # (|Bs|, T) per-row per-tile value mass
    maxw_tile: torch.Tensor,    # (T,) per-tile maxWeight(B_r)
    active_tiles,               # (A,) host int32, sentinel-padded
    s_offset,                   # first-row global id, or (|Bs|,) per-row global ids
    s_valid: torch.Tensor,      # (|Bs|,) bool — padding AND warm-start-sampled rows out
    r_valid: torch.Tensor,      # (|Br|,) bool — padded R rows out of the min
) -> Tuple[TopKState, torch.Tensor, torch.Tensor]:
    """One (B_r, B_s) IIIB step against the superset index; returns
    (state, new threshold, kept-entry count), all on the device.

    ``r_valid`` keeps a ragged final R block's padding rows (prune score
    -inf forever) from pinning the threshold at -inf."""
    contrib = maxw_tile[None, :] * tilemass             # (|Bs|, T)
    cum = torch.cumsum(contrib, dim=1)                  # inclusive prefix bound
    keep = cum > thr                                    # entry (s, t) stays indexed
    pref_ub = torch.where(keep, 0.0, contrib).sum(dim=1)
    a_kept, a_full = masked_tile_scores(r_tiles, index, active_tiles, keep)
    prune = prune_scores(state)
    # Theorem 1 (a shared kept feature) and the A + prefUB > pruneScore
    # bound; the offered value is the EXACT dot
    offer = (a_kept > 0.0) & (a_kept + pref_ub[None, :] > prune[:, None]) & s_valid[None, :]
    ids = block_ids(s_offset, index.num_s, device=a_full.device)
    state = merge_step(state, torch.where(offer, a_full, NEG_INF), ids)
    kept_entries = ((tilemass > 0.0) & keep).sum(dtype=torch.int32)
    return state, min_prune_score(state, valid=r_valid), kept_entries


def iiib_scan_join(
    state: TopKState,
    thr: torch.Tensor,          # scalar f32 — seed threshold (a warm start stays on device)
    r_tiles: torch.Tensor,      # (T, |Br|, tile)
    maxw_tile: torch.Tensor,    # (T,)
    active_tiles,               # (A,) host int32, sentinel-padded (shared by all blocks)
    s_rows: torch.Tensor,       # (B, T+1, M) int32 — stacked superset tile lists
    s_vals: torch.Tensor,       # (B, T+1, M, tile) f32
    s_counts: torch.Tensor,     # (B, T+1) int32
    s_mass: torch.Tensor,       # (B, num_s, T) f32 — stacked tilemass
    s_ids: torch.Tensor,        # (B, num_s) int32 — per-row global ids
    s_valid: torch.Tensor,      # (B, num_s) bool
    r_valid: torch.Tensor,      # (|Br|,) bool
    tile: int,
    num_s: int,
):
    """IIIB over ALL stacked S blocks in S order, carrying (TopKState,
    MinPruneScore) on the device: no host sync.

    Returns (state, final thr, (B,) per-block thr trace, (B,) kept-entry
    counts), all device tensors, pulled with the R block's result."""
    zeros_f = torch.zeros(num_s, dtype=torch.float32, device=r_tiles.device)
    zeros_i = torch.zeros(num_s, dtype=torch.int32, device=r_tiles.device)
    thr_trace, kept_trace = [], []
    for b in range(s_rows.shape[0]):
        index = TileIndex(rows=s_rows[b], vals=s_vals[b], counts=s_counts[b], pref_ub=zeros_f,
                          crossing=zeros_i, tile=tile, num_s=num_s)
        state, thr, kept = iiib_masked_block(state, thr, r_tiles, index, s_mass[b], maxw_tile,
                                             active_tiles, s_ids[b], s_valid[b], r_valid)
        thr_trace.append(thr)
        kept_trace.append(kept)
    return state, thr, torch.stack(thr_trace), torch.stack(kept_trace)


# ---------------------------------------------------------------------------
# the ring join's step (uniform crossing)
# ---------------------------------------------------------------------------

def iiib_join_block_uniform(
    state: TopKState,
    r_block: SparseBatch,
    r_tiles: torch.Tensor,      # (T, |Br|, tile) rank-permuted dense R tiles
    rank: torch.Tensor,
    index: TileIndex,           # built with uniform=True: every row crosses at c_min
    s_block: SparseBatch,       # needed for the dense prefix pass
    s_offset,                   # first-row global id (int or scalar tensor)
    s_valid: torch.Tensor,      # (|Bs|,) bool
    tile: int,
) -> TopKState:
    """One exact IIIB step with a block-uniform crossing tile ``c_min``
    (``build_tile_index(..., uniform=True)``: every row's lists start at
    the block's smallest crossing).

    Tiles below ``c_min``: a dense product of all rows, accumulated tile by
    tile in tile order (the reference's scan adds an exact zero for every
    tile from ``c_min`` on, so its sum is this one).  Tiles from ``c_min``
    on: the pruned lists (``tile_scores`` over every tile; the lists are
    empty below the crossing).  Every valid S row is offered with its
    exact dot, merged through ``merge_step``.  ``c_min`` is read to the
    host (one sync a step): it bounds the prefix loop."""
    t_total = r_tiles.shape[0]
    n_s = s_block.num_vectors
    c_min = int(index.crossing[0]) if n_s else 0
    prefix = torch.zeros((r_tiles.shape[1], n_s), dtype=torch.float32, device=r_tiles.device)
    if c_min > 0:
        s_tiles = dense_r_tiles(s_block, tile, rank=rank)          # (T, |Bs|, tile)
        for t in range(min(c_min, t_total)):
            prefix = prefix + r_tiles[t] @ s_tiles[t].T
    suffix = tile_scores(r_tiles, index, np.arange(t_total, dtype=np.int32))
    scores = torch.where(s_valid[None, :], prefix + suffix, NEG_INF)
    return merge_step(state, scores, block_ids(s_offset, n_s, device=scores.device))

