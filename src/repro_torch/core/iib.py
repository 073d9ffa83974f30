"""Inverted-index-based (IIB) KNN join — the paper's Algorithm 3 (the
PyTorch counterpart of ``repro.core.iib``).

The per-dimension inverted lists are a :class:`TileIndex`; Find_Matches is
a walk over the R block's active dim-tiles, each one product against the
tile's row list and a column scatter-add into the score accumulator (work
∝ Σ list lengths, the C3 shape).  Only vectors with a non-zero score are
offered (paper line 14), so vectors sharing no feature with r are never
returned.  Each block step merges through the topk_merge kernel
(``core/topk.py::merge_step``).
"""
from __future__ import annotations

import torch

from repro_torch.core.bf import block_ids
from repro_torch.core.index import TileIndex, tile_scores
from repro_torch.core.topk import NEG_INF, TopKState, merge_step


def iib_join_block(
    state: TopKState,
    r_tiles: torch.Tensor,      # (T, |Br|, tile) — dense R tiles (identity perm for IIB)
    index: TileIndex,
    active_tiles,               # (A,) host int32, sentinel-padded
    s_offset,                   # first-row global id, or (|Bs|,) per-row global ids
    s_valid: torch.Tensor,      # (|Bs|,) bool — masks padding rows
) -> TopKState:
    scores = tile_scores(r_tiles, index, active_tiles)
    ids = block_ids(s_offset, index.num_s, device=scores.device)
    valid = (scores > 0.0) & s_valid[None, :]
    return merge_step(state, torch.where(valid, scores, NEG_INF), ids)


def iib_scan_join(
    state: TopKState,
    r_tiles: torch.Tensor,      # (T, |Br|, tile)
    active_tiles,               # (A,) host int32, sentinel-padded (shared by all blocks)
    s_rows: torch.Tensor,       # (B, T+1, M) int32 — stacked per-block tile lists
    s_vals: torch.Tensor,       # (B, T+1, M, tile) f32
    s_counts: torch.Tensor,     # (B, T+1) int32
    s_ids: torch.Tensor,        # (B, num_s) int32 — per-row global ids
    s_valid: torch.Tensor,      # (B, num_s) bool
    tile: int,
    num_s: int,
) -> TopKState:
    """IIB over ALL stacked per-block tile indexes (threshold-free, one
    common M), in S order: the counterpart of the reference's
    ``lax.scan``."""
    zeros_f = torch.zeros(num_s, dtype=torch.float32, device=r_tiles.device)
    zeros_i = torch.zeros(num_s, dtype=torch.int32, device=r_tiles.device)
    for b in range(s_rows.shape[0]):
        index = TileIndex(rows=s_rows[b], vals=s_vals[b], counts=s_counts[b], pref_ub=zeros_f,
                          crossing=zeros_i, tile=tile, num_s=num_s)
        state = iib_join_block(state, r_tiles, index, active_tiles, s_ids[b], s_valid[b])
    return state
