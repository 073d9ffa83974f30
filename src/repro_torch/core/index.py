"""Tile-granular inverted index: the paper's I_d lists at dim-tile
granularity (the PyTorch counterpart of ``repro.core.index``).

The dimension axis is cut into ``tile``-wide groups; for each tile the
index stores the list of S rows with any (indexed) mass in that tile and
a densified ``(row, tile)`` value patch.  Scoring a tile is one
``(|Br|, tile) @ (tile, M)`` product plus a column scatter-add
(``index_add_``) into the accumulator: work proportional to the list
length M, the paper's C3 shape.

The builder also implements IIIB's threshold refinement (§4.4): features
walked in descending-frequency order accumulate the trivial upper bound
``t += maxWeight_d(B_r)·s[d]``, and a row is indexed from the tile of its
first crossing feature on.

Determinism: every scatter here has unique targets except ones that only
write the same sentinel value (``rows``) or add exact zeros to a column
or lane that is cut off (``vals``, the accumulators), so the results are
the same on CUDA as on the CPU, and ``rows``, ``counts`` and ``vals``
equal the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.obs import trace as obs_trace
from repro_torch.sparse.format import DEFAULT_TILE, SparseBatch, num_tiles


@dataclasses.dataclass(frozen=True)
class TileIndex:
    """Inverted index at dim-tile granularity over one S block (permuted
    dims).  Arrays carry one extra sentinel tile (id = n_tiles) with empty
    lists, so a padded active-tile list can point at it harmlessly."""

    rows: torch.Tensor      # (T+1, M) int32 — S-row ids per tile; sentinel num_s
    vals: torch.Tensor      # (T+1, M, tile) f32 — densified indexed values
    counts: torch.Tensor    # (T+1,) int32
    pref_ub: torch.Tensor   # (N,) f32 — UB of each row's unindexed prefix (0 for IIB)
    crossing: torch.Tensor  # (N,) int32 — first indexed tile per row (0 for IIB)
    tile: int
    num_s: int

    @property
    def n_tiles(self) -> int:
        return self.rows.shape[0] - 1

    @property
    def max_rows(self) -> int:
        return self.rows.shape[1]

    @classmethod
    def from_arrays(cls, rows, vals, counts, pref_ub, crossing, tile: int, num_s: int,
                    device="cpu") -> "TileIndex":
        """An index from host arrays, e.g. the JAX package's ``TileIndex``
        fields as ``np.asarray(index.rows)`` and so on."""
        def put(x, dtype):
            return torch.tensor(np.asarray(x, dtype), device=device)

        return cls(rows=put(rows, np.int32), vals=put(vals, np.float32),
                   counts=put(counts, np.int32), pref_ub=put(pref_ub, np.float32),
                   crossing=put(crossing, np.int32), tile=int(tile), num_s=int(num_s))


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _rank_lut(rank: torch.Tensor, d: int) -> torch.Tensor:
    """(D+1,) int64 lookup: dim -> rank, the sentinel ``d`` to itself."""
    return torch.cat([rank.long(), torch.tensor([d], dtype=torch.long, device=rank.device)])


def _permuted_features(s_block: SparseBatch, rank: Optional[torch.Tensor]):
    """Per-row feature dims mapped through ``rank``; returns (p_idx, valid)."""
    d = s_block.dim
    idx = s_block.indices.long()
    valid = idx < d
    p_idx = _rank_lut(rank, d)[torch.clamp(idx, max=d)] if rank is not None else idx
    return torch.where(valid, p_idx, d), valid


def _sorted_features(s_block: SparseBatch, rank: Optional[torch.Tensor]):
    """Per-row features sorted by (permuted) dimension; returns
    (p_idx, vals, valid, order)."""
    p_idx, _ = _permuted_features(s_block, rank)
    order = torch.argsort(p_idx, dim=1, stable=True)
    sp = torch.gather(p_idx, 1, order)
    sv = torch.gather(s_block.values, 1, order)
    return sp, sv, sp < s_block.dim, order


def build_tile_index(
    s_block: SparseBatch,
    max_rows: int,
    tile: int = DEFAULT_TILE,
    rank: Optional[torch.Tensor] = None,
    maxw: Optional[torch.Tensor] = None,
    min_prune_score: Optional[torch.Tensor] = None,
    uniform: bool = False,
) -> TileIndex:
    """Build the tile index on ``s_block``'s device.  IIB: leave ``maxw`` and
    ``min_prune_score`` None.

    IIIB: pass ``rank`` (dim -> frequency position, most frequent = 0),
    ``maxw`` = maxWeight_d(B_r) in ORIGINAL dim space and the running
    MinPruneScore: rows' feature prefixes whose cumulative bound never
    exceeds it stay unindexed (paper Alg. 4 lines 8-14).  ``uniform``
    flattens every row's crossing to the block minimum (more is indexed,
    so it stays exact).
    """
    n, _ = s_block.indices.shape
    d = s_block.dim
    dev = s_block.device
    t_total = num_tiles(d, tile)

    if min_prune_score is None:
        # IIB / superset path: no crossing walk, so no per-row feature sort
        sp, sval = _permuted_features(s_block, rank)
        sv = s_block.values
        crossing = torch.zeros(n, dtype=torch.int32, device=dev)
        pref_ub = torch.zeros(n, dtype=torch.float32, device=dev)
    else:
        sp, sv, sval, order = _sorted_features(s_block, rank)
        idx = s_block.indices.long()
        maxw_pad = torch.cat([maxw.float(), torch.zeros(1, device=dev)])
        m = maxw_pad[torch.clamp(idx, max=d)]
        ms = torch.gather(torch.where(idx < d, m, 0.0), 1, order)
        contrib = torch.where(sval, ms * sv, 0.0)
        cum = torch.cumsum(contrib, dim=1)
        crossed = (cum > min_prune_score) & sval
        any_crossed = crossed.any(dim=1)
        first_pos = torch.argmax(crossed.to(torch.int8), dim=1)   # first True
        crossing_dim = torch.gather(sp, 1, first_pos[:, None])[:, 0]
        crossing = torch.where(any_crossed, crossing_dim // tile, t_total).to(torch.int32)
        prev = torch.where(first_pos > 0,
                           torch.gather(cum, 1, torch.clamp(first_pos - 1, min=0)[:, None])[:, 0],
                           0.0)
        # rows that never cross keep their FULL mass unindexed
        pref_ub = torch.where(any_crossed, prev, cum[:, -1]).float()
        if uniform:
            c_min = crossing.min()
            crossing = c_min.expand(n).contiguous()
            tile_of = torch.where(sval, sp // tile, t_total)
            pref_ub = torch.where(tile_of < c_min, contrib, 0.0).sum(dim=1).float()

    f_tid = torch.where(sval, sp // tile, t_total)
    indexed = sval & (f_tid >= crossing[:, None].long())

    # occupancy (N, T): row n has indexed mass in tile t
    occ = torch.zeros((n, t_total + 1), dtype=torch.int32, device=dev)
    row_ar = torch.arange(n, device=dev)
    occ.index_put_((row_ar[:, None].expand_as(f_tid), torch.where(indexed, f_tid, t_total)),
                   torch.ones_like(f_tid, dtype=torch.int32), accumulate=True)
    occ = occ[:, :t_total] > 0

    counts = occ.sum(dim=0).to(torch.int32)     # (T,)
    m_rows = min(max_rows, n)

    # pack occupied rows to the front, per tile: slot[s, t] = number of
    # occupied rows before s — one cumsum and two scatters
    slot = torch.cumsum(occ.to(torch.int32), dim=0) - 1        # (N, T)
    ok_row = occ & (slot < m_rows)
    row_ids = row_ar.to(torch.int32)[:, None].expand(n, t_total)
    t_ids = torch.arange(t_total, device=dev)[None, :].expand(n, t_total)
    rows = torch.full((t_total + 1, m_rows), n, dtype=torch.int32, device=dev)
    # targets off ok_row all write the sentinel value n
    rows.index_put_((torch.where(ok_row, t_ids, t_total), torch.clamp(slot, 0, m_rows - 1).long()),
                    torch.where(ok_row, row_ids, n))

    # densify indexed values with ONE scatter over every (row, feature)
    # pair: target (tile, list slot, lane); lane ``tile`` is a discard lane
    slot_pad = torch.cat([slot, torch.zeros((n, 1), dtype=slot.dtype, device=dev)], dim=1)
    slot_f = torch.gather(slot_pad, 1, torch.clamp(f_tid, max=t_total))     # (N, F)
    ok_f = indexed & (slot_f < m_rows)
    rel = torch.where(ok_f, sp - f_tid * tile, tile)
    vals = torch.zeros((t_total + 1, m_rows, tile + 1), dtype=torch.float32, device=dev)
    vals.index_put_((torch.where(ok_f, f_tid, t_total), torch.clamp(slot_f, 0, m_rows - 1).long(),
                     rel), torch.where(ok_f, sv, 0.0), accumulate=True)
    vals = vals[:, :, :tile].contiguous()

    counts = torch.cat([counts, torch.zeros(1, dtype=torch.int32, device=dev)])
    return TileIndex(rows=rows, vals=vals, counts=counts, pref_ub=pref_ub, crossing=crossing,
                     tile=tile, num_s=n)


def tile_list_lengths(
    s_block: SparseBatch,
    tile: int = DEFAULT_TILE,
    rank: Optional[np.ndarray] = None,
    maxw: Optional[np.ndarray] = None,
    min_prune_score: float = -np.inf,
) -> np.ndarray:
    """(T,) host list length of each tile: a numpy mirror of the
    ``counts`` that ``build_tile_index`` gives, without the sentinel
    tile."""
    idx = s_block.indices.cpu().numpy()
    val = s_block.values.cpu().numpy()
    d = s_block.dim
    valid = idx < d
    p_idx = np.where(valid, (rank[np.minimum(idx, d - 1)] if rank is not None else idx), d)
    t_total = num_tiles(d, tile)
    if min_prune_score == -np.inf or maxw is None:
        # threshold-free (IIB / superset) bound: no crossing walk, no sort
        sp, sval = p_idx, valid
        crossing = np.zeros(idx.shape[0], np.int64)
    else:
        order = np.argsort(p_idx, axis=1, kind="stable")
        sp = np.take_along_axis(p_idx, order, axis=1)
        sval = sp < d
        m = np.where(valid, maxw[np.minimum(idx, d - 1)], 0.0)
        ms = np.take_along_axis(m * val, order, axis=1)
        cum = np.cumsum(np.where(sval, ms, 0.0), axis=1)
        crossed = (cum > min_prune_score) & sval
        any_c = crossed.any(axis=1)
        first = np.where(any_c, np.argmax(crossed, axis=1), 0)
        cdim = np.take_along_axis(sp, first[:, None], axis=1)[:, 0]
        crossing = np.where(any_c, cdim // tile, t_total)
    f_tid = np.where(sval, sp // tile, t_total)
    indexed = sval & (f_tid >= crossing[:, None])
    occ = np.zeros((idx.shape[0], t_total + 1), np.int64)
    np.add.at(occ, (np.arange(idx.shape[0])[:, None], np.where(indexed, f_tid, t_total)), 1)
    return (occ[:, :t_total] > 0).sum(axis=0)


def bucket_rows(lengths: np.ndarray, num_s: int, bucket: int = 128) -> int:
    """The longest of ``lengths`` (at least 1) rounded up to a ``bucket``
    multiple, at most ``num_s``: a block's common list width M."""
    longest = max(int(lengths.max(initial=0)), 1)
    return min(int(-(-longest // bucket) * bucket), num_s)


def max_rows_bound(
    s_block: SparseBatch,
    tile: int = DEFAULT_TILE,
    rank: Optional[np.ndarray] = None,
    maxw: Optional[np.ndarray] = None,
    min_prune_score: float = -np.inf,
    bucket: int = 128,
) -> int:
    """Host-side concrete bound on the longest tile list, bucketed."""
    return bucket_rows(tile_list_lengths(s_block, tile, rank, maxw, min_prune_score),
                       s_block.num_vectors, bucket)


# ---------------------------------------------------------------------------
# scoring with the index
# ---------------------------------------------------------------------------

def _tile_ids(active_tiles) -> Sequence[int]:
    """The active tile ids as host ints: the lists are derived on the host,
    so walking them never reads the card."""
    return np.asarray(active_tiles).tolist()


def tile_scores(
    r_dense_tiles: torch.Tensor,   # (T, |Br|, tile) — permuted-dim dense tiles of B_r
    index: TileIndex,
    active_tiles,                  # (A,) host int tile ids; padded with n_tiles (sentinel)
) -> torch.Tensor:
    """(|Br|, |Bs|) accumulated scores over the given tiles.

    Per tile one (|Br|, tile) @ (tile, M) fp32 product and a column
    ``index_add_``, in list order.  A real row appears at most once in a
    tile's list, so each column gets one add per tile; the sentinel column
    (id num_s), cut off at the end, collects only exact zeros.  Sentinel
    entries of the list add nothing and are skipped.
    """
    n_r = r_dense_tiles.shape[1]
    t_total = r_dense_tiles.shape[0]
    acc = torch.zeros((n_r, index.num_s + 1), dtype=torch.float32,
                      device=r_dense_tiles.device)
    for t in _tile_ids(active_tiles):
        if t >= t_total:
            continue
        acc.index_add_(1, index.rows[t], r_dense_tiles[t] @ index.vals[t].T)
    return acc[:, : index.num_s]


def masked_tile_scores(
    r_dense_tiles: torch.Tensor,   # (T, |Br|, tile) — permuted-dim dense tiles of B_r
    index: TileIndex,
    active_tiles,                  # (A,) host int tile ids; padded with n_tiles (sentinel)
    keep: torch.Tensor,            # (|Bs|, T) bool — entry (s, t) survives the threshold
    lengths: Optional[np.ndarray] = None,  # (T,) host list lengths (``tile_list_lengths``)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IIIB's threshold refinement as a mask over a superset index.

    Returns two (|Br|, |Bs|) accumulators from the SAME per-tile products:
    ``kept``, the sum over unmasked entries (the paper's indexed score A,
    which the candidate test reads), and ``full``, the sum over all
    entries: the superset holds every feature, so this is the exact dot
    product that enters the top-k.

    The ``iiib.scatter`` span around the tile loop counts its ``tiles``,
    the list ``slots`` they multiply (tiles × M) and, given the host's
    ``lengths``, the real list ``entries`` among them; with tracing off
    nothing is counted.
    """
    n_r = r_dense_tiles.shape[1]
    t_total = r_dense_tiles.shape[0]
    dev = r_dense_tiles.device
    tiles = [t for t in _tile_ids(active_tiles) if t < t_total]
    acc_kept = torch.zeros((n_r, index.num_s + 1), dtype=torch.float32, device=dev)
    acc_full = torch.zeros_like(acc_kept)
    if not tiles:
        return acc_kept[:, : index.num_s], acc_full[:, : index.num_s]
    # sentinel row (id num_s): never kept; one gather gives every tile's mask
    kp = torch.cat([keep, torch.zeros((1, t_total), dtype=torch.bool, device=dev)])
    tt = to_device(torch.as_tensor(tiles), dev)     # no host sync: the store's shards overlap
    keep_lists = kp[index.rows[tt].long(), tt[:, None]]          # (A, M)
    span = obs_trace.start_span("iiib.scatter", tiles=len(tiles))  # the host's tile steps
    if span is not None:
        span.attrs["slots"] = len(tiles) * index.max_rows
        if lengths is not None:
            span.attrs["entries"] = int(lengths[tiles].sum())
    for j, t in enumerate(tiles):
        rows_t = index.rows[t]
        p = r_dense_tiles[t] @ index.vals[t].T                   # (|Br|, M)
        acc_full.index_add_(1, rows_t, p)
        acc_kept.index_add_(1, rows_t, torch.where(keep_lists[j][None, :], p, 0.0))
    obs_trace.end_span(span)
    return acc_kept[:, : index.num_s], acc_full[:, : index.num_s]


def dense_r_tiles(r_block: SparseBatch, tile: int = DEFAULT_TILE,
                  rank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, |Br|, tile) dense dim-tiles of a block, on the block's device,
    in the dim space permuted by ``rank`` (identity when None).

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
    p_idx = _rank_lut(rank, d)[torch.clamp(idx, max=d)] if rank is not None else idx
    slot = torch.where(valid, p_idx, t_total * tile)
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
