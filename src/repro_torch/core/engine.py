"""Build-once/query-many KNN join engine: the paper's three drivers and
the fused-kernel IIB path.

The PyTorch counterpart of ``repro.core.engine``.  ``SparseKNNIndex.build``
pads S into blocks once; ``query(R)`` walks R blocks against them, in one
of two modes:

  * cached (``cache_device_blocks=True``): ``build`` stacks the S side on
    the device once — BF's padded-CSR blocks, IIB's tile indexes (one
    common list width), IIIB's threshold-free superset indexes (in the
    datastore's dim-frequency rank) with their per-(row, tile) mass, or
    the fused kernel's dense dim-tiles — and the whole S side of one R
    block is one driver call (``device_dispatches`` += 1).  IIIB's
    threshold rides in the walk's carry as a device tensor: the only host
    sync is the R block's result pull, which brings the threshold trace
    and the kept-entry counts with it.
  * streaming (``cache_device_blocks=False``, what ``knn_join`` uses): one
    step per (R block, S block) pair on transient device blocks; IIB and
    IIIB build the block's index per pair, IIIB sends its threshold to the
    host and back per pair.  Cached and streaming give the same arrays.

Every block step of BF, IIB and IIIB (and IIIB's warm-start pass) merges
through the topk_merge kernel (``core/topk.py::merge_step``).  The
fused-kernel path (``use_kernel=True``) runs knn_topk; for k > 128 (its
``MAX_K``) both modes take the score kernel, the candidate mask and the
merge kernel instead (``kernels/knn_topk/ops.py::join_topk``), bit for bit
the fused kernel's outputs.

Block geometry, candidate rules, tie order and the work counters follow
the reference, so ``JoinStats`` equals its counts.  Planner calibration,
the approximate tier, the mutations and ``refreeze`` raise
``NotImplementedError`` naming the ROADMAP.md queue item that ports them;
the ``engine.r_block`` span and the threshold histogram are left out
(queue 1 item 9).

Entry points run on ``device`` — CUDA unless the caller passes
``device="cpu"``, where the kernels' plain versions run.  Host-side numpy
work (padding, occupancy, active lists, bounds, tile mass) stays on the
host, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import iiib as iiib_mod
from repro_torch.core.bf import bf_block_scores, bf_join_block, bf_scan_join
from repro_torch.core.iib import iib_join_block, iib_scan_join
from repro_torch.core.iiib import iiib_masked_block, iiib_scan_join
from repro_torch.core.index import (
    active_tile_list,
    build_tile_index,
    dense_r_tiles,
    max_rows_bound,
)
from repro_torch.core.topk import TopKState, init_topk, merge_step, min_prune_score
from repro_torch.device import resolve_device
from repro_torch.kernels.knn_score.ops import _pad_rows, active_lists, dense_tiles_with_sentinel
from repro_torch.kernels.knn_topk.ops import join_topk, knn_topk, pad_state
from repro_torch.sparse.format import DEFAULT_TILE, SparseBatch, from_arrays, num_tiles

# planner constants (the reference's): the pair-score accumulator of one
# (B_r, B_s) pair is bounded to ~64 MiB of f32, and C3 carries a per-entry
# overhead factor against C2's dense matmul throughput
PAIR_BUDGET = 1 << 24
DEFAULT_S_BLOCK = 4096
INDEX_COST_FACTOR = 4.0

# JoinStats.min_prune_trace window: the most recent R blocks' traces
MIN_PRUNE_TRACE_CAP = 256

_QUEUE_ENGINE = "ROADMAP.md queue 1 item 5 (engine)"
_QUEUE_LSH = "ROADMAP.md queue 1 item 6 (approx tier)"


def _not_ported(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet: {queue}")


@dataclasses.dataclass
class JoinStats:
    """Work accounting for the paper's cost-model comparisons (C2 vs C3)."""

    blocks: int = 0
    tiles_scored: int = 0          # tile-matmul count (the active lists' length) — IIB/IIIB
    list_entries: int = 0          # Σ list entries scored (IIIB: unmasked only)
    dense_pairs: int = 0           # BF full-score pairs
    index_builds: int = 0          # S-block index constructions
    device_dispatches: int = 0     # driver-level device steps
    host_syncs: int = 0            # device→host reads on the query path
    build_wall_s: float = 0.0      # time spent inside build()
    query_wall_s: float = 0.0      # time spent inside query()
    # IIIB: per-R-block MinPruneScore traces ((s_blocks + 1,) each: [seed,
    # after block 0, ...]), pulled with the result; the most recent R
    # blocks' only
    min_prune_trace: Deque[np.ndarray] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=MIN_PRUNE_TRACE_CAP))


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """Frozen join configuration.  ``None`` fields are resolved by the planner."""

    k: int
    algorithm: Optional[str] = None     # bf | iib | iiib | None (planner picks)
    r_block: Optional[int] = None
    s_block: Optional[int] = None
    tile: int = DEFAULT_TILE
    use_kernel: bool = False            # IIB: route scoring through the fused kernel
    warm_start: float = 0.0             # IIIB: S-sample fraction seeding MinPruneScore
    seed: int = 0                       # warm-start sampler seed
    accuracy: str = "exact"             # exact | approx
    target_recall: Optional[float] = None

    def __post_init__(self):
        if self.algorithm not in (None, "bf", "iib", "iiib"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.target_recall is not None and self.accuracy == "exact":
            object.__setattr__(self, "accuracy", "approx")
        if self.accuracy not in ("exact", "approx"):
            raise ValueError(f"unknown accuracy {self.accuracy!r}")
        if self.accuracy == "approx" and self.target_recall is None:
            object.__setattr__(self, "target_recall", 0.95)
        if self.target_recall is not None and not 0.0 < self.target_recall < 1.0:
            raise ValueError(
                f"target_recall must be in (0, 1), got {self.target_recall} "
                "(use accuracy='exact' for exact results)")


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """Fully-resolved join parameters plus the cost estimates behind them."""

    algorithm: str
    r_block: int
    s_block: int
    tile: int
    k: int
    cost_bf: float      # C2 estimate: every dim-tile of every pair is scored
    cost_iib: float     # C3 estimate: work proportional to inverted-list mass
    cost_iiib: float    # C3 + threshold masking


def _shape_stats(shape) -> Tuple[int, float, int]:
    """(n_rows, mean_nnz, dim) from a SparseBatch or an (n, nnz, dim) tuple."""
    if isinstance(shape, SparseBatch):
        n = shape.num_vectors
        nnz = float(shape.nnz.double().mean()) if n else 0.0
        return n, nnz, shape.dim
    n, nnz, dim = shape
    return int(n), float(nnz), int(dim)


def plan(r_shape, s_shape, spec: JoinSpec, occupied_tiles: Optional[int] = None) -> JoinPlan:
    """Resolve algorithm and block geometry from the paper's C2/C3 cost model
    (the reference's ``plan`` without calibration).

    C2 (BF): every dim-tile of every (r, s) pair, ``n_r * n_s * D_padded``.
    C3 (IIB/IIIB): ``n_r * n_s * tile * E[tiles per S row]`` times the
    per-entry overhead of indexed scoring.
    """
    n_r, _, d_r = _shape_stats(r_shape)
    n_s, f_s, d_s = _shape_stats(s_shape)
    d = max(d_r, d_s)
    t = max(1, num_tiles(d, spec.tile))
    t_eff = max(1, min(occupied_tiles, t)) if occupied_tiles else t
    tiles_per_s_row = t_eff * (1.0 - (1.0 - 1.0 / t_eff) ** max(f_s, 0.0))
    cost_bf = float(n_r) * n_s * t * spec.tile
    cost_iib = INDEX_COST_FACTOR * float(n_r) * n_s * tiles_per_s_row * spec.tile

    if spec.algorithm is not None:
        algorithm = spec.algorithm
    elif spec.use_kernel:
        algorithm = "iib"
    else:
        algorithm = "bf" if cost_bf <= cost_iib else "iiib"

    s_block = spec.s_block if spec.s_block else min(n_s, DEFAULT_S_BLOCK)
    s_block = max(1, min(s_block, max(n_s, 1)))
    r_block = spec.r_block if spec.r_block else min(n_r, max(128, PAIR_BUDGET // s_block))
    r_block = max(1, min(r_block, max(n_r, 1)))
    return JoinPlan(
        algorithm=algorithm, r_block=r_block, s_block=s_block, tile=spec.tile,
        k=spec.k, cost_bf=cost_bf, cost_iib=cost_iib, cost_iiib=cost_iib,
    )


@dataclasses.dataclass
class JoinResult:
    """One query's output: (n_r, k) global-S neighbours plus work stats."""

    scores: torch.Tensor
    ids: torch.Tensor
    stats: JoinStats

    @property
    def state(self) -> TopKState:
        return TopKState(scores=self.scores, ids=self.ids)


# ---------------------------------------------------------------------------
# block plumbing (host-side)
# ---------------------------------------------------------------------------

def _pad_rows_np(
    idx: np.ndarray, val: np.ndarray, nnz: np.ndarray, dim: int, size: int,
    copy_unpadded: bool = False,
):
    """Pad pre-sliced host row arrays to ``size`` rows (sentinel index = dim,
    zero values/nnz); returns the padded arrays plus the valid mask."""
    stop = idx.shape[0]
    pad = size - stop
    if pad:
        idx = np.concatenate([idx, np.full((pad, idx.shape[1]), dim, idx.dtype)])
        val = np.concatenate([val, np.zeros((pad, val.shape[1]), val.dtype)])
        nnz = np.concatenate([nnz, np.zeros(pad, nnz.dtype)])
    elif copy_unpadded:
        idx, val, nnz = idx.copy(), val.copy(), nnz.copy()
    valid = np.arange(size) < stop
    return idx, val, nnz, valid


def _host_tile_any(idx: np.ndarray, dim: int, tile: int,
                   rank: Optional[np.ndarray] = None) -> np.ndarray:
    """(T,) bool — does ANY row of the block touch dim-tile t (in the space
    permuted by ``rank``)?"""
    t_total = num_tiles(dim, tile)
    valid = idx < dim
    if rank is not None:
        idx = np.where(valid, rank[np.minimum(idx, dim - 1)], dim)
    tid = np.where(valid, idx // tile, t_total)
    out = np.zeros(t_total + 1, dtype=bool)
    out[np.minimum(tid.ravel(), t_total)] = True
    return out[:t_total]


def _host_row_occupancy(idx: np.ndarray, dim: int, tile: int) -> np.ndarray:
    """(N, T) bool — per-row dim-tile occupancy, computed host-side (numpy)."""
    t_total = num_tiles(dim, tile)
    tid = np.where(idx < dim, idx // tile, t_total)
    occ = np.zeros((idx.shape[0], t_total + 1), dtype=bool)
    occ[np.arange(idx.shape[0])[:, None], tid] = True
    return occ[:, :t_total]


def prepare_r_block_inputs(
    br: SparseBatch,
    r_idx: np.ndarray,
    algorithm: str,
    tile: int,
    rank_np: Optional[np.ndarray] = None,
    rank_dev: Optional[torch.Tensor] = None,
    with_r_tiles: bool = True,
) -> dict:
    """R-side inputs of one padded R block's driver step (``r_idx``: its
    host indices): the host active-tile list, the dense (rank-permuted) R
    tiles on ``br``'s device, and IIIB's per-tile maxWeight bound."""
    if algorithm == "bf":
        return {}
    if algorithm == "iib":
        out = {"tiles": active_tile_list(_host_tile_any(r_idx, br.dim, tile))}
        if with_r_tiles:
            out["r_tiles"] = dense_r_tiles(br, tile)
        return out
    return {
        "r_tiles": dense_r_tiles(br, tile, rank=rank_dev),
        "mwt": iiib_mod.maxw_tiles(br, rank_dev, tile),
        "tiles": active_tile_list(_host_tile_any(r_idx, br.dim, tile, rank_np)),
    }


# ---------------------------------------------------------------------------
# cached S-side stacks (built once, walked every query)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _BFStack:
    """All cached S blocks as one batched tensor set (BF)."""

    idx: torch.Tensor      # (B, s_block, F) int32
    val: torch.Tensor      # (B, s_block, F) f32
    nnz: torch.Tensor      # (B, s_block) int32
    ids: torch.Tensor      # (B, s_block) int32 — per-row global ids
    valid: torch.Tensor    # (B, s_block) bool — padding rows out


@dataclasses.dataclass
class _IIBStack:
    """All cached per-block tile indexes, stacked (IIB, and IIIB's supersets)."""

    rows: torch.Tensor     # (B, T+1, M) int32
    vals: torch.Tensor     # (B, T+1, M, tile) f32
    counts: torch.Tensor   # (B, T+1) int32
    ids: torch.Tensor      # (B, s_block) int32 — per-row global ids
    valid: torch.Tensor    # (B, s_block) bool — padding rows out
    max_rows: int          # common M (max over the blocks' bounds)


@dataclasses.dataclass
class _KernelStack:
    """Dense dim-tiles of ALL cached S blocks for the fused knn_topk kernel."""

    s_tiles: torch.Tensor    # (T+1, NS_pad, tile) f32 — sentinel tile last
    s_occ: np.ndarray        # (NS_pad, T) bool — host, feeds active_lists
    col_valid: torch.Tensor  # (1, NS_pad) int32
    col_ids: torch.Tensor    # (1, NS_pad) int32 — global S ids per stacked column
    block_s: int             # kernel S-axis block (NS_pad % block_s == 0)


@dataclasses.dataclass
class _SBlock:
    """One S block: host mirror (CPU tensors), padding mask and host-side
    index metadata."""

    host: SparseBatch
    valid: np.ndarray                      # (s_block,) bool
    start: int                             # global row offset
    list_total: int = 0                    # Σ list lengths of the block's tile index
    bound: int = 0                         # host max_rows bound (IIB/IIIB)
    tilemass: Optional[np.ndarray] = None  # (s_block, T) rank-permuted mass (IIIB)


class SparseKNNIndex:
    """Build-once/query-many index over the inner join set S.

    ``build`` pays the S side once: block padding, host mirrors, dim
    statistics, and (cached mode) the device stacks of the chosen driver.
    Every ``query`` then walks an R batch against them in O(R-blocks)
    driver calls.  ``cache_device_blocks=False`` keeps only the host
    mirrors and uploads each S block (and builds its index) per (B_r, B_s)
    pair — the streaming profile that ``knn_join`` uses.

    ``frozen_rank`` fixes IIIB's superset order (default: the datastore's
    own dim-frequency rank).
    """

    def __init__(
        self,
        S: SparseBatch,
        spec: JoinSpec,
        cache_device_blocks: bool = True,
        device=None,
        frozen_rank: Optional[np.ndarray] = None,
        calibration=None,
        lsh_cfg=None,
    ):
        t0 = time.perf_counter()
        if calibration is not None:
            raise _not_ported("planner calibration", _QUEUE_ENGINE)
        if lsh_cfg is not None or spec.accuracy == "approx":
            raise _not_ported("accuracy='approx'", _QUEUE_LSH)
        self.device = resolve_device(device)
        self.spec = spec
        self._cache_device = cache_device_blocks
        self.dim = S.dim
        self.tile = spec.tile
        self.stats = JoinStats()
        self._idx = S.indices.cpu().numpy()
        self._val = S.values.cpu().numpy()
        self._nnz = S.nnz.cpu().numpy()
        self.n_s = S.num_vectors
        if self.n_s < 1:
            raise ValueError("S must have at least one row")

        # S-side dim statistics: dim_freq drives the planner's occupied-tile
        # estimate and IIIB's superset order
        self.dim_freq = np.bincount(self._idx[self._idx < self.dim],
                                    minlength=self.dim).astype(np.int64)
        self._f_mean = float(self._nnz.mean())
        (dims,) = np.nonzero(self.dim_freq)
        self._occupied_tiles = int(np.unique(dims // self.tile).size) if dims.size else 1

        f_mean = self._f_mean
        p = plan((self.n_s, f_mean, self.dim), (self.n_s, f_mean, self.dim), spec,
                 occupied_tiles=self._occupied_tiles)
        self.algorithm = spec.algorithm or p.algorithm
        self.s_block = max(1, min(spec.s_block or p.s_block, self.n_s))

        # IIIB superset order: the datastore's dim-frequency rank, frozen
        # at build time (a pruning heuristic, not a correctness input)
        self._rank_np: Optional[np.ndarray] = None
        self._rank_dev: Optional[torch.Tensor] = None
        if self.algorithm == "iiib":
            self._rank_np = (np.asarray(frozen_rank, np.int32) if frozen_rank is not None
                             else iiib_mod.s_frequency_rank(self.dim_freq))
            self._rank_dev = torch.as_tensor(self._rank_np, device=self.device)

        self._blocks: List[_SBlock] = []
        self._bf_stack: Optional[_BFStack] = None
        self._iib_stack: Optional[_IIBStack] = None
        self._kernel_stack: Optional[_KernelStack] = None
        self._mass_stack: Optional[torch.Tensor] = None   # (B, s_block, T) — IIIB
        self._build_blocks()
        self.stats.build_wall_s += time.perf_counter() - t0

    @classmethod
    def build(
        cls,
        S: SparseBatch,
        spec: JoinSpec,
        cache_device_blocks: bool = True,
        device=None,
        frozen_rank: Optional[np.ndarray] = None,
        calibration=None,
        lsh_cfg=None,
    ) -> "SparseKNNIndex":
        return cls(
            S, spec, cache_device_blocks=cache_device_blocks, device=device,
            frozen_rank=frozen_rank, calibration=calibration, lsh_cfg=lsh_cfg,
        )

    # -- mutation: not on this slice ----------------------------------------

    def extend(self, S_new, deadline=None):
        raise _not_ported("extend()", _QUEUE_ENGINE)

    def delete(self, ids):
        raise _not_ported("delete()", _QUEUE_ENGINE)

    def expire(self, now):
        raise _not_ported("expire()", _QUEUE_ENGINE)

    def compact(self):
        raise _not_ported("compact()", _QUEUE_ENGINE)

    def refreeze(self, frozen_rank=None):
        raise _not_ported("refreeze()", _QUEUE_ENGINE)

    # -- construction -------------------------------------------------------

    def _build_blocks(self):
        for start in range(0, self.n_s, self.s_block):
            self._blocks.append(self._make_block(start))
        if not self._cache_device:
            return
        if self.algorithm == "bf":
            self._bf_stack = self._stack_bf()
        elif self.algorithm == "iib" and self.spec.use_kernel:
            self._kernel_stack = self._stack_kernel()
        elif self.algorithm == "iib":
            self._iib_stack = self._stack_iib()
        else:   # iiib: superset tile indexes + tilemass, stacked like IIB
            self._iib_stack = self._stack_iib(rank=self._rank_dev)
            self._mass_stack = torch.as_tensor(
                np.stack([blk.tilemass for blk in self._blocks]), device=self.device)

    def _make_block(self, start: int) -> _SBlock:
        stop = min(start + self.s_block, self.n_s)
        idx, val, nnz, valid = _pad_rows_np(
            self._idx[start:stop], self._val[start:stop], self._nnz[start:stop],
            self.dim, self.s_block, copy_unpadded=True,
        )
        blk = _SBlock(host=from_arrays(idx, val, nnz, self.dim), valid=valid, start=start)
        if self.algorithm == "iib" and not self.spec.use_kernel:
            blk.bound = max_rows_bound(blk.host, self.tile)
        elif self.algorithm == "iiib":
            # superset bound and the per-(row, tile) mass the threshold mask
            # compares against (both threshold-independent)
            blk.bound = max_rows_bound(blk.host, self.tile, rank=self._rank_np)
            blk.tilemass = iiib_mod.tile_mass_host(idx, val, self.dim, self._rank_np, self.tile)
        return blk

    def _stack_ids_valid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, s_block) global-id stack and padding mask, on the device."""
        b, sb = len(self._blocks), self.s_block
        ids = np.arange(b * sb, dtype=np.int32).reshape(b, sb)
        valid = (np.arange(b * sb) < self.n_s).reshape(b, sb)
        return (torch.as_tensor(ids, device=self.device),
                torch.as_tensor(valid, device=self.device))

    def _stack_bf(self) -> _BFStack:
        """The padded-CSR blocks as (B, s_block, F) device tensors."""
        b, sb, f = len(self._blocks), self.s_block, self._idx.shape[1]
        idx = np.full((b * sb, f), self.dim, self._idx.dtype)
        val = np.zeros((b * sb, f), self._val.dtype)
        nnz = np.zeros(b * sb, self._nnz.dtype)
        idx[: self.n_s] = self._idx
        val[: self.n_s] = self._val
        nnz[: self.n_s] = self._nnz
        ids, valid = self._stack_ids_valid()

        def put(x, *shape):
            return torch.as_tensor(x.reshape(*shape), device=self.device)

        return _BFStack(idx=put(idx, b, sb, f), val=put(val, b, sb, f), nnz=put(nnz, b, sb),
                        ids=ids, valid=valid)

    def _stack_iib(self, rank: Optional[torch.Tensor] = None) -> _IIBStack:
        """Every block's tile index, built on the device with one common
        ``max_rows`` (the largest block bound) and stacked in place.
        ``rank=None`` gives IIB's identity-dim indexes; IIIB passes its
        frozen rank for the threshold-free superset indexes."""
        b, tile = len(self._blocks), self.tile
        m = max(blk.bound for blk in self._blocks)
        t1 = num_tiles(self.dim, tile) + 1
        rows = torch.empty((b, t1, m), dtype=torch.int32, device=self.device)
        vals = torch.empty((b, t1, m, tile), dtype=torch.float32, device=self.device)
        counts = torch.empty((b, t1), dtype=torch.int32, device=self.device)
        for i, blk in enumerate(self._blocks):
            ti = build_tile_index(blk.host.to(self.device), max_rows=m, tile=tile, rank=rank)
            self.stats.index_builds += 1
            blk.list_total = int(ti.counts.sum())
            rows[i], vals[i], counts[i] = ti.rows, ti.vals, ti.counts
            del ti
        ids, valid = self._stack_ids_valid()
        return _IIBStack(rows=rows, vals=vals, counts=counts, ids=ids, valid=valid, max_rows=m)

    def _stack_kernel(self) -> _KernelStack:
        """Stack dense dim-tiles of all S blocks on the device for the fused
        kernel, padded to the kernel's S-axis block."""
        ns = len(self._blocks) * self.s_block
        bs_k = 256 if ns >= 256 else -(-ns // 8) * 8
        ns_pad = -(-ns // bs_k) * bs_k
        f = self._idx.shape[1]
        idx = np.full((ns_pad, f), self.dim, np.int32)
        val = np.zeros((ns_pad, f), np.float32)
        nnz = np.zeros(ns_pad, np.int32)
        idx[: self.n_s] = self._idx
        val[: self.n_s] = self._val
        nnz[: self.n_s] = self._nnz
        stacked = from_arrays(idx, val, nnz, self.dim, device=self.device)
        cols = np.arange(ns_pad, dtype=np.int32)
        return _KernelStack(
            s_tiles=dense_tiles_with_sentinel(stacked, self.tile),
            s_occ=_host_row_occupancy(idx, self.dim, self.tile),
            col_valid=torch.as_tensor((cols < self.n_s).astype(np.int32)[None, :],
                                      device=self.device),
            col_ids=torch.as_tensor(np.where(cols < self.n_s, cols, -1)[None, :],
                                    device=self.device),
            block_s=bs_k,
        )

    # -- introspection ------------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    @property
    def occupied_tiles(self) -> int:
        """Number of dim-tiles S actually touches (planner statistic)."""
        return self._occupied_tiles

    def plan_for(self, R) -> JoinPlan:
        """Resolved plan for querying with R (a SparseBatch or shape tuple)."""
        n_r, f_r, _ = _shape_stats(R)
        spec = dataclasses.replace(self.spec, algorithm=self.algorithm, s_block=self.s_block)
        return plan((n_r, f_r, self.dim), (self.n_s, self._f_mean, self.dim), spec,
                    occupied_tiles=self._occupied_tiles)

    # -- query --------------------------------------------------------------

    def _warm_start_sample(self):
        """IIIB warm start: the sorted ids of a ``warm_start`` fraction of S
        (at least k rows, the reference's sampler and seed) and their batch
        on the device; (None, None) when off."""
        spec = self.spec
        if not (spec.warm_start > 0 and self.algorithm == "iiib"):
            return None, None
        m = max(int(self.n_s * spec.warm_start), spec.k)
        rng = np.random.default_rng(spec.seed)
        pool = np.arange(self.n_s)          # every row is alive (no tombstones yet)
        ids = np.sort(rng.choice(pool, size=min(m, pool.size), replace=False))
        block = from_arrays(self._idx[ids], self._val[ids], self._nnz[ids], self.dim,
                            device=self.device)
        return ids, block

    def query(
        self,
        R: SparseBatch,
        stats: Optional[JoinStats] = None,
        accuracy: Optional[str] = None,
    ) -> JoinResult:
        """R ⋈_KNN S.  Returns global S ids, on the index's device.

        The R-block loop is the paper's Algorithm 1 outer loop.  Cached
        mode makes one driver call per R block (BF/IIB/IIIB walk the
        stacks, the fused path one kernel launch); streaming mode one step
        per (R block, S block) pair.  Each R block ends in one host sync,
        the pull of its result (with IIIB's threshold trace and kept-entry
        counts).
        """
        t_q = time.perf_counter()
        stats = stats if stats is not None else JoinStats()
        if R.dim != self.dim:
            raise ValueError(f"dim mismatch: index has {self.dim}, got {R.dim}")
        if accuracy not in (None, "exact"):
            raise _not_ported(f"accuracy={accuracy!r}", _QUEUE_LSH)
        spec, algorithm, dev = self.spec, self.algorithm, self.device
        k, tile = spec.k, self.tile
        n_r = R.num_vectors
        rb = min(spec.r_block or self.plan_for(R).r_block, n_r)
        r_idx = R.indices.cpu().numpy()
        r_val = R.values.cpu().numpy()
        r_nnz = R.nnz.cpu().numpy()
        sampled_ids, sample_block = self._warm_start_sample()
        if sampled_ids is not None:
            sampled_dev = torch.as_tensor(sampled_ids.astype(np.int32), device=dev)

        out_scores, out_ids = [], []
        for r0 in range(0, n_r, rb):
            stop = min(r0 + rb, n_r)
            idx, val, nnz, r_valid = _pad_rows_np(
                r_idx[r0:stop], r_val[r0:stop], r_nnz[r0:stop], self.dim, rb)
            br = from_arrays(idx, val, nnz, self.dim, device=dev)
            n_valid = stop - r0
            state = init_topk(rb, k, device=dev)                 # InitPruneScore
            aux = None
            if sampled_ids is not None:
                # warm-start pass: exact BF scores of the sample seed the
                # top-k, and with it the MinPruneScore, on the device
                state = merge_step(state, bf_block_scores(br, sample_block), sampled_dev)
                stats.dense_pairs += rb * len(sampled_ids)
                stats.device_dispatches += 1

            if algorithm == "bf":
                if self._cache_device:
                    state = self._query_bf_scanned(state, br, stats, rb)
                else:
                    state = self._query_pairs(state, br, None, None, stats, rb)
            elif algorithm == "iib" and spec.use_kernel and self._cache_device:
                state = self._query_fused_kernel(br, idx, stats, n_valid)
            elif algorithm == "iib":
                prep = prepare_r_block_inputs(br, idx, "iib", tile,
                                              with_r_tiles=not spec.use_kernel)
                if self._cache_device:
                    state = self._query_iib_scanned(state, prep["r_tiles"], prep["tiles"], stats)
                else:
                    state = self._query_pairs(state, br, prep.get("r_tiles"), prep["tiles"],
                                              stats, rb)
            else:   # iiib — masked superset refinement, threshold in the carry
                prep = prepare_r_block_inputs(br, idx, "iiib", tile, rank_np=self._rank_np,
                                              rank_dev=self._rank_dev)
                rv = torch.as_tensor(r_valid, device=dev)
                if self._cache_device:
                    state, aux = self._query_iiib_scanned(
                        state, prep["r_tiles"], prep["mwt"], prep["tiles"], stats, sampled_ids,
                        rv)
                else:
                    state = self._query_pairs_iiib(
                        state, prep["r_tiles"], prep["mwt"], prep["tiles"], stats, sampled_ids,
                        rv)

            # the R block's result pull (IIIB's trace and counts ride along)
            out_scores.append(state.scores[:n_valid].cpu())
            out_ids.append(state.ids[:n_valid].cpu())
            if aux is not None:
                stats.list_entries += int(aux["kept"].sum())
                stats.min_prune_trace.append(aux["thr"].cpu().numpy())
            stats.host_syncs += 1

        dt = time.perf_counter() - t_q
        stats.query_wall_s += dt
        self.stats.query_wall_s += dt
        return JoinResult(scores=torch.cat(out_scores).to(dev), ids=torch.cat(out_ids).to(dev),
                          stats=stats)

    def kernel_inputs(self, br: SparseBatch, r_idx: np.ndarray, n_valid: int):
        """(args, kwargs, active entries) of the cached path's
        ``knn_topk_fused`` call for one padded R block ``br`` (host indices
        ``r_idx``, ``n_valid`` real rows) and a fresh top-k state: the
        engine's own shapes, also for holding the kernel against its plain
        version."""
        ks = self._kernel_stack
        rb = br.num_vectors
        br_k = 256 if rb >= 256 else -(-rb // 8) * 8
        state = init_topk(rb, self.spec.k, device=self.device)
        rv = torch.arange(rb, device=self.device) < n_valid
        thr = min_prune_score(state, valid=rv).reshape(1, 1)
        r_tiles = _pad_rows(dense_tiles_with_sentinel(br, self.tile), br_k)
        r_occ = _host_row_occupancy(r_idx, self.dim, self.tile)
        active = active_lists(r_occ, ks.s_occ, br_k, ks.block_s)
        init_s, init_i = pad_state(state, r_tiles.shape[1])
        args = (r_tiles, ks.s_tiles, torch.as_tensor(active, device=self.device),
                ks.col_valid, ks.col_ids, init_s, init_i)
        kwargs = dict(thr=thr, block_r=br_k, block_s=ks.block_s,
                      nr_valid=torch.full((1,), n_valid, dtype=torch.int32, device=self.device))
        n_active = int((active < num_tiles(self.dim, self.tile)).sum())
        return args, kwargs, n_active

    # -- cached drivers: one driver call per R block --------------------------

    def _query_bf_scanned(self, state, br, stats, rb):
        st = self._bf_stack
        b = len(self._blocks)
        state = bf_scan_join(state, br, st.idx, st.val, st.nnz, st.ids, st.valid, dim=self.dim)
        stats.device_dispatches += 1
        stats.blocks += b
        stats.dense_pairs += rb * self.s_block * b
        return state

    def _query_iib_scanned(self, state, r_tiles, tiles, stats):
        st = self._iib_stack
        b = len(self._blocks)
        state = iib_scan_join(state, r_tiles, tiles, st.rows, st.vals, st.counts, st.ids,
                              st.valid, tile=self.tile, num_s=self.s_block)
        stats.device_dispatches += 1
        stats.blocks += b
        stats.tiles_scored += int(tiles.shape[0]) * b
        stats.list_entries += sum(blk.list_total for blk in self._blocks)
        return state

    def _sampled_valid(self, sampled_ids: Optional[np.ndarray]) -> np.ndarray:
        """(B, s_block) bool — padding AND warm-start-sampled rows masked out
        (the sampled rows were offered by the warm-start pass)."""
        b, sb = len(self._blocks), self.s_block
        valid = np.arange(b * sb) < self.n_s
        if sampled_ids is not None:
            valid[sampled_ids] = False
        return valid.reshape(b, sb)

    def _query_iiib_scanned(self, state, r_tiles, mwt, tiles, stats, sampled_ids, rv):
        """IIIB's whole S side as one driver call, (TopKState,
        MinPruneScore) in the carry: the warm-started threshold seeds it as
        a device scalar, and the per-block trace and kept-entry counts stay
        on the device until the R block's result pull."""
        st = self._iib_stack
        b = len(self._blocks)
        thr0 = min_prune_score(state, valid=rv)     # device scalar, warm start included
        s_valid = torch.as_tensor(self._sampled_valid(sampled_ids), device=self.device)
        state, _, thr_trace, kept = iiib_scan_join(
            state, thr0, r_tiles, mwt, tiles, st.rows, st.vals, st.counts, self._mass_stack,
            st.ids, s_valid, rv, tile=self.tile, num_s=self.s_block)
        stats.device_dispatches += 1
        stats.blocks += b
        stats.tiles_scored += int(tiles.shape[0]) * b
        # trace = [seed, after block 0, ..., after block B-1]
        return state, {"thr": torch.cat([thr0[None], thr_trace]), "kept": kept}

    def _query_fused_kernel(self, br, r_idx, stats, n_valid):
        """One fused score→top-k launch covers every S block.  The
        threshold starts at the fresh state's MinPruneScore and rises inside
        the kernel across the S blocks; ``n_valid`` keeps padding rows out
        of the threshold reduce.  For k > 128 a score launch and a merge
        launch for each window of the stack take its place (``join_topk``,
        the same outputs; a window holds at most ``MAX_SCORES`` scores)."""
        args, kwargs, n_active = self.kernel_inputs(br, r_idx, n_valid)
        out_s, out_i = join_topk(*args, **kwargs)
        stats.device_dispatches += 1
        stats.blocks += len(self._blocks)
        stats.tiles_scored += n_active
        rb = br.num_vectors
        return TopKState(scores=out_s[:rb], ids=out_i[:rb])

    # -- per-pair loops (streaming mode) -------------------------------------

    def _query_pairs(self, state, br, r_tiles, tiles, stats, rb):
        """Algorithm 1's inner loop for BF and IIB: one step per (B_r, B_s)
        pair on transient device blocks (O(block) device memory)."""
        sb, tile = self.s_block, self.tile
        for blk in self._blocks:
            bs = blk.host.to(self.device)     # transient, per pair
            stats.blocks += 1
            if self.algorithm == "bf":
                state = bf_join_block(state, br, bs, blk.start,
                                      torch.as_tensor(blk.valid, device=self.device))
                stats.dense_pairs += rb * sb
                stats.device_dispatches += 1
            elif self.spec.use_kernel:
                state = knn_topk(
                    br, bs, state=state, s_offset=blk.start, s_valid=blk.valid,
                    tile=tile, block_r=min(256, rb), block_s=min(256, sb),
                    device=self.device,
                )
                stats.tiles_scored += int(tiles.shape[0])
                stats.device_dispatches += 1
                # the op reads both blocks' tile occupancy back to the host
                stats.host_syncs += 2
            else:
                index = build_tile_index(bs, max_rows=blk.bound, tile=tile)
                stats.index_builds += 1
                self.stats.index_builds += 1
                entries = int(index.counts.sum())
                stats.host_syncs += 1
                state = iib_join_block(state, r_tiles, index, tiles, blk.start,
                                       torch.as_tensor(blk.valid, device=self.device))
                stats.tiles_scored += int(tiles.shape[0])
                stats.list_entries += entries
                stats.device_dispatches += 2
        return state

    def _query_pairs_iiib(self, state, r_tiles, mwt, tiles, stats, sampled_ids, rv):
        """Streaming IIIB: the cached walk's masked-superset step, driven per
        pair — the superset index is built per (B_r, B_s) pair and the
        threshold round-trips through the host (the same arrays as the
        cached walk; that walk removes the rebuilds and the syncs)."""
        s_valid = self._sampled_valid(sampled_ids)
        for bi, blk in enumerate(self._blocks):
            bs = blk.host.to(self.device)
            index = build_tile_index(bs, max_rows=blk.bound, tile=self.tile,
                                     rank=self._rank_dev)
            stats.index_builds += 1
            self.stats.index_builds += 1
            # the per-pair threshold round trip the cached walk eliminates
            thr = torch.tensor(float(min_prune_score(state, valid=rv)), dtype=torch.float32,
                               device=self.device)
            stats.host_syncs += 1
            state, _, kept = iiib_masked_block(
                state, thr, r_tiles, index, torch.as_tensor(blk.tilemass, device=self.device),
                mwt, tiles, blk.start, torch.as_tensor(s_valid[bi], device=self.device), rv)
            stats.device_dispatches += 2
            stats.blocks += 1
            stats.tiles_scored += int(tiles.shape[0])
            stats.list_entries += int(kept)
            stats.host_syncs += 1
        return state
