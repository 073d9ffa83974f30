"""Build-once/query-many KNN join engine: the paper's three drivers, the
fused-kernel IIB path, the datastore's lifecycle and the approximate
tier.

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
    host and back per pair.  Cached and streaming give the same arrays (on
    the card up to the last ulp where a block's own list width makes
    cuBLAS pick another product kernel than the stack's common width).

Every block step of BF, IIB and IIIB (and IIIB's warm-start pass) merges
through the topk_merge kernel (``core/topk.py::merge_step``).  The
fused-kernel path (``use_kernel=True``) runs knn_topk; for k > 128 (its
``MAX_K``) both modes take the score kernel, the candidate mask and the
merge kernel instead (``kernels/knn_topk/ops.py::join_topk``), bit for bit
the fused kernel's outputs.

The datastore's lifecycle: ``extend`` appends rows and restacks only the
tail blocks (the retained prefix of every stack stays on the device);
``delete`` and ``expire`` tombstone rows by changing the valid masks only
(one upload, no index build); ``compact`` drops the dead rows for real
and ``refreeze`` recomputes IIIB's superset order.  The approximate tier
(``accuracy="approx"``, ``core/lsh.py``) keys every S row with SimHash
bands at build time and, per R block, ANDs a band-lookup candidate mask
into the same valid masks, so the exact drivers re-rank only the
candidates.  ``plan`` takes a measured calibration.  Each R block is an
``engine.r_block`` span, and IIIB's threshold traces feed the process
registry's ``knn_min_prune_threshold`` histogram.

``distributed_join`` is the engine face of the multi-device join: the
sharded store over a device mesh, or the ring driver of ``core/ring.py``.

Block geometry, candidate rules, tie order and the work counters follow
the reference, so ``JoinStats`` equals its counts.  Entry points run on
``device`` — CUDA unless the caller passes ``device="cpu"``, where the
kernels' plain versions run.  Host-side numpy work (padding, occupancy,
active lists, bounds, tile mass, band keys) stays on the host, as in the
reference.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import time
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import iiib as iiib_mod
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.bf import bf_block_scores, bf_join_block, bf_scan_join
from repro_torch.core.iib import iib_join_block, iib_scan_join
from repro_torch.core.iiib import iiib_masked_block, iiib_scan_join
from repro_torch.core.index import (
    active_tile_list,
    build_tile_index,
    dense_r_tiles,
    max_rows_bound,
)
from repro_torch.core.topk import NEG_INF, TopKState, init_topk, merge_step, min_prune_score
from repro_torch.device import resolve_device
from repro_torch.kernels.knn_score.ops import _pad_rows, active_lists, dense_tiles_with_sentinel
from repro_torch.kernels.knn_topk.ops import join_topk, knn_topk, pad_state
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.registry import get_registry
from repro_torch.sparse.format import DEFAULT_TILE, SparseBatch, from_arrays, num_tiles

# planner constants (the reference's): the pair-score accumulator of one
# (B_r, B_s) pair is bounded to ~64 MiB of f32, and C3 carries a per-entry
# overhead factor against C2's dense matmul throughput; a calibration
# record (``plan(..., calibration=)``) replaces the unit costs
PAIR_BUDGET = 1 << 24
DEFAULT_S_BLOCK = 4096
INDEX_COST_FACTOR = 4.0

# JoinStats.min_prune_trace window: the most recent R blocks' traces; the
# lifetime distribution is the registry histogram below
MIN_PRUNE_TRACE_CAP = 256

# similarity-score-scale buckets of the IIIB MinPruneScore histogram
# (values below the first edge land in the lowest bucket, -inf seeds are
# dropped, the +Inf bucket catches outliers)
_THR_BUCKETS = (0.0, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0, 1.5, 2.0, 4.0, 8.0, 16.0)


def observe_thresholds(thr) -> None:
    """Feed one R block's MinPruneScore trace into the process registry's
    ``knn_min_prune_threshold`` histogram."""
    h = get_registry().histogram(
        "knn_min_prune_threshold",
        "IIIB MinPruneScore evolution (per S block, all R blocks)",
        buckets=_THR_BUCKETS)
    for v in np.asarray(thr, np.float64).ravel():
        h.observe(v)


def load_calibration(calibration) -> Optional[dict]:
    """Resolve a planner calibration: ``None``, a dict, or a JSON file path
    (the record ``benchmarks/roofline.py --calibrate`` writes).

    Recognised keys (all optional):
      c2_unit_s          — seconds per dense C2 work unit (one scored
                           dim-tile lane of one (r, s) pair)
      c3_unit_s          — seconds per indexed C3 work unit
      index_cost_factor  — c3_unit_s / c2_unit_s (used when only the ratio
                           was recorded); defaults to INDEX_COST_FACTOR
    """
    if calibration is None or isinstance(calibration, dict):
        return calibration
    with open(calibration) as f:
        return json.load(f)


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
    build_wall_s: float = 0.0      # time spent inside build()/extend()
    query_wall_s: float = 0.0      # time spent inside query()
    # approximate tier: ``recall`` is measured against an exact reference
    # the engine does not have at query time (callers fill it with
    # ``lsh.measured_recall``); it stays None on exact queries
    recall: Optional[float] = None
    candidate_rows: int = 0        # Σ live S rows surviving the band filter
    scanned_rows: int = 0          # Σ live S rows the exact scan would visit
    # IIIB: per-R-block MinPruneScore traces ((s_blocks + 1,) each: [seed,
    # after block 0, ...]), pulled with the result; the most recent R
    # blocks' only
    min_prune_trace: Deque[np.ndarray] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=MIN_PRUNE_TRACE_CAP))

    @property
    def candidate_fraction(self) -> Optional[float]:
        """Fraction of live S rows the band filter let through (approx
        queries only; None when no approximate block ran)."""
        if self.scanned_rows == 0:
            return None
        return self.candidate_rows / self.scanned_rows


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
    # approximate tier: accuracy="approx" builds a SimHash band index whose
    # candidate mask prunes S before the exact re-rank; ``target_recall``
    # alone implies it
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


def plan(r_shape, s_shape, spec: JoinSpec, occupied_tiles: Optional[int] = None,
         calibration=None) -> JoinPlan:
    """Resolve algorithm and block geometry from the paper's C2/C3 cost model.

    C2 (BF): every dim-tile of every (r, s) pair, ``n_r * n_s * D_padded``.
    C3 (IIB/IIIB): ``n_r * n_s * tile * E[tiles per S row]`` times the
    per-entry overhead of indexed scoring.  ``calibration`` (a dict or a
    JSON path, :func:`load_calibration`) replaces the unit costs with
    measured ones, turning the estimates into seconds.
    """
    n_r, _, d_r = _shape_stats(r_shape)
    n_s, f_s, d_s = _shape_stats(s_shape)
    d = max(d_r, d_s)
    t = max(1, num_tiles(d, spec.tile))
    t_eff = max(1, min(occupied_tiles, t)) if occupied_tiles else t
    tiles_per_s_row = t_eff * (1.0 - (1.0 - 1.0 / t_eff) ** max(f_s, 0.0))
    cal = load_calibration(calibration) or {}
    c2_unit = float(cal.get("c2_unit_s", 1.0))
    c3_unit = float(cal.get("c3_unit_s",
                            c2_unit * cal.get("index_cost_factor", INDEX_COST_FACTOR)))
    cost_bf = c2_unit * float(n_r) * n_s * t * spec.tile
    cost_iib = c3_unit * float(n_r) * n_s * tiles_per_s_row * spec.tile

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
    """One query's output: (n_r, k) global-S neighbours plus work stats.

    ``missing_shards`` is non-empty only for degraded sharded-store queries
    (``allow_partial=True`` with shards lost): the result is exact over the
    surviving shards and excludes the listed ones entirely."""

    scores: torch.Tensor
    ids: torch.Tensor
    stats: JoinStats
    missing_shards: Tuple[int, ...] = ()

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


def _pad_feature_axis(idx: np.ndarray, val: np.ndarray, f: int, dim: int):
    """Widen (N, F') feature arrays to F columns with sentinel padding."""
    pad = f - idx.shape[1]
    if pad <= 0:
        return idx, val
    idx = np.concatenate([idx, np.full((idx.shape[0], pad), dim, idx.dtype)], axis=1)
    val = np.concatenate([val, np.zeros((val.shape[0], pad), val.dtype)], axis=1)
    return idx, val


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
    valid: torch.Tensor    # (B, s_block) bool — padding AND tombstoned rows out


@dataclasses.dataclass
class _IIBStack:
    """All cached per-block tile indexes, stacked (IIB, and IIIB's supersets)."""

    rows: torch.Tensor     # (B, T+1, M) int32
    vals: torch.Tensor     # (B, T+1, M, tile) f32
    counts: torch.Tensor   # (B, T+1) int32
    ids: torch.Tensor      # (B, s_block) int32 — per-row global ids
    valid: torch.Tensor    # (B, s_block) bool — padding AND tombstoned rows out
    max_rows: int          # common M (max over the blocks' bounds)


@dataclasses.dataclass
class _KernelStack:
    """Dense dim-tiles of ALL cached S blocks for the fused knn_topk kernel."""

    s_tiles: torch.Tensor    # (T+1, NS_pad, tile) f32 — sentinel tile last
    s_occ: np.ndarray        # (NS_pad, T) bool — host, feeds active_lists
    col_valid: torch.Tensor  # (1, NS_pad) int32 — padding AND tombstoned columns 0
    col_ids: torch.Tensor    # (1, NS_pad) int32 — global S ids per stacked column
    block_s: int             # kernel S-axis block (NS_pad % block_s == 0)
    col_keys: Optional[torch.Tensor] = None  # (1, NS_pad, n_bands) int32 — approx tier


@dataclasses.dataclass
class _SBlock:
    """One S block: host mirror (CPU tensors), padding mask and host-side
    index metadata."""

    host: SparseBatch                      # streaming re-uploads from here
    valid: np.ndarray                      # (s_block,) bool
    start: int                             # global row offset
    list_total: int = 0                    # Σ list lengths of the block's tile index
    bound: int = 0                         # host max_rows bound (IIB/IIIB)
    tilemass: Optional[np.ndarray] = None  # (s_block, T) rank-permuted mass (IIIB)
    lshkeys: Optional[np.ndarray] = None   # (s_block, n_bands) int32 band keys (approx)


class SparseKNNIndex:
    """Build-once/query-many index over the inner join set S.

    ``build`` pays the S side once: block padding, host mirrors, dim
    statistics, band keys (approx tier), and (cached mode) the device
    stacks of the chosen driver.  Every ``query`` then walks an R batch
    against them in O(R-blocks) driver calls.  ``cache_device_blocks=False``
    keeps only the host mirrors and uploads each S block (and builds its
    index) per (B_r, B_s) pair — the streaming profile that ``knn_join``
    uses.

    ``frozen_rank`` fixes IIIB's superset order (default: the datastore's
    own dim-frequency rank), ``calibration`` the planner's unit costs, and
    ``lsh_cfg`` the band hasher (default: planned from ``target_recall``).
    """

    def __init__(
        self,
        S: SparseBatch,
        spec: JoinSpec,
        cache_device_blocks: bool = True,
        device=None,
        frozen_rank: Optional[np.ndarray] = None,
        calibration=None,
        lsh_cfg: Optional[lsh_mod.LSHConfig] = None,
    ):
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.spec = spec
        self._cache_device = cache_device_blocks
        self.dim = S.dim
        self.tile = spec.tile
        self.stats = JoinStats()
        self.calibration = load_calibration(calibration)
        self._idx = S.indices.cpu().numpy()
        self._val = S.values.cpu().numpy()
        self._nnz = S.nnz.cpu().numpy()
        self.n_s = S.num_vectors
        if self.n_s < 1:
            raise ValueError("S must have at least one row")

        # tombstones: delete()/expire() mark rows dead without touching the
        # cached stacks — only the valid masks change; compact() is the real
        # rebuild that reclaims them
        self._alive = np.ones(self.n_s, bool)
        self._deadline = np.full(self.n_s, np.inf)

        # S-side dim statistics, kept up by extend(): dim_freq drives the
        # planner's occupied-tile estimate and IIIB's superset order
        self.dim_freq = np.zeros(self.dim, np.int64)
        self._accumulate_dim_stats(self._idx)
        self._refresh_plan_stats()

        f_mean = self._f_mean
        p = plan((self.n_s, f_mean, self.dim), (self.n_s, f_mean, self.dim), spec,
                 occupied_tiles=self._occupied_tiles, calibration=self.calibration)
        self.algorithm = spec.algorithm or p.algorithm
        self.s_block = max(1, min(spec.s_block or p.s_block, self.n_s))

        # IIIB superset order: the datastore's dim-frequency rank, frozen
        # at build time so extend() keeps the retained stack blocks valid
        # (a pruning heuristic, not a correctness input; refreeze()
        # recomputes it)
        self._rank_np: Optional[np.ndarray] = None
        self._rank_dev: Optional[torch.Tensor] = None
        if self.algorithm == "iiib":
            self._rank_np = (np.asarray(frozen_rank, np.int32) if frozen_rank is not None
                             else iiib_mod.s_frequency_rank(self.dim_freq))
            self._rank_dev = torch.as_tensor(self._rank_np, device=self.device)

        # approximate tier: the SimHash band hasher is build-frozen state
        self._lsh: Optional[lsh_mod.LSHBands] = None
        if spec.accuracy == "approx":
            cfg = lsh_cfg or lsh_mod.plan_lsh(spec.target_recall, seed=spec.seed)
            self._lsh = lsh_mod.LSHBands(cfg, self.dim)

        self._blocks: List[_SBlock] = []
        self._bf_stack: Optional[_BFStack] = None
        self._iib_stack: Optional[_IIBStack] = None
        self._kernel_stack: Optional[_KernelStack] = None
        self._mass_stack: Optional[torch.Tensor] = None   # (B, s_block, T) — IIIB
        self._lsh_stack: Optional[torch.Tensor] = None    # (B, s_block, n_bands)
        self._build_blocks(from_block=0)
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
        lsh_cfg: Optional[lsh_mod.LSHConfig] = None,
    ) -> "SparseKNNIndex":
        return cls(
            S, spec, cache_device_blocks=cache_device_blocks, device=device,
            frozen_rank=frozen_rank, calibration=calibration, lsh_cfg=lsh_cfg,
        )

    def extend(self, S_new: SparseBatch, deadline=None) -> "SparseKNNIndex":
        """Append rows to S in place, rebuilding only the affected tail blocks.

        The same index as a build over the row-concatenation of the old and
        new S (block geometry is fixed at build time, so only the block
        holding the old tail, if partial, and the new blocks change; IIIB
        keeps its frozen rank).  Every cached stack keeps its retained
        prefix on the device: the IIB/IIIB index prefix is padded to the new
        list width, never rebuilt.  ``deadline`` optionally gives the new
        rows a TTL: a scalar or per-row array of expiry times for
        :meth:`expire`.
        """
        if S_new.dim != self.dim:
            raise ValueError(f"dim mismatch: index has {self.dim}, got {S_new.dim}")
        t0 = time.perf_counter()
        idx2 = S_new.indices.cpu().numpy()
        val2 = S_new.values.cpu().numpy()
        nnz2 = S_new.nnz.cpu().numpy()
        n_new = S_new.num_vectors
        f = max(self._idx.shape[1], idx2.shape[1])
        self._idx, self._val = _pad_feature_axis(self._idx, self._val, f, self.dim)
        idx2, val2 = _pad_feature_axis(idx2, val2, f, self.dim)
        old_n = self.n_s
        self._idx = np.concatenate([self._idx, idx2])
        self._val = np.concatenate([self._val, val2])
        self._nnz = np.concatenate([self._nnz, nnz2])
        self.n_s = old_n + n_new
        self._alive = np.concatenate([self._alive, np.ones(n_new, bool)])
        dl = (np.full(n_new, np.inf) if deadline is None
              else np.broadcast_to(np.asarray(deadline, np.float64), (n_new,)))
        self._deadline = np.concatenate([self._deadline, dl])
        self._accumulate_dim_stats(idx2)
        self._refresh_plan_stats()
        self._build_blocks(from_block=old_n // self.s_block)
        self.stats.build_wall_s += time.perf_counter() - t0
        return self

    # -- mutation: tombstones (delete / TTL) and the real rebuilds -----------

    def delete(self, ids) -> int:
        """Tombstone rows by global id.  No index build: only the valid masks
        change (one host→device upload); results exclude the rows at once.
        Returns the number of newly dead rows."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_s):
            raise IndexError(f"ids out of range [0, {self.n_s})")
        newly = int(self._alive[ids].sum())
        self._alive[ids] = False
        self._refresh_valid()
        return newly

    def expire(self, now: float) -> int:
        """Tombstone rows whose TTL deadline has passed (``deadline <= now``),
        as :meth:`delete` does.  Returns the number of newly dead rows."""
        dead = self._alive & (self._deadline <= now)
        newly = int(dead.sum())
        if newly:
            self._alive[dead] = False
            self._refresh_valid()
        return newly

    @property
    def dead_rows(self) -> int:
        return self.n_s - int(self._alive.sum())

    @property
    def live_rows(self) -> int:
        return int(self._alive.sum())

    def compact(self) -> int:
        """Drop the tombstoned rows and rebuild blocks and stacks: the real
        rebuild that delete()/expire() defer.  Global ids shift to the
        surviving rows' new positions.  A datastore with every row dead
        compacts to one still-tombstoned stub row (a batch needs >= 1 row),
        so every query keeps masking it out.  Returns the rows removed; the
        surviving-row mask is ``last_compact_keep``."""
        removed = self.dead_rows
        if removed == 0:
            self.last_compact_keep = np.ones(self.n_s, bool)
            return 0
        t0 = time.perf_counter()
        keep = self._alive.copy()
        stub = not keep.any()
        if stub:
            keep[0] = True
            removed -= 1
        self.last_compact_keep = keep
        self._idx = self._idx[keep]
        self._val = self._val[keep]
        self._nnz = self._nnz[keep]
        self._deadline = self._deadline[keep]
        self.n_s = int(keep.sum())
        self._alive = np.full(self.n_s, not stub)
        self.dim_freq = np.zeros(self.dim, np.int64)
        self._accumulate_dim_stats(self._idx)
        self._refresh_plan_stats()
        self._bf_stack = None
        self._iib_stack = None
        self._kernel_stack = None
        self._mass_stack = None
        self._lsh_stack = None
        self._build_blocks(from_block=0)
        self.stats.build_wall_s += time.perf_counter() - t0
        return removed

    def refreeze(self, frozen_rank: Optional[np.ndarray] = None) -> "SparseKNNIndex":
        """Recompute IIIB's superset dim-frequency rank over the live rows (or
        take ``frozen_rank``) and rebuild its stacks.  The frozen rank stays
        exact across extend() but prunes less as the frequency profile
        drifts; refreezing restores the prune rate.  Results are unchanged
        up to summation order.  No-op for BF and IIB."""
        if self.algorithm != "iiib":
            return self
        t0 = time.perf_counter()
        if frozen_rank is not None:
            self._rank_np = np.asarray(frozen_rank, np.int32)
        else:
            valid = (self._idx < self.dim) & self._alive[:, None]
            live_freq = np.bincount(self._idx[valid], minlength=self.dim).astype(np.int64)
            self._rank_np = iiib_mod.s_frequency_rank(live_freq)
        self._rank_dev = torch.as_tensor(self._rank_np, device=self.device)
        for blk in self._blocks:
            blk.bound = max_rows_bound(blk.host, self.tile, rank=self._rank_np)
            blk.tilemass = iiib_mod.tile_mass_host(blk.host.indices.numpy(),
                                                   blk.host.values.numpy(), self.dim,
                                                   self._rank_np, self.tile)
        self._iib_stack = None
        self._mass_stack = None
        self._build_stacks(from_block=0)
        self.stats.build_wall_s += time.perf_counter() - t0
        return self

    def _accumulate_dim_stats(self, idx: np.ndarray):
        self.dim_freq += np.bincount(idx[idx < self.dim], minlength=self.dim)

    def _refresh_plan_stats(self):
        # kept so query -> plan_for does no O(n_s) host work
        self._f_mean = float(self._nnz.mean())
        (dims,) = np.nonzero(self.dim_freq)
        self._occupied_tiles = int(np.unique(dims // self.tile).size) if dims.size else 1
        self._max_weight = None

    # -- construction -------------------------------------------------------

    def _build_blocks(self, from_block: int):
        del self._blocks[from_block:]
        for start in range(from_block * self.s_block, self.n_s, self.s_block):
            self._blocks.append(self._make_block(start))
        self._build_stacks(from_block)

    def _make_block(self, start: int) -> _SBlock:
        stop = min(start + self.s_block, self.n_s)
        idx, val, nnz, valid = _pad_rows_np(
            self._idx[start:stop], self._val[start:stop], self._nnz[start:stop],
            self.dim, self.s_block, copy_unpadded=True,
        )
        blk = _SBlock(host=from_arrays(idx, val, nnz, self.dim), valid=valid, start=start)
        if self._lsh is not None:
            # per-row build-time state like the tile mass: padding rows hash
            # to key 0 and are excluded by the valid mask
            blk.lshkeys = self._lsh.keys_host(idx, val)
        if self.algorithm == "iib" and not self.spec.use_kernel:
            blk.bound = max_rows_bound(blk.host, self.tile)
        elif self.algorithm == "iiib":
            # superset bound and the per-(row, tile) mass the threshold mask
            # compares against (both threshold-independent)
            blk.bound = max_rows_bound(blk.host, self.tile, rank=self._rank_np)
            blk.tilemass = iiib_mod.tile_mass_host(idx, val, self.dim, self._rank_np, self.tile)
        return blk

    def _build_stacks(self, from_block: int):
        """(Re)stack blocks ``from_block`` on; the prefix stays on the device."""
        if not self._cache_device:
            return
        if self.algorithm == "bf":
            self._bf_stack = self._stack_bf(from_block)
        elif self.algorithm == "iib" and self.spec.use_kernel:
            self._kernel_stack = self._stack_kernel(from_block)
        elif self.algorithm == "iib":
            self._iib_stack = self._stack_iib(from_block)
        else:   # iiib: superset tile indexes + tilemass, stacked like IIB
            self._iib_stack = self._stack_iib(from_block, rank=self._rank_dev)
            self._mass_stack = self._stack_rows(self._mass_stack, from_block, "tilemass")
        if self._lsh is not None and not (self.spec.use_kernel and self.algorithm == "iib"):
            self._lsh_stack = self._stack_rows(self._lsh_stack, from_block, "lshkeys")

    def _stack_rows(self, old: Optional[torch.Tensor], from_block: int, field: str):
        """(B, s_block, ...) stack of a per-row block field (``tilemass``,
        ``lshkeys``): the first ``from_block`` blocks kept from ``old``, the
        tail uploaded."""
        tail = torch.as_tensor(np.stack([getattr(blk, field) for blk in self._blocks[from_block:]]),
                               device=self.device)
        if from_block == 0 or old is None:
            return tail
        return torch.cat([old[:from_block], tail])

    def _stack_ids_valid(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, s_block) global-id stack and valid mask (padding AND alive),
        on the device."""
        b, sb = len(self._blocks), self.s_block
        ids = np.arange(b * sb, dtype=np.int32).reshape(b, sb)
        valid = np.arange(b * sb) < self.n_s
        valid[: self.n_s] &= self._alive
        return (torch.as_tensor(ids, device=self.device),
                torch.as_tensor(valid.reshape(b, sb), device=self.device))

    def _refresh_valid(self):
        """Push the alive mask into every cached stack's valid mask: the whole
        device-side cost of delete()/expire().  Index structures, id stacks,
        mass and key stacks stay as they are (no index build)."""
        if not self._cache_device:
            return
        _, valid = self._stack_ids_valid()
        if self._bf_stack is not None:
            self._bf_stack.valid = valid
        if self._iib_stack is not None:
            self._iib_stack.valid = valid
        if self._kernel_stack is not None:
            ks = self._kernel_stack
            alive = np.zeros(ks.col_ids.shape[1], np.int32)
            alive[: self.n_s] = self._alive
            ks.col_valid = torch.as_tensor(alive[None, :], device=self.device)

    def _stack_bf(self, from_block: int) -> _BFStack:
        """The padded-CSR blocks as (B, s_block, F) device tensors.  On
        ``extend`` the retained prefix stays on the device (its feature axis
        padded if the new rows are wider); only the tail is uploaded."""
        b, sb, f = len(self._blocks), self.s_block, self._idx.shape[1]
        lo = from_block * sb
        idx = np.full(((b - from_block) * sb, f), self.dim, self._idx.dtype)
        val = np.zeros(((b - from_block) * sb, f), self._val.dtype)
        nnz = np.zeros((b - from_block) * sb, self._nnz.dtype)
        idx[: self.n_s - lo] = self._idx[lo:]
        val[: self.n_s - lo] = self._val[lo:]
        nnz[: self.n_s - lo] = self._nnz[lo:]
        dev = self.device
        parts = [torch.as_tensor(idx.reshape(-1, sb, f), device=dev),
                 torch.as_tensor(val.reshape(-1, sb, f), device=dev),
                 torch.as_tensor(nnz.reshape(-1, sb), device=dev)]
        old = self._bf_stack if from_block > 0 else None
        if old is not None:
            oi, ov = old.idx[:from_block], old.val[:from_block]
            pad = f - oi.shape[2]
            if pad > 0:
                oi = torch.cat([oi, torch.full(oi.shape[:2] + (pad,), self.dim, dtype=oi.dtype,
                                               device=dev)], dim=2)
                ov = torch.cat([ov, torch.zeros(ov.shape[:2] + (pad,), dtype=ov.dtype,
                                                device=dev)], dim=2)
            parts = [torch.cat([o, p]) for o, p in zip((oi, ov, old.nnz[:from_block]), parts)]
        ids, valid = self._stack_ids_valid()
        return _BFStack(idx=parts[0], val=parts[1], nnz=parts[2], ids=ids, valid=valid)

    def _stack_iib(self, from_block: int, rank: Optional[torch.Tensor] = None) -> _IIBStack:
        """Every block's tile index with one common ``max_rows`` (the largest
        block bound), stacked in place on the device.  ``rank=None`` gives
        IIB's identity-dim indexes; IIIB passes its frozen rank for the
        threshold-free superset indexes.

        On ``extend`` the retained prefix is copied in and padded to the new
        width with sentinel rows and zero values (a pad, not a rebuild:
        ``index_builds`` counts the tail blocks only).  The stack is
        reallocated whenever B or M grows, so the old and new stacks are
        held together for a moment (about 2 x 330 MiB at synthetic-10k)."""
        b, sb, tile = len(self._blocks), self.s_block, self.tile
        old = self._iib_stack if from_block > 0 else None
        tail = self._blocks[from_block:]
        m = max([blk.bound for blk in tail] + ([old.max_rows] if old else [1]))
        t1 = num_tiles(self.dim, tile) + 1
        rows = torch.empty((b, t1, m), dtype=torch.int32, device=self.device)
        vals = torch.empty((b, t1, m, tile), dtype=torch.float32, device=self.device)
        counts = torch.empty((b, t1), dtype=torch.int32, device=self.device)
        if old is not None:
            om = old.max_rows
            rows[:from_block, :, :om] = old.rows[:from_block]
            vals[:from_block, :, :om] = old.vals[:from_block]
            counts[:from_block] = old.counts[:from_block]
            rows[:from_block, :, om:] = sb
            vals[:from_block, :, om:] = 0.0
            self._iib_stack = old = None   # free the old stack before the tail builds
        for i, blk in enumerate(tail, start=from_block):
            ti = build_tile_index(blk.host.to(self.device), max_rows=m, tile=tile, rank=rank)
            self.stats.index_builds += 1
            blk.list_total = int(ti.counts.sum())
            rows[i], vals[i], counts[i] = ti.rows, ti.vals, ti.counts
            del ti
        ids, valid = self._stack_ids_valid()
        return _IIBStack(rows=rows, vals=vals, counts=counts, ids=ids, valid=valid, max_rows=m)

    def _stack_kernel(self, from_block: int) -> _KernelStack:
        """Dense dim-tiles of all S blocks for the fused kernel, padded to the
        kernel's S-axis block.  Dense tiles are per column, so on ``extend``
        the retained blocks' columns stay on the device and only the tail
        rows are densified."""
        ns = len(self._blocks) * self.s_block
        bs_k = 256 if ns >= 256 else -(-ns // 8) * 8
        ns_pad = -(-ns // bs_k) * bs_k
        keep = from_block * self.s_block
        old = self._kernel_stack if from_block > 0 else None
        f = self._idx.shape[1]
        idx = np.full((ns_pad - keep, f), self.dim, np.int32)
        val = np.zeros((ns_pad - keep, f), np.float32)
        nnz = np.zeros(ns_pad - keep, np.int32)
        idx[: self.n_s - keep] = self._idx[keep:]
        val[: self.n_s - keep] = self._val[keep:]
        nnz[: self.n_s - keep] = self._nnz[keep:]
        tail = from_arrays(idx, val, nnz, self.dim, device=self.device)
        s_tiles = dense_tiles_with_sentinel(tail, self.tile)
        s_occ = _host_row_occupancy(idx, self.dim, self.tile)
        if old is not None:
            s_tiles = torch.cat([old.s_tiles[:, :keep], s_tiles], dim=1)
            s_occ = np.concatenate([old.s_occ[:keep], s_occ])
        cols = np.arange(ns_pad, dtype=np.int32)
        col_valid = np.zeros(ns_pad, np.int32)
        col_valid[: self.n_s] = self._alive
        col_keys = None
        if self._lsh is not None:
            # the band keys follow the flat column layout (alignment-pad
            # columns key 0, masked by col_valid)
            keys = np.zeros((ns_pad, self._lsh.cfg.n_bands), np.int32)
            keys[:ns] = np.concatenate([blk.lshkeys for blk in self._blocks])
            col_keys = torch.as_tensor(keys[None], device=self.device)
        return _KernelStack(
            s_tiles=s_tiles,
            s_occ=s_occ,
            col_valid=torch.as_tensor(col_valid[None, :], device=self.device),
            col_ids=torch.as_tensor(np.where(cols < self.n_s, cols, -1)[None, :],
                                    device=self.device),
            block_s=bs_k,
            col_keys=col_keys,
        )

    # -- introspection ------------------------------------------------------

    @property
    def num_vectors(self) -> int:
        return self.n_s

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    @property
    def occupied_tiles(self) -> int:
        """Number of dim-tiles S actually touches (planner statistic)."""
        return self._occupied_tiles

    @property
    def max_weight(self) -> np.ndarray:
        """(D,) maxWeight_d(S), the S-side mirror of IIIB's R-side bound;
        computed lazily (extend() invalidates it), off the query path."""
        if self._max_weight is None:
            valid = self._idx < self.dim
            mw = np.zeros(self.dim, np.float32)
            np.maximum.at(mw, np.where(valid, self._idx, 0).ravel(),
                          np.where(valid, self._val, 0.0).ravel())
            self._max_weight = mw
        return self._max_weight

    def plan_for(self, R) -> JoinPlan:
        """Resolved plan for querying with R (a SparseBatch or shape tuple)."""
        n_r, f_r, _ = _shape_stats(R)
        spec = dataclasses.replace(self.spec, algorithm=self.algorithm, s_block=self.s_block)
        return plan((n_r, f_r, self.dim), (self.n_s, self._f_mean, self.dim), spec,
                    occupied_tiles=self._occupied_tiles, calibration=self.calibration)

    # -- query --------------------------------------------------------------

    def _warm_start_sample(self):
        """IIIB warm start: the sorted ids of a ``warm_start`` fraction of S
        (at least k rows, live rows only, the reference's sampler and seed),
        their (n_s,) mask and their batch on the device; (None,) * 3 when
        off."""
        spec = self.spec
        if not (spec.warm_start > 0 and self.algorithm == "iiib"):
            return None, None, None
        m = max(int(self.n_s * spec.warm_start), spec.k)
        rng = np.random.default_rng(spec.seed)
        (pool,) = np.nonzero(self._alive)      # a tombstoned row is never offered
        ids = np.sort(rng.choice(pool, size=min(m, pool.size), replace=False))
        mask = np.zeros(self.n_s, bool)
        mask[ids] = True
        block = from_arrays(self._idx[ids], self._val[ids], self._nnz[ids], self.dim,
                            device=self.device)
        return ids, mask, block

    def _r_band_keys(self, r_idx, r_val, r_nnz, r0: int, rb: int, r_valid: np.ndarray):
        """One R block's band keys (rb, n_bands) plus its real-row mask:
        padded AND empty rows (nnz = 0) stay out of the candidate union."""
        stop = min(r0 + rb, r_idx.shape[0])
        keys = np.zeros((rb, self._lsh.cfg.n_bands), np.int32)
        keys[: stop - r0] = self._lsh.keys_host(r_idx[r0:stop], r_val[r0:stop])
        real = r_valid.copy()
        real[: stop - r0] &= r_nnz[r0:stop] > 0
        return keys, real

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

        ``accuracy`` overrides the spec per query: ``"approx"`` (the index
        must be built with ``target_recall``) adds one band-lookup pass per
        R block whose candidate mask folds into the valid masks, and one
        more sync, the candidate count's pull (cached mode); ``"exact"`` on
        an approx-built index skips the mask and equals an exact-built
        index bit for bit.
        """
        t_q = time.perf_counter()
        stats = stats if stats is not None else JoinStats()
        if R.dim != self.dim:
            raise ValueError(f"dim mismatch: index has {self.dim}, got {R.dim}")
        spec, algorithm, dev = self.spec, self.algorithm, self.device
        acc = accuracy if accuracy is not None else spec.accuracy
        if acc not in ("exact", "approx"):
            raise ValueError(f"unknown accuracy {acc!r}")
        approx = acc == "approx"
        if approx and self._lsh is None:
            raise ValueError(
                "index was built without the LSH band tier; build with "
                "target_recall (or accuracy='approx') to enable approx queries")
        k, tile, cached = spec.k, self.tile, self._cache_device
        n_r = R.num_vectors
        rb = min(spec.r_block or self.plan_for(R).r_block, n_r)
        r_idx = R.indices.cpu().numpy()
        r_val = R.values.cpu().numpy()
        r_nnz = R.nnz.cpu().numpy()
        sampled_ids, sampled_mask, sample_block = self._warm_start_sample()
        if sampled_ids is not None:
            sampled_dev = torch.as_tensor(sampled_ids.astype(np.int32), device=dev)

        out_scores, out_ids = [], []
        for r0 in range(0, n_r, rb):
            # a leaf span per R block, parented to whatever span is active
            # on this thread (None when tracing is off)
            span = obs_trace.start_span("engine.r_block", r0=r0, algorithm=algorithm)
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

            # approximate tier: one band-lookup pass gives the candidate mask
            # that the exact drivers re-rank (it ANDs into the valid masks)
            cand = None        # device (B, s_block) — cached walks
            cand_np = None     # host (B, s_block) — streaming loops
            col_cand = None    # device (1, NS_pad) — fused kernel
            cand_count = None  # device scalar, pulled with the result
            if approx:
                r_keys, r_real = self._r_band_keys(r_idx, r_val, r_nnz, r0, rb, r_valid)
                if cached:
                    rk = torch.as_tensor(r_keys, device=dev)
                    rr = torch.as_tensor(r_real, device=dev)
                if cached and spec.use_kernel and algorithm == "iib":
                    ks = self._kernel_stack
                    col_cand, cand_count = lsh_mod.candidate_mask(
                        rk, rr, ks.col_keys[0], ks.col_valid[0] != 0)
                    col_cand = col_cand[None]
                    stats.device_dispatches += 1
                    stats.scanned_rows += self.live_rows
                elif cached:
                    live = self._sampled_valid(sampled_mask)
                    cand, cand_count = lsh_mod.candidate_mask(
                        rk, rr, self._lsh_stack, torch.as_tensor(live, device=dev))
                    stats.device_dispatches += 1
                    stats.scanned_rows += int(live.sum())
                else:
                    # streaming keeps S on the host: the host twin of the mask
                    live = self._sampled_valid(sampled_mask)
                    cand_np = lsh_mod.candidate_mask_host(
                        r_keys, r_real, np.stack([blk.lshkeys for blk in self._blocks]))
                    stats.scanned_rows += int(live.sum())
                    stats.candidate_rows += int((cand_np & live).sum())

            if algorithm == "bf":
                if cached:
                    state = self._query_bf_scanned(state, br, stats, rb, cand)
                else:
                    state = self._query_pairs(state, br, None, None, stats, rb, cand_np)
            elif algorithm == "iib" and spec.use_kernel and cached:
                state = self._query_fused_kernel(br, idx, stats, n_valid, col_cand)
            elif algorithm == "iib":
                prep = prepare_r_block_inputs(br, idx, "iib", tile,
                                              with_r_tiles=not spec.use_kernel)
                if cached:
                    state = self._query_iib_scanned(state, prep["r_tiles"], prep["tiles"], stats,
                                                    cand)
                else:
                    state = self._query_pairs(state, br, prep.get("r_tiles"), prep["tiles"],
                                              stats, rb, cand_np)
            else:   # iiib — masked superset refinement, threshold in the carry
                prep = prepare_r_block_inputs(br, idx, "iiib", tile, rank_np=self._rank_np,
                                              rank_dev=self._rank_dev)
                rv = torch.as_tensor(r_valid, device=dev)
                if cached:
                    state, aux = self._query_iiib_scanned(
                        state, prep["r_tiles"], prep["mwt"], prep["tiles"], stats, sampled_mask,
                        rv, cand)
                else:
                    state = self._query_pairs_iiib(
                        state, prep["r_tiles"], prep["mwt"], prep["tiles"], stats, sampled_mask,
                        rv, cand_np)

            # the R block's result pull (IIIB's trace and counts ride along)
            out_scores.append(state.scores[:n_valid].cpu())
            out_ids.append(state.ids[:n_valid].cpu())
            if aux is not None:
                stats.list_entries += int(aux["kept"].sum())
                thr = aux["thr"].cpu().numpy()
                stats.min_prune_trace.append(thr)
                observe_thresholds(thr)
            if cand_count is not None:
                stats.candidate_rows += int(cand_count)
                stats.host_syncs += 1            # the candidate count's pull
            stats.host_syncs += 1
            obs_trace.end_span(span)

        dt = time.perf_counter() - t_q
        stats.query_wall_s += dt
        self.stats.query_wall_s += dt
        return JoinResult(scores=torch.cat(out_scores).to(dev), ids=torch.cat(out_ids).to(dev),
                          stats=stats)

    def kernel_inputs(self, br: SparseBatch, r_idx: np.ndarray, n_valid: int,
                      col_cand: Optional[torch.Tensor] = None):
        """(args, kwargs, active entries) of the cached path's
        ``knn_topk_fused`` call for one padded R block ``br`` (host indices
        ``r_idx``, ``n_valid`` real rows), a fresh top-k state and the
        stack's live columns, times the (1, NS_pad) candidate mask
        ``col_cand`` of an approx query: the engine's own shapes, also for
        holding the kernel against its plain version."""
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
        col_valid = ks.col_valid if col_cand is None else ks.col_valid * col_cand.to(torch.int32)
        args = (r_tiles, ks.s_tiles, torch.as_tensor(active, device=self.device),
                col_valid, ks.col_ids, init_s, init_i)
        kwargs = dict(thr=thr, block_r=br_k, block_s=ks.block_s,
                      nr_valid=torch.full((1,), n_valid, dtype=torch.int32, device=self.device))
        n_active = int((active < num_tiles(self.dim, self.tile)).sum())
        return args, kwargs, n_active

    # -- cached drivers: one driver call per R block --------------------------

    def _query_bf_scanned(self, state, br, stats, rb, cand=None):
        st = self._bf_stack
        b = len(self._blocks)
        valid = st.valid if cand is None else st.valid & cand
        state = bf_scan_join(state, br, st.idx, st.val, st.nnz, st.ids, valid, dim=self.dim)
        stats.device_dispatches += 1
        stats.blocks += b
        stats.dense_pairs += rb * self.s_block * b
        return state

    def _query_iib_scanned(self, state, r_tiles, tiles, stats, cand=None):
        st = self._iib_stack
        b = len(self._blocks)
        valid = st.valid if cand is None else st.valid & cand
        state = iib_scan_join(state, r_tiles, tiles, st.rows, st.vals, st.counts, st.ids,
                              valid, tile=self.tile, num_s=self.s_block)
        stats.device_dispatches += 1
        stats.blocks += b
        stats.tiles_scored += int(tiles.shape[0]) * b
        stats.list_entries += sum(blk.list_total for blk in self._blocks)
        return state

    def _sampled_valid(self, sampled_mask: Optional[np.ndarray]) -> np.ndarray:
        """(B, s_block) bool — padding, tombstoned AND warm-start-sampled rows
        masked out (the sampled rows were offered by the warm-start pass).
        The cached walk stacks it, the streaming loop slices it."""
        b, sb = len(self._blocks), self.s_block
        valid = np.arange(b * sb) < self.n_s
        valid[: self.n_s] &= self._alive
        if sampled_mask is not None:
            valid[: self.n_s] &= ~sampled_mask
        return valid.reshape(b, sb)

    def _block_valid(self, blk: _SBlock) -> np.ndarray:
        """(s_block,) bool — one block's padding mask with tombstones folded
        in (the streaming loops' counterpart of the stack's valid mask)."""
        v = blk.valid.copy()
        hi = min(blk.start + self.s_block, self.n_s)
        v[: hi - blk.start] &= self._alive[blk.start:hi]
        return v

    def _query_iiib_scanned(self, state, r_tiles, mwt, tiles, stats, sampled_mask, rv,
                            cand=None):
        """IIIB's whole S side as one driver call, (TopKState,
        MinPruneScore) in the carry: the warm-started threshold seeds it as
        a device scalar, and the per-block trace and kept-entry counts stay
        on the device until the R block's result pull."""
        st = self._iib_stack
        b = len(self._blocks)
        thr0 = min_prune_score(state, valid=rv)     # device scalar, warm start included
        s_valid = torch.as_tensor(self._sampled_valid(sampled_mask), device=self.device)
        if cand is not None:
            s_valid = s_valid & cand
        state, _, thr_trace, kept = iiib_scan_join(
            state, thr0, r_tiles, mwt, tiles, st.rows, st.vals, st.counts, self._mass_stack,
            st.ids, s_valid, rv, tile=self.tile, num_s=self.s_block)
        stats.device_dispatches += 1
        stats.blocks += b
        stats.tiles_scored += int(tiles.shape[0]) * b
        # trace = [seed, after block 0, ..., after block B-1]
        return state, {"thr": torch.cat([thr0[None], thr_trace]), "kept": kept}

    def _query_fused_kernel(self, br, r_idx, stats, n_valid, col_cand=None):
        """One fused score→top-k launch covers every S block.  The
        threshold starts at the fresh state's MinPruneScore and rises inside
        the kernel across the S blocks; ``n_valid`` keeps padding rows out
        of the threshold reduce; tombstoned and (approx) non-candidate
        columns are 0 in ``col_valid``.  For k > 128 a score launch and a
        merge launch for each window of the stack take its place
        (``join_topk``, the same outputs; a window holds at most
        ``MAX_SCORES`` scores)."""
        args, kwargs, n_active = self.kernel_inputs(br, r_idx, n_valid, col_cand)
        out_s, out_i = join_topk(*args, **kwargs)
        stats.device_dispatches += 1
        stats.blocks += len(self._blocks)
        stats.tiles_scored += n_active
        rb = br.num_vectors
        return TopKState(scores=out_s[:rb], ids=out_i[:rb])

    # -- per-pair loops (streaming mode) -------------------------------------

    def _query_pairs(self, state, br, r_tiles, tiles, stats, rb, cand_np=None):
        """Algorithm 1's inner loop for BF and IIB: one step per (B_r, B_s)
        pair on transient device blocks (O(block) device memory)."""
        sb, tile = self.s_block, self.tile
        for bi, blk in enumerate(self._blocks):
            bs = blk.host.to(self.device)     # transient, per pair
            bv = self._block_valid(blk)
            if cand_np is not None:
                bv = bv & cand_np[bi]
            stats.blocks += 1
            if self.algorithm == "bf":
                state = bf_join_block(state, br, bs, blk.start,
                                      torch.as_tensor(bv, device=self.device))
                stats.dense_pairs += rb * sb
                stats.device_dispatches += 1
            elif self.spec.use_kernel:
                state = knn_topk(
                    br, bs, state=state, s_offset=blk.start, s_valid=bv,
                    tile=tile, block_r=min(256, rb), block_s=min(256, sb),
                    device=self.device,
                )
                stats.tiles_scored += int(tiles.shape[0])
                stats.device_dispatches += 1
            else:
                index = build_tile_index(bs, max_rows=blk.bound, tile=tile)
                stats.index_builds += 1
                self.stats.index_builds += 1
                entries = int(index.counts.sum())
                stats.host_syncs += 1
                state = iib_join_block(state, r_tiles, index, tiles, blk.start,
                                       torch.as_tensor(bv, device=self.device))
                stats.tiles_scored += int(tiles.shape[0])
                stats.list_entries += entries
                stats.device_dispatches += 2
        return state

    def _query_pairs_iiib(self, state, r_tiles, mwt, tiles, stats, sampled_mask, rv,
                          cand_np=None):
        """Streaming IIIB: the cached walk's masked-superset step, driven per
        pair — the superset index is built per (B_r, B_s) pair and the
        threshold round-trips through the host (the same arrays as the
        cached walk; that walk removes the rebuilds and the syncs)."""
        s_valid = self._sampled_valid(sampled_mask)
        if cand_np is not None:
            s_valid = s_valid & cand_np
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


# ---------------------------------------------------------------------------
# distributed face (mesh join)
# ---------------------------------------------------------------------------

def distributed_join(
    R: SparseBatch,
    S: SparseBatch,
    spec: JoinSpec,
    mesh,
    *,
    ring_axes: Sequence[str] = ("data",),
    dim_axis: Optional[str] = None,
    n_r_valid: Optional[int] = None,
    n_s_valid: Optional[int] = None,
) -> TopKState:
    """Mesh-distributed query: the engine face of the multi-device join.

    ``mesh`` is a ``launch/mesh.py::DeviceMesh``.  By default S is
    partitioned over ``ring_axes`` into the sharded store's per-shard index
    stacks (``repro_torch.store.ShardedKNNStore``, built once) and every R
    block is one fan-out with a top-k reduction.  The ring driver
    (``core/ring.py::_ring_join_impl``) runs instead for ``dim_axis``
    (dimension-sharded tensor parallelism, which the store does not cover)
    and when S has fewer valid rows than ring positions (the store needs a
    row a shard).  The reference's third route, traced inputs under
    ``jax.jit`` (the dry-run compiling the whole join as one program), has
    no counterpart: nothing here is traced.  Returns a TopKState over all
    of R's rows (padding rows past ``n_r_valid`` empty) on the mesh's first
    device.
    """
    n_r, n_s = R.num_vectors, S.num_vectors
    n_r_valid = n_r if n_r_valid is None else n_r_valid
    n_s_valid = n_s if n_s_valid is None else n_s_valid
    n_ring = math.prod(mesh.shape[a] for a in ring_axes)
    if dim_axis is not None or n_s_valid < n_ring:
        from repro_torch.core.ring import _ring_join_impl

        return _ring_join_impl(
            R, S, spec.k, mesh,
            algorithm=spec.algorithm or "iiib",
            ring_axes=ring_axes, dim_axis=dim_axis, tile=spec.tile,
            n_r_valid=n_r_valid, n_s_valid=n_s_valid,
        )
    # imported here: the store imports this module
    from repro_torch.store import ShardedKNNStore

    # the ring API let callers pad R/S to the ring size; the store needs
    # neither the padding nor the divisibility, so strip it
    store = ShardedKNNStore(
        S.rows(0, n_s_valid), dataclasses.replace(spec, algorithm=spec.algorithm or "iiib"),
        mesh=mesh, axes=tuple(ring_axes),
    )
    res = store.query(R.rows(0, n_r_valid))
    pad = n_r - n_r_valid
    if not pad:
        return res.state
    k, dev = res.scores.shape[1], res.scores.device
    return TopKState(
        scores=torch.cat([res.scores, torch.full((pad, k), NEG_INF, device=dev)]),
        ids=torch.cat([res.ids, torch.full((pad, k), -1, dtype=torch.int32, device=dev)]),
    )
