"""Build-once/query-many KNN join engine: the fused-kernel IIB path.

The PyTorch counterpart of ``repro.core.engine`` for the exact IIB join
through the fused score→top-k kernel (kernels/knn_topk), in both of its
modes:

  * cached (``cache_device_blocks=True``): ``build`` stacks the dense
    dim-tiles of every S block on the device once, and one kernel launch
    per R block covers every S block.
  * streaming (``cache_device_blocks=False``, what ``knn_join`` uses): one
    kernel launch per (R block, S block) pair on transient device blocks.

Block geometry, candidate rule, tie order and the work counters follow
the reference, so ``tiles_scored`` and ``device_dispatches`` equal its
counts.  Every other option of the reference engine raises
``NotImplementedError`` naming the ROADMAP.md queue item that ports it.

For k > 128 (the fused kernel's ``MAX_K``) both modes take the score
kernel, the candidate mask and the merge kernel instead
(``kernels/knn_topk/ops.py::join_topk``), which give the fused kernel's
outputs bit for bit; the counters count as before.

Entry points run on ``device`` — CUDA unless the caller passes
``device="cpu"``, where the kernel's plain version runs.  Host-side numpy
work (padding, occupancy, active lists) stays on the host, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import active_tile_list
from repro_torch.core.topk import TopKState, init_topk, min_prune_score
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

_QUEUE_SCANS = "ROADMAP.md queue 1 item 4 (the BF/IIB/IIIB scans)"
_QUEUE_ENGINE = "ROADMAP.md queue 1 item 5 (engine)"
_QUEUE_LSH = "ROADMAP.md queue 1 item 6 (approx tier)"


def _not_ported(what: str, queue: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet: {queue}")


@dataclasses.dataclass
class JoinStats:
    """Work accounting for the paper's cost-model comparisons (C2 vs C3)."""

    blocks: int = 0
    tiles_scored: int = 0          # tile-matmul count of the indexed work
    index_builds: int = 0          # S-block index constructions
    device_dispatches: int = 0     # engine-level device launches
    host_syncs: int = 0            # device→host reads on the query path
    build_wall_s: float = 0.0      # time spent inside build()
    query_wall_s: float = 0.0      # time spent inside query()


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


def _host_row_occupancy(idx: np.ndarray, dim: int, tile: int) -> np.ndarray:
    """(N, T) bool — per-row dim-tile occupancy, computed host-side (numpy)."""
    t_total = num_tiles(dim, tile)
    tid = np.where(idx < dim, idx // tile, t_total)
    occ = np.zeros((idx.shape[0], t_total + 1), dtype=bool)
    occ[np.arange(idx.shape[0])[:, None], tid] = True
    return occ[:, :t_total]


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
    """One S block: host mirror (CPU tensors) plus its padding mask."""

    host: SparseBatch
    valid: np.ndarray        # (s_block,) bool
    start: int               # global row offset


class SparseKNNIndex:
    """Build-once/query-many index over the inner join set S (fused-kernel
    IIB path).  ``cache_device_blocks=False`` keeps only host mirrors and
    uploads each S block per (B_r, B_s) pair — the streaming profile that
    ``knn_join`` uses."""

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
        if frozen_rank is not None:
            raise _not_ported("frozen_rank (the IIIB superset order)", _QUEUE_SCANS)
        if calibration is not None:
            raise _not_ported("planner calibration", _QUEUE_ENGINE)
        if lsh_cfg is not None or spec.accuracy == "approx":
            raise _not_ported("accuracy='approx'", _QUEUE_LSH)
        if spec.warm_start > 0:
            raise _not_ported("warm_start", _QUEUE_ENGINE)
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
        self._f_mean = float(self._nnz.mean())
        dims = np.unique(self._idx[self._idx < self.dim])
        self._occupied_tiles = int(np.unique(dims // self.tile).size) if dims.size else 1

        f_mean = self._f_mean
        p = plan((self.n_s, f_mean, self.dim), (self.n_s, f_mean, self.dim), spec,
                 occupied_tiles=self._occupied_tiles)
        self.algorithm = spec.algorithm or p.algorithm
        if self.algorithm != "iib" or not spec.use_kernel:
            raise _not_ported(
                f"algorithm={self.algorithm!r} with use_kernel={spec.use_kernel} "
                "(only algorithm='iib' with use_kernel=True is)", _QUEUE_SCANS)
        self.s_block = max(1, min(spec.s_block or p.s_block, self.n_s))

        self._blocks: List[_SBlock] = []
        self._kernel_stack: Optional[_KernelStack] = None
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
        if self._cache_device:
            self._kernel_stack = self._stack_kernel()

    def _make_block(self, start: int) -> _SBlock:
        stop = min(start + self.s_block, self.n_s)
        idx, val, nnz, valid = _pad_rows_np(
            self._idx[start:stop], self._val[start:stop], self._nnz[start:stop],
            self.dim, self.s_block, copy_unpadded=True,
        )
        return _SBlock(host=from_arrays(idx, val, nnz, self.dim), valid=valid, start=start)

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

    def plan_for(self, R) -> JoinPlan:
        """Resolved plan for querying with R (a SparseBatch or shape tuple)."""
        n_r, f_r, _ = _shape_stats(R)
        spec = dataclasses.replace(self.spec, algorithm=self.algorithm, s_block=self.s_block)
        return plan((n_r, f_r, self.dim), (self.n_s, self._f_mean, self.dim), spec,
                    occupied_tiles=self._occupied_tiles)

    # -- query --------------------------------------------------------------

    def query(
        self,
        R: SparseBatch,
        stats: Optional[JoinStats] = None,
        accuracy: Optional[str] = None,
    ) -> JoinResult:
        """R ⋈_KNN S.  Returns global S ids, on the index's device.

        Cached mode makes one kernel launch per R block; streaming mode one
        per (R block, S block) pair.
        """
        t_q = time.perf_counter()
        stats = stats if stats is not None else JoinStats()
        if R.dim != self.dim:
            raise ValueError(f"dim mismatch: index has {self.dim}, got {R.dim}")
        if accuracy not in (None, "exact"):
            raise _not_ported(f"accuracy={accuracy!r}", _QUEUE_LSH)
        k = self.spec.k
        n_r = R.num_vectors
        rb = min(self.spec.r_block or self.plan_for(R).r_block, n_r)
        r_idx = R.indices.cpu().numpy()
        r_val = R.values.cpu().numpy()
        r_nnz = R.nnz.cpu().numpy()

        out_scores, out_ids = [], []
        for r0 in range(0, n_r, rb):
            stop = min(r0 + rb, n_r)
            idx, val, nnz, _ = _pad_rows_np(
                r_idx[r0:stop], r_val[r0:stop], r_nnz[r0:stop], self.dim, rb)
            br = from_arrays(idx, val, nnz, self.dim, device=self.device)
            n_valid = stop - r0
            if self._cache_device:
                state = self._query_fused_kernel(br, idx, stats, n_valid)
            else:
                state = init_topk(rb, k, device=self.device)
                tiles = active_tile_list(_host_row_occupancy(idx, self.dim, self.tile).any(axis=0))
                state = self._query_pairs(state, br, tiles, stats, rb)
            out_scores.append(state.scores[:n_valid])
            out_ids.append(state.ids[:n_valid])

        dt = time.perf_counter() - t_q
        stats.query_wall_s += dt
        self.stats.query_wall_s += dt
        return JoinResult(scores=torch.cat(out_scores), ids=torch.cat(out_ids), stats=stats)

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

    def _query_pairs(self, state, br, tiles, stats, rb):
        """The per-pair loop: one fused-kernel launch per (B_r, B_s) pair on
        transient device blocks (O(block) device memory)."""
        sb = self.s_block
        for blk in self._blocks:
            bs = blk.host.to(self.device)
            stats.blocks += 1
            state = knn_topk(
                br, bs, state=state, s_offset=blk.start, s_valid=blk.valid,
                tile=self.tile, block_r=min(256, rb), block_s=min(256, sb),
                device=self.device,
            )
            stats.tiles_scored += int(tiles.shape[0])
            stats.device_dispatches += 1
            # the op reads both blocks' tile occupancy back to the host
            stats.host_syncs += 2
        return state
