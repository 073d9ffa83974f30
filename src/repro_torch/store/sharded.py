"""ShardedKNNStore over a device mesh: build-once-per-shard indexes, a
fan-out query merged through the topk_merge kernel, delete/TTL
tombstones, and replica failover (the PyTorch counterpart of
``repro.store.sharded``, DESIGN.md §7, §10).

Serving one big S to heavy query traffic takes the standard distributed
kNN-join decomposition (Lu et al., "Efficient Processing of k Nearest
Neighbor Joins using MapReduce"): partition S row-wise, join every query
block against every partition, merge the per-partition top-k.  As in the
reference, shard ``i`` lies on the device at position ``i`` of a mesh
(``launch/mesh.py::DeviceMesh``); one process drives every device.  A
mesh may repeat one device, and without one (``num_shards=``,
``device=``) every shard lies on one device:

* **Shard layout.**  S is split into contiguous row ranges
  (``np.array_split``).  Each shard's index structures are built ONCE: the
  padded-CSR blocks (BF), the tile inverted indexes (IIB) or the
  threshold-free superset indexes and tile mass (IIIB, in the GLOBAL
  datastore's dim-frequency rank, so every shard prunes as the single
  build over the concatenated S does).  The plan, and with it the block
  size, is made once at store level.  The per-shard stacks are padded to
  the cross-shard maxima and stacked into ``(num_shards, blocks, ...)``
  tensors, and each replica places them on its devices
  (``launch/sharding.py::store_put``: per leaf, shard ``i``'s slice on
  shard ``i``'s device).

* **Replicas.**  ``replicas=`` (or a mesh axis named ``'replica'``, split
  by ``launch/mesh.py::replica_submeshes``) places the SAME stacks once
  per replica, each replica in tensors of its own (the host mirror is the
  single source of truth; a replica is a pure function of it, never a view
  of another replica).  Each fan-out routes to exactly one replica —
  half-open probes first, then live clean replicas round-robin, then lossy
  ones, dead replicas never — and a
  ``ShardLostError``/``ReplicaLostError`` at dispatch fails over to the
  next replica within the same R block, so callers see FULL results
  through a replica loss.  Health is a circuit breaker per replica
  (``runtime.fault.ReplicaHealth``); mutations write through to every
  non-dead replica and queue dirty shards for dead ones;
  :meth:`resync_replicas` re-places the missed slices and re-admits the
  replica half-open; :meth:`verify_replicas` audits bit-parity.

* **Fan-out query.**  ``query(R)`` prepares each R block's inputs once
  (``engine.prepare_r_block_inputs``: they depend only on R and on
  build-frozen statistics), sends them to each shard's device, and
  launches the shards' walks in shard order with no host sync between
  them, so the walks of distinct devices overlap: each shard runs the
  engine's driver (``bf_scan_join``/``iib_scan_join``/``iiib_scan_join``)
  over its slice of the replica's stacks from a fresh top-k state, and
  ``core.topk.tree_reduce_topk`` gathers the shards' states to the first
  shard's device and merges them.  Every block step and every merge of the
  reduction is a topk_merge launch on CUDA.  One dispatch and one host
  sync (the result pull) per R block, whatever the shard or replica count,
  and no query-time index build.  Results equal a single SparseKNNIndex
  over the concatenated S: shards hold ascending global-id ranges and the
  reduction keeps the lower shard on the tie-winning side.

* **Mutability.**  ``add()`` appends a batch to the shard with the fewest
  live rows, with fresh global ids, rebuilding only that shard's tail
  blocks; while the padded geometry is unchanged, placement is
  INCREMENTAL — only the touched shard's slice is copied into each
  replica's tensors (``StoreStats.placed_shards``/``placed_bytes``) — and
  a grown geometry re-places everything.  ``delete(ids)`` and TTL expiry
  (``add(..., ttl=)`` + ``expire(now)``) tombstone rows by the valid masks
  only; ``compact()``, triggered automatically once a shard's dead
  fraction crosses ``auto_compact``, is the real rebuild.  Global ids stay
  stable.  Once ``add()`` has landed a batch on a non-tail shard, ids are
  no longer ascending in shard order, so against a single index built in
  append order scores stay exact but ids may differ where scores tie
  EXACTLY (ties go to the lower shard, not the lower id).

IIIB's MinPruneScore evolves shard-locally (each shard's walk carries its
own, from -inf): the work differs from one walk over all of S, the result
does not.

* **Durability** (DESIGN.md §9).  ``save(d)`` commits ONE logical copy
  (each shard's host mirror, tombstone and TTL state, id stack, and the
  frozen IIIB rank) through ``repro_torch.checkpoint`` as leaves whose
  paths, order and bytes are the reference's, so either package loads
  the other's checkpoints; ``save_dirty`` hard-links the shards untouched
  since the last commit.  ``load(d)`` warm-restarts (elastically: any
  shard count) and answers bit for bit the saved store; ``recover(d)``
  rebuilds only the lost shards from their sha-verified slices.

Not here: the HLO hook ``lowered_fanout`` (no HLO; see
``obs/profile.py::fanout_report``).  Without a mesh the store runs on
``device`` — CUDA unless the caller passes ``device="cpu"``; with one, its
results come back to the first shard's device.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import iiib as iiib_mod
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.bf import bf_scan_join
from repro_torch.core.engine import (
    JoinResult,
    JoinSpec,
    JoinStats,
    SparseKNNIndex,
    _pad_feature_axis,
    _pad_rows_np,
    _shape_stats,
    load_calibration,
    observe_thresholds,
    plan,
    prepare_r_block_inputs,
)
from repro_torch.core.iib import iib_scan_join
from repro_torch.core.iiib import iiib_scan_join
from repro_torch.core.index import build_tile_index
from repro_torch.core.topk import init_topk, tree_reduce_topk
from repro_torch.device import resolve_device, to_device
from repro_torch.launch.mesh import DeviceMesh, make_store_mesh, replica_submeshes
from repro_torch.launch.sharding import (
    placed_numpy,
    placed_shape,
    store_put,
    store_shard_update,
)
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault import ReplicaHealth, ReplicaLostError, ShardLostError
from repro_torch.sparse.format import SparseBatch, from_arrays


class StoreStats:
    """Store-lifetime work accounting (per-query numbers live in the
    JoinStats each ``query()`` returns).

    Every counter attribute is backed by a typed instrument in
    ``self.registry`` (repro_torch.obs.registry): the attribute API
    (``stats.queries += 1``) and the OpenMetrics text exposition
    (``stats.expose()``) read the same cells."""

    # attribute → (instrument name, help)
    _COUNTERS = {
        "queries": ("store_queries", "query() calls"),
        "device_dispatches": ("store_device_dispatches",
                              "fan-out dispatches (one per R block)"),
        "host_syncs": ("store_host_syncs", "result pulls (one per R block)"),
        "index_builds": ("store_index_builds",
                         "per-shard S-block index constructions"),
        "stack_uploads": ("store_stack_uploads",
                          "placement events (full OR incremental)"),
        "placed_shards": ("store_placed_shards",
                          "per-(replica, shard) slices shipped"),
        "placed_bytes": ("store_placed_bytes",
                         "bytes shipped host->device by placements"),
        "build_wall_s": ("store_build_wall_seconds",
                         "time inside build()/extend()"),
        "query_wall_s": ("store_query_wall_seconds", "time inside query()"),
        "deleted": ("store_rows_deleted", "rows tombstoned via delete()"),
        "expired": ("store_rows_expired", "rows tombstoned via TTL expiry"),
        "compactions": ("store_compactions",
                        "shard compactions (real rebuilds)"),
        "saves": ("store_saves", "checkpoint commits (save / save_dirty)"),
        "save_wall_s": ("store_save_wall_seconds", "time inside save()"),
        "shard_losses": ("store_shard_losses",
                         "shard copies marked lost by failures"),
        "degraded_queries": ("store_degraded_queries",
                             "queries served with shards missing"),
        "recoveries": ("store_recoveries",
                       "shards rebuilt from a checkpoint slice"),
        "recovery_wall_s": ("store_recovery_wall_seconds",
                            "time inside recover()"),
        "replica_losses": ("store_replica_losses",
                           "replicas marked dead (health transitions)"),
        "replica_failovers": ("store_replica_failovers",
                              "blocks served by a non-first-choice replica"),
        "resyncs": ("store_resyncs", "replica anti-entropy re-placements"),
        "resync_wall_s": ("store_resync_wall_seconds",
                          "time inside resync_replicas()"),
    }

    def __init__(self, registry=None):
        from repro_torch.obs.registry import MetricRegistry

        object.__setattr__(self, "_inst", {})
        reg = registry or MetricRegistry()
        self.registry = reg
        for attr, (name, hlp) in self._COUNTERS.items():
            self._inst[attr] = reg.counter(name, hlp)
        # fan-out attempts routed to each replica (plain dict: labelled
        # per-replica counters stay host-side scratch)
        self.replica_dispatches: Dict[int, int] = {}

    def __getattr__(self, name):
        inst = object.__getattribute__(self, "__dict__").get("_inst", {}).get(name)
        if inst is not None:
            return inst.value
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}")

    def __setattr__(self, name, value):
        inst = self.__dict__.get("_inst", {}).get(name)
        if inst is not None:
            inst.set(value)
        else:
            object.__setattr__(self, name, value)

    def expose(self) -> str:
        """OpenMetrics-style text exposition of the store counters."""
        return self.registry.expose()


def _inputs_on(dev: torch.device, br: SparseBatch, prep: dict, *tensors):
    """An R block's prepared inputs on ``dev`` (to a CUDA device without a
    host sync; nothing is copied where they already lie)."""
    def put(x):
        return to_device(x, dev) if isinstance(x, torch.Tensor) else x

    return (br.to(dev), {k: put(v) for k, v in prep.items()}) + tuple(put(t) for t in tensors)


class ShardedKNNStore:
    """Build-once-per-shard, query-many, mutable KNN datastore over a mesh.

    ``spec`` follows the engine's JoinSpec; open fields are resolved once,
    globally, so every shard uses the same algorithm and block geometry.
    ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`) holds the
    shards: ``axes`` names the mesh axis (or axes — they flatten into the
    shard order) that S is partitioned over, by default every axis but
    ``'replica'``, or the first; a mesh axis named ``'replica'`` that is
    not in ``axes`` is the replication dimension.  Without a mesh,
    ``num_shards`` (default 1) row ranges of S are held on ``device``
    (CUDA unless named), once per replica (``replicas``): the mesh of that
    one device repeated.  ``replica_fail_threshold`` is the health
    tracker's consecutive-failure threshold (a single shard-copy loss
    below it keeps the replica routable; a whole-replica loss kills it at
    once).  ``use_kernel`` and ``warm_start`` are engine-only (the fused
    kernel and the sampled warm start assume one resident stack) and are
    rejected, as in the reference.
    """

    def __init__(
        self,
        S: SparseBatch,
        spec: JoinSpec,
        num_shards: Optional[int] = None,
        auto_compact: float = 0.5,
        calibration=None,
        replicas: int = 1,
        replica_fail_threshold: int = 2,
        device=None,
        mesh=None,
        axes: Optional[Sequence[str]] = None,
        *,
        _row_ids: Optional[np.ndarray] = None,
        _alive: Optional[np.ndarray] = None,
        _deadline: Optional[np.ndarray] = None,
        _next_gid: Optional[int] = None,
        _frozen_rank: Optional[np.ndarray] = None,
        _shard_sizes: Optional[Sequence[int]] = None,
        _lsh_cfg: Optional[dict] = None,
    ):
        # The underscored keywords are the checkpoint-restore channel used
        # by :meth:`load`: per-row state (global ids, tombstone masks, TTL
        # deadlines, in concatenated shard order), the saved IIIB rank
        # (restored verbatim — recomputing would break bit-parity after
        # post-freeze mutations), and — when the loader's shard count
        # matches the save — the exact saved row split.
        t0 = time.perf_counter()
        if spec.use_kernel:
            raise ValueError("use_kernel is not supported by ShardedKNNStore yet")
        if spec.warm_start:
            raise ValueError("warm_start is not supported by ShardedKNNStore yet")
        if mesh is None:
            if axes is not None:
                raise ValueError("axes= names axes of a mesh; pass mesh= with it")
            n = 1 if num_shards is None else int(num_shards)
            if n < 1:
                raise ValueError(f"num_shards must be >= 1, got {num_shards}")
            mesh = make_store_mesh(n, replicas=replicas,
                                   devices=[resolve_device(device)] * (n * replicas))
        elif device is not None:
            raise ValueError("pass device= or mesh=, not both: the mesh names the devices")
        self._set_mesh(mesh, axes)
        if num_shards is not None and int(num_shards) != self.n_shards:
            raise ValueError(f"num_shards={num_shards} but the mesh holds "
                             f"{self.n_shards} shards over {self._axes}")
        if replicas != 1 and replicas != self.n_replicas:
            raise ValueError(f"replicas={replicas} but the mesh holds "
                             f"{self.n_replicas} replicas")
        self.health = ReplicaHealth(
            self.n_replicas, fail_threshold=replica_fail_threshold)

        self.spec = spec
        self.dim = S.dim
        self.tile = spec.tile
        self.auto_compact = float(auto_compact)
        self.calibration = load_calibration(calibration)
        self.stats = StoreStats()

        n_s = S.num_vectors
        if n_s < self.n_shards:
            raise ValueError(f"S has {n_s} rows < {self.n_shards} shards")

        idx = S.indices.cpu().numpy()
        val = S.values.cpu().numpy()
        nnz = S.nnz.cpu().numpy()

        # resolve algorithm/geometry ONCE at store level (parity with a
        # single build needs every shard on the same plan, including the
        # occupied-tile statistic the engine's own planning uses)
        f_mean = float(nnz.mean()) if n_s else 0.0
        p = plan((n_s, f_mean, self.dim), (n_s, f_mean, self.dim), spec,
                 occupied_tiles=self._occupied_tiles_of(idx),
                 calibration=self.calibration)
        self.algorithm = spec.algorithm or p.algorithm

        # contiguous balanced row ranges (the first n_s % shards ranges get
        # one extra row: np.array_split semantics); a restore onto the SAME
        # shard count reuses the exact saved split so block geometry (and
        # the dispatch shape) round-trips
        restored_split = _shard_sizes is not None and len(_shard_sizes) == self.n_shards
        if restored_split:
            sizes = [int(x) for x in _shard_sizes]
            if sum(sizes) != n_s:
                raise ValueError("restored shard sizes do not cover S")
        else:
            sizes = [len(a) for a in np.array_split(np.arange(n_s), self.n_shards)]
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        if restored_split and spec.s_block:
            # the saved block size, even where a shard compacted below it
            # holds fewer rows (one partial block): the reference re-blocks
            # every shard at the smallest one's size there
            self.s_block = int(spec.s_block)
        else:
            self.s_block = max(1, min(spec.s_block or p.s_block, min(sizes)))

        # IIIB superset order: the GLOBAL datastore's dim-frequency rank,
        # frozen into every shard (a shard-local rank would still be exact
        # but would not match the single-build parity reference)
        self._rank_np: Optional[np.ndarray] = None
        self._rank_dev: Optional[torch.Tensor] = None
        if self.algorithm == "iiib":
            if _frozen_rank is not None:
                self._rank_np = np.asarray(_frozen_rank, np.int32)
            else:
                ok = idx < self.dim
                freq = np.bincount(idx[ok], minlength=self.dim).astype(np.int64)
                self._rank_np = iiib_mod.s_frequency_rank(freq)
            self._rank_dev = torch.as_tensor(self._rank_np, device=self.device)

        # approximate tier: ONE LSHConfig (and projection) shared by every
        # shard and replica — identical band keys everywhere.  A restored
        # store takes the SAVED config (``_lsh_cfg``) so keys round-trip
        # even if the planner changes between versions.
        self._lsh: Optional[lsh_mod.LSHBands] = None
        if spec.accuracy == "approx":
            cfg = (lsh_mod.LSHConfig(**_lsh_cfg) if _lsh_cfg is not None
                   else lsh_mod.plan_lsh(spec.target_recall, seed=spec.seed))
            self._lsh = lsh_mod.LSHBands(cfg, self.dim)

        # per-shard engine indexes in streaming mode: host mirrors, block
        # metadata and tombstone bookkeeping — the device stacks are owned
        # by the store (assembled below, one tensor set per replica)
        self.shards: List[SparseKNNIndex] = []
        self._gids: List[np.ndarray] = []
        # per-replica divergence tracking: shard copies whose device state
        # failed (_lost) or missed a write-through while dead (_replica_dirty)
        self._lost: List[Set[int]] = [set() for _ in range(self.n_replicas)]
        self._replica_dirty: List[Set[int]] = [
            set() for _ in range(self.n_replicas)]
        self._rr = 0                    # round-robin cursor over clean replicas
        self.fault_plan = None          # FaultPlan hook, consulted per dispatch
        for i in range(self.n_shards):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            shard = self._build_shard(idx[lo:hi], val[lo:hi], nnz[lo:hi])
            if _alive is not None:
                shard._alive = np.asarray(_alive[lo:hi], bool).copy()
            if _deadline is not None:
                shard._deadline = np.asarray(_deadline[lo:hi], np.float64).copy()
            self.shards.append(shard)
            if _row_ids is not None:
                self._gids.append(np.asarray(_row_ids[lo:hi], np.int32).copy())
            else:
                self._gids.append(np.arange(lo, hi, dtype=np.int32))
        self._next_gid = n_s if _next_gid is None else int(_next_gid)

        # durability bookkeeping: which shards diverge from the last commit
        # (a fresh build has never been committed — everything is dirty)
        self._dirty: Set[int] = set(range(self.n_shards))
        self._dirty_rank = True
        self._last_save_dir: Optional[str] = None

        self._shard_arrays: List[Dict[str, np.ndarray]] = [
            self._assemble_shard(i) for i in range(self.n_shards)
        ]
        self._stacks: List[Optional[Dict[str, torch.Tensor]]] = (
            [None] * self.n_replicas)
        self._stacked_host: Optional[Dict[str, np.ndarray]] = None
        self._host_geometry: Optional[tuple] = None
        self._upload_stacks()
        self.stats.build_wall_s += time.perf_counter() - t0

    def _set_mesh(self, mesh: DeviceMesh, axes: Optional[Sequence[str]]):
        """The store's layout on ``mesh``: its shard axes, one sub-mesh per
        replica, each replica's shard devices, and the store's own device
        (replica 0's first shard's: builds, the IIIB rank, results)."""
        names = mesh.axis_names
        if axes is None:
            axes = tuple(a for a in names if a != "replica") if "replica" in names else names[:1]
        self.mesh = mesh
        self._axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
        if "replica" in names and "replica" not in self._axes:
            self._replica_meshes = replica_submeshes(mesh)
        else:
            self._replica_meshes = [mesh]
        self.n_replicas = len(self._replica_meshes)
        self._shard_devices = [m.devices_along(self._axes) for m in self._replica_meshes]
        self.n_shards = len(self._shard_devices[0])
        for dev in {d for devs in self._shard_devices for d in devs}:
            resolve_device(dev)
        self.device = self._shard_devices[0][0]

    def _build_shard(self, idx: np.ndarray, val: np.ndarray, nnz: np.ndarray) -> SparseKNNIndex:
        """One shard's engine index (streaming mode: host mirrors and block
        metadata) over the given rows, in the store's plan, block size,
        IIIB rank and LSH config.  The engine clamps its block size to its
        row count, so a shard that compacted below the store's block size
        (rebuilt by :meth:`recover` or :meth:`load`) is re-blocked at the
        store's: one partial block, as compaction leaves it — the stacks
        need every shard in one geometry."""
        spec = dataclasses.replace(self.spec, algorithm=self.algorithm, s_block=self.s_block)
        shard = SparseKNNIndex.build(
            from_arrays(idx, val, nnz, self.dim), spec, cache_device_blocks=False,
            device=self.device, frozen_rank=self._rank_np, calibration=self.calibration,
            lsh_cfg=self._lsh.cfg if self._lsh is not None else None,
        )
        if shard.s_block != self.s_block:
            shard.s_block = self.s_block
            shard._build_blocks(from_block=0)
        return shard

    # -- introspection -------------------------------------------------------

    @classmethod
    def build(cls, S: SparseBatch, spec: JoinSpec, **kw) -> "ShardedKNNStore":
        return cls(S, spec, **kw)

    @property
    def num_vectors(self) -> int:
        """Live rows across all shards."""
        return sum(s.live_rows for s in self.shards)

    @property
    def shard_rows(self) -> List[int]:
        """Per-shard live row counts (the balance policy's target)."""
        return [s.live_rows for s in self.shards]

    @property
    def num_blocks(self) -> int:
        return sum(s.num_blocks for s in self.shards)

    # -- stack assembly ------------------------------------------------------

    def _assemble_shard(self, i: int, from_block: int = 0) -> Dict[str, np.ndarray]:
        """One shard's stack slice as host arrays (block-stacked, not yet
        padded to the cross-shard maxima).  Tile-index construction counts
        into ``stats.index_builds`` and runs only at build/add/compact/
        refreeze time, never at query time.

        ``from_block`` retains the previously assembled prefix (the engine's
        tail-only rebuild): ``add()`` passes the first block its
        ``extend()`` touched.  A grown list bound pads the retained prefix
        (sentinel rows, zero values) — a pad is not a rebuild."""
        shard = self.shards[i]
        old = self._shard_arrays[i] if from_block > 0 else None
        out: Dict[str, np.ndarray] = {}
        sb = self.s_block
        tail = shard._blocks[from_block:]
        if self.algorithm == "bf":
            f = shard._idx.shape[1]
            parts = {
                "idx": [b.host.indices.numpy().astype(np.int32) for b in tail],
                "val": [b.host.values.numpy().astype(np.float32) for b in tail],
                "nnz": [b.host.nnz.numpy().astype(np.int32) for b in tail],
            }
            if old is not None:
                oi, ov = old["idx"][:from_block], old["val"][:from_block]
                if oi.shape[2] < f:
                    oi2, ov2 = _pad_feature_axis(
                        oi.reshape(-1, oi.shape[2]), ov.reshape(-1, ov.shape[2]),
                        f, self.dim,
                    )
                    oi = oi2.reshape(from_block, sb, f)
                    ov = ov2.reshape(from_block, sb, f)
                parts["idx"] = list(oi) + parts["idx"]
                parts["val"] = list(ov) + parts["val"]
                parts["nnz"] = list(old["nnz"][:from_block]) + parts["nnz"]
            out = {k: np.stack(v) for k, v in parts.items()}
        else:
            rank = shard._rank_dev if self.algorithm == "iiib" else None
            m = max(blk.bound for blk in tail)
            if old is not None:
                m = max(m, old["rows"].shape[2])
            rows, vals, counts, mass = [], [], [], []
            if old is not None:
                orows, ovals = old["rows"][:from_block], old["vals"][:from_block]
                pad = m - orows.shape[2]
                if pad:
                    orows = np.concatenate(
                        [orows, np.full(orows.shape[:2] + (pad,), sb, orows.dtype)],
                        axis=2,
                    )
                    ovals = np.concatenate(
                        [ovals,
                         np.zeros(ovals.shape[:2] + (pad, self.tile), ovals.dtype)],
                        axis=2,
                    )
                rows, vals = list(orows), list(ovals)
                counts = list(old["counts"][:from_block])
                if self.algorithm == "iiib":
                    mass = list(old["mass"][:from_block])
            for blk in tail:
                ti = build_tile_index(blk.host.to(self.device), max_rows=m, tile=self.tile,
                                      rank=rank)
                self.stats.index_builds += 1
                blk.list_total = int(ti.counts.sum())
                rows.append(ti.rows.cpu().numpy())
                vals.append(ti.vals.cpu().numpy())
                counts.append(ti.counts.cpu().numpy())
                del ti
                if self.algorithm == "iiib":
                    mass.append(blk.tilemass.astype(np.float32))
            out["rows"] = np.stack(rows)
            out["vals"] = np.stack(vals)
            out["counts"] = np.stack(counts)
            if self.algorithm == "iiib":
                out["mass"] = np.stack(mass)
        if self._lsh is not None:
            # band keys are per-row build state like the tile mass: the
            # retained prefix carries over, only tail blocks re-hash
            keys = [b.lshkeys for b in tail]
            if old is not None:
                keys = list(old["lshk"][:from_block]) + keys
            out["lshk"] = np.stack(keys)
        return out

    def _shard_ids_valid(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(B, s_block) global-id stack + valid mask of shard i (padding and
        tombstones folded in — the only arrays delete()/expire() touch).
        Replica-local losses are NOT folded here — :meth:`_replica_valid`
        zeroes the lost shards of one replica's copy at placement time, so
        a shard lost on one replica still answers from the others."""
        shard = self.shards[i]
        b, sb = shard.num_blocks, self.s_block
        ids = np.zeros(b * sb, np.int32)
        ids[: shard.n_s] = self._gids[i]
        valid = np.arange(b * sb) < shard.n_s
        valid[: shard.n_s] &= shard._alive
        return ids.reshape(b, sb), valid.reshape(b, sb)

    def _padded_geometry(self) -> tuple:
        """(b_max, width): the cross-shard padded stack geometry.  width is
        the feature bound (bf) or the inverted-list bound (iib/iiib).  While
        this is unchanged, a mutation's placement can be incremental."""
        b_max = max(s.num_blocks for s in self.shards)
        if self.algorithm == "bf":
            width = max(a["idx"].shape[2] for a in self._shard_arrays)
        else:
            width = max(a["rows"].shape[2] for a in self._shard_arrays)
        return (b_max, width)

    def _padded_shard(self, i: int, b_max: int, width: int) -> Dict[str, np.ndarray]:
        """Shard i's stack slice padded to the cross-shard maxima — one row
        of the stacked host mirror, and the unit the incremental placement
        copies.  A padded block offers nothing: its rows are all invalid."""
        sb = self.s_block
        a = self._shard_arrays[i]
        out: Dict[str, np.ndarray] = {}

        def pad_blocks(x: np.ndarray, fill) -> np.ndarray:
            pad = b_max - x.shape[0]
            if pad == 0:
                return x
            return np.concatenate(
                [x, np.full((pad,) + x.shape[1:], fill, x.dtype)]
            )

        if self.algorithm == "bf":
            idx2, val2 = a["idx"], a["val"]
            if idx2.shape[2] < width:
                flat_i = idx2.reshape(-1, idx2.shape[2])
                flat_v = val2.reshape(-1, val2.shape[2])
                flat_i, flat_v = _pad_feature_axis(flat_i, flat_v, width, self.dim)
                idx2 = flat_i.reshape(idx2.shape[0], sb, width)
                val2 = flat_v.reshape(val2.shape[0], sb, width)
            out["idx"] = pad_blocks(idx2, self.dim)
            out["val"] = pad_blocks(val2, 0.0)
            out["nnz"] = pad_blocks(a["nnz"], 0)
        else:
            rows, vals = a["rows"], a["vals"]
            pad = width - rows.shape[2]
            if pad:
                # a wider list bound is a pad, not a rebuild (sentinel
                # rows scatter into the discard slot, zero values)
                rows = np.concatenate(
                    [rows, np.full(rows.shape[:2] + (pad,), sb, rows.dtype)],
                    axis=2,
                )
                vals = np.concatenate(
                    [vals, np.zeros(vals.shape[:2] + (pad, self.tile), vals.dtype)],
                    axis=2,
                )
            out["rows"] = pad_blocks(rows, sb)
            out["vals"] = pad_blocks(vals, 0.0)
            out["counts"] = pad_blocks(a["counts"], 0)
            if self.algorithm == "iiib":
                out["mass"] = pad_blocks(a["mass"], 0.0)
        if self._lsh is not None:
            # pad blocks key 0: excluded by the valid mask, never by key
            out["lshk"] = pad_blocks(a["lshk"], 0)
        ids, valid = self._shard_ids_valid(i)
        out["ids"] = pad_blocks(ids, 0)
        out["valid"] = pad_blocks(valid, False)
        return out

    def _replica_valid(self, r: int) -> np.ndarray:
        """Replica r's valid mask: the host truth with r's lost shard
        copies zeroed (a degraded redrive on r must not read them)."""
        v = self._stacked_host["valid"]
        if not self._lost[r]:
            return v
        v = v.copy()
        for i in self._lost[r]:
            v[i] = False
        return v

    def _upload_stacks(self, shards: Optional[Set[int]] = None):
        """Place the per-shard slices on every replica.

        ``shards=None`` (build/refreeze) re-stacks the host mirror and fully
        re-places each replica.  ``shards={...}`` (add/compact) is the
        incremental path: while the padded geometry is unchanged, only the
        named shards' rows are patched into the host mirror and copied into
        each replica's tensors; a geometry change falls back to the full
        path.  Dead replicas are skipped and accrue the touched shards in
        their dirty set — :meth:`resync_replicas` replays them."""
        geometry = self._padded_geometry()
        incremental = (
            shards is not None
            and self._stacked_host is not None
            and geometry == self._host_geometry
        )
        b_max, width = geometry
        if incremental:
            touched = sorted(set(shards))
            for i in touched:
                p = self._padded_shard(i, b_max, width)
                for k, v in p.items():
                    self._stacked_host[k][i] = v
            self._place(touched)
        else:
            self._stacked_host = None      # the old mirror goes before the new is stacked
            padded = [
                self._padded_shard(i, b_max, width) for i in range(self.n_shards)
            ]
            self._stacked_host = {
                k: np.stack([p[k] for p in padded]) for k in padded[0]
            }
            del padded
            self._host_geometry = geometry
            self._place(None)
        self._num_blocks_stacked = b_max
        self.stats.stack_uploads += 1
        self._refresh_plan_stats()

    def _place(self, shards: Optional[Sequence[int]]):
        """Write-through to every replica: full placement (``shards=None``)
        or per-shard slice copies.  Dead replicas accrue dirty instead."""
        touched = set(range(self.n_shards)) if shards is None else set(shards)
        for r in range(self.n_replicas):
            if self.health.state(r) == ReplicaHealth.DEAD:
                self._replica_dirty[r] |= touched
                continue
            if shards is None or self._stacks[r] is None:
                self._place_replica_full(r)
            else:
                self._place_replica_shards(r, sorted(touched))

    def _place_replica_full(self, r: int):
        """Replica r's whole tensor set, copied from the host mirror onto
        its sub-mesh (its old tensors are released first, so a
        re-placement never holds two sets of one replica)."""
        self._stacks[r] = None
        tree = dict(self._stacked_host, valid=self._replica_valid(r))
        self._stacks[r] = store_put(tree, self._replica_meshes[r], self._axes)
        self.stats.placed_shards += self.n_shards
        self.stats.placed_bytes += sum(int(v.nbytes) for v in tree.values())

    def _place_replica_shards(self, r: int, shards: Sequence[int]):
        """Copy shard slices into replica r's tensors in place, each on its
        shard's device."""
        st = self._stacks[r]
        valid = self._replica_valid(r)
        for i in shards:
            for k, host in self._stacked_host.items():
                sl = valid[i:i + 1] if k == "valid" else host[i:i + 1]
                store_shard_update(st[k], i, sl)
                self.stats.placed_bytes += int(sl.nbytes)
            self.stats.placed_shards += 1

    def _refresh_replica_valid(self, r: int):
        """Re-place ONLY replica r's valid mask (tombstones / lost folds)."""
        self._stacks[r]["valid"] = store_put(self._replica_valid(r), self._replica_meshes[r],
                                             self._axes)

    def _refresh_valid(self):
        """Tombstone fold: ONLY the valid mask re-uploads — no index arrays
        are touched, no tile index is rebuilt (``stats.index_builds`` is the
        observable).  Dead replicas are skipped (resync re-places the whole
        valid mask anyway)."""
        b_max = self._num_blocks_stacked
        valid_parts = []
        for i in range(self.n_shards):
            _, valid = self._shard_ids_valid(i)
            pad = b_max - valid.shape[0]
            if pad:
                valid = np.concatenate([valid, np.zeros((pad, self.s_block), bool)])
            valid_parts.append(valid)
        self._stacked_host["valid"] = np.stack(valid_parts)
        for r in range(self.n_replicas):
            if self.health.state(r) != ReplicaHealth.DEAD:
                self._refresh_replica_valid(r)

    # -- fan-out query -------------------------------------------------------

    def _fanout(self, r: int, rb: int, br: SparseBatch,
                prep: dict, rv: Optional[torch.Tensor], approx: bool,
                rk: Optional[torch.Tensor] = None, rr: Optional[torch.Tensor] = None):
        """One R block against every shard of replica r's stacks (the
        reference's shard_map program): the R block's prepared inputs sent
        to each shard's device, each shard's driver walk over its slice
        from a fresh top-k state (IIIB: and its own MinPruneScore, from
        -inf), launched in shard order with no host sync between shards,
        then ``tree_reduce_topk`` over the shards' states on the first
        shard's device.  Returns (state, per-shard kept-entry counts,
        per-shard final thresholds, per-shard candidate counts), the last
        three None where they do not apply; all on the store's device.

        ``approx`` ANDs each shard's band hits into that shard's valid
        mask and counts its live candidates."""
        k, dim, sb, tile = self.spec.k, self.dim, self.s_block, self.tile
        st = self._stacks[r]
        here = {}                       # device -> the R block's inputs on it
        states, kept, thr, cand = [], [], [], []
        for i, dev in enumerate(self._shard_devices[r]):
            if dev not in here:
                here[dev] = _inputs_on(dev, br, prep, rv, rk, rr)
            b_i, p_i, rv_i, rk_i, rr_i = here[dev]
            valid = st["valid"][i]
            if approx:
                valid = valid & lsh_mod.band_hits(rk_i, rr_i, st["lshk"][i])
                cand.append(valid.sum())
            state = init_topk(rb, k, device=dev)
            if self.algorithm == "bf":
                state = bf_scan_join(state, b_i, st["idx"][i], st["val"][i], st["nnz"][i],
                                     st["ids"][i], valid, dim=dim)
            elif self.algorithm == "iib":
                state = iib_scan_join(state, p_i["r_tiles"], p_i["tiles"], st["rows"][i],
                                      st["vals"][i], st["counts"][i], st["ids"][i], valid,
                                      tile=tile, num_s=sb)
            else:
                seed = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
                state, t, _, kp = iiib_scan_join(
                    state, seed, p_i["r_tiles"], p_i["mwt"], p_i["tiles"], st["rows"][i],
                    st["vals"][i], st["counts"][i], st["mass"][i], st["ids"][i], valid, rv_i,
                    tile=tile, num_s=sb)
                thr.append(t)
                kept.append(kp.sum())
            states.append(state)

        def stacked(xs):
            return torch.stack([to_device(x, self.device) for x in xs]) if xs else None

        return tree_reduce_topk(states), stacked(kept), stacked(thr), stacked(cand)

    def _occupied_tiles_of(self, idx: np.ndarray) -> int:
        """Dim-tiles the given rows touch (the engine's planner statistic)."""
        ok = idx < self.dim
        if not ok.any():
            return 1
        return int(np.unique(idx[ok] // self.spec.tile).size)

    def _refresh_plan_stats(self):
        """Cache the S-side planner statistics so the serving hot path
        (query → plan_for) does no O(shards × dim) host work; only
        mutations change these (every mutation path runs
        ``_upload_stacks``, which calls this)."""
        freq = np.zeros(self.dim, np.int64)
        for shard in self.shards:
            freq += shard.dim_freq
        (dims,) = np.nonzero(freq)
        self._occupied_tiles = (
            int(np.unique(dims // self.tile).size) if dims.size else 1
        )
        self._total_rows = sum(s.n_s for s in self.shards)
        self._f_mean = float(np.mean([s._f_mean for s in self.shards]))

    @property
    def occupied_tiles(self) -> int:
        """Dim-tiles the whole datastore touches (cached; planner statistic)."""
        return self._occupied_tiles

    def plan_for(self, R):
        n_r, f_r, _ = _shape_stats(R)
        spec = dataclasses.replace(
            self.spec, algorithm=self.algorithm, s_block=self.s_block
        )
        return plan((n_r, f_r, self.dim), (self._total_rows, self._f_mean, self.dim),
                    spec, occupied_tiles=self._occupied_tiles,
                    calibration=self.calibration)

    def _route_order(self) -> List[int]:
        """Replica preference for the next dispatch: half-open replicas
        first (the resync probe — one success re-admits them), then live
        replicas with no lost shard copies rotated round-robin (the read
        scaling), then live replicas carrying losses (fewest first — they
        serve degraded redrives only when nothing clean is left).  Dead
        replicas never appear."""
        clean = [r for r in self.health.live() if not self._lost[r]]
        lossy = sorted(
            (r for r in self.health.live() if self._lost[r]),
            key=lambda r: (len(self._lost[r]), r),
        )
        if clean:
            rot = self._rr % len(clean)
            self._rr += 1
            clean = clean[rot:] + clean[:rot]
        return self.health.half_open() + clean + lossy

    def _note_shard_failure(self, r: int, shard: int):
        """A dispatch on replica r lost ITS COPY of ``shard`` (replicated
        stores only): tombstone the copy, strike the replica's health, and
        queue the shard for anti-entropy resync.  Crossing the circuit-
        breaker threshold kills the whole replica (everything it holds is
        suspect → all shards dirty)."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        if shard not in self._lost[r]:
            self._lost[r].add(shard)
            self._replica_dirty[r].add(shard)
            self.stats.shard_losses += 1
            obs_recorder.get_recorder().fault(
                "shard_copy_lost", replica=r, shard=shard)
        if self.health.record_failure(r):
            self.stats.replica_losses += 1
            self._replica_dirty[r] = set(range(self.n_shards))
            obs_recorder.get_recorder().fault(
                "replica_lost", replica=r, via="failure_threshold")
        else:
            self._refresh_replica_valid(r)

    def _mark_replica_dead(self, r: int):
        """Whole-replica loss (``ReplicaLostError``): bypass the failure
        threshold, stop routing to r, and mark every shard copy dirty."""
        if self.health.mark_dead(r):
            self.stats.replica_losses += 1
            obs_recorder.get_recorder().fault(
                "replica_lost", replica=r, via="ReplicaLostError")
        self._replica_dirty[r] = set(range(self.n_shards))

    def query(
        self,
        R: SparseBatch,
        stats: Optional[JoinStats] = None,
        allow_partial: bool = False,
        accuracy: Optional[str] = None,
    ) -> JoinResult:
        """R ⋈_KNN S over all shards.  Returns stable global S ids, on the
        store's device.

        One dispatch (the fan-out over every shard) and one host sync (the
        result pull, which brings IIIB's thresholds and kept counts and the
        approx tier's candidate counts with it) per R block, independent of
        the shard count.  Replicated stores route each block to ONE replica
        (see ``_route_order``); a ``ShardLostError``/``ReplicaLostError`` at
        dispatch fails over to the next healthy replica within the same
        block, so the caller still gets FULL, identical results — failover
        shows only in ``stats.replica_failovers``.

        ``allow_partial`` is the degraded serving mode: when no replica can
        serve a full fan-out (unreplicated shard loss, or losses on every
        live replica) the query proceeds over the best surviving copy —
        the lost shards' valid masks zeroed — and the result carries
        ``missing_shards``.  Without it, a loss no replica covers raises
        :class:`ShardLostError`.

        ``accuracy`` overrides the spec per query: ``"approx"`` folds each
        shard's band-lookup candidate mask into its valid mask (same
        dispatch count); ``"exact"`` on an approx-built store equals an
        exact-built store.
        """
        t_q = time.perf_counter()
        stats = stats if stats is not None else JoinStats()
        if R.dim != self.dim:
            raise ValueError(f"dim mismatch: store has {self.dim}, got {R.dim}")
        acc = accuracy if accuracy is not None else self.spec.accuracy
        if acc not in ("exact", "approx"):
            raise ValueError(f"unknown accuracy {acc!r}")
        approx = acc == "approx"
        if approx and self._lsh is None:
            raise ValueError(
                "store was built without the LSH band tier; build with "
                "target_recall (or accuracy='approx') to enable approx queries")
        glost = self.lost_shards
        if glost and not allow_partial:
            raise ShardLostError(
                glost[0],
                f"shard(s) {list(glost)} lost on every replica; recover() "
                "or pass allow_partial=True",
            )
        dev = self.device
        n_r = R.num_vectors
        rb = min(self.spec.r_block or self.plan_for(R).r_block, n_r)
        r_idx = R.indices.cpu().numpy()
        r_val = R.values.cpu().numpy()
        r_nnz = R.nnz.cpu().numpy()
        out_scores, out_ids = [], []
        served_missing: Set[int] = set()
        for r0 in range(0, n_r, rb):
            # leaf span per dispatched R block; parents to the serving
            # batch/dispatch span when one is active on this thread
            _sp = obs_trace.start_span("store.r_block", r0=r0,
                                       algorithm=self.algorithm)
            stop = min(r0 + rb, n_r)
            idx, val, nnz, r_valid = _pad_rows_np(
                r_idx[r0:stop], r_val[r0:stop], r_nnz[r0:stop], self.dim, rb)
            br = from_arrays(idx, val, nnz, self.dim, device=dev)
            prep, rv = {}, None
            if self.algorithm == "iib":
                prep = prepare_r_block_inputs(br, idx, "iib", self.tile)
            elif self.algorithm == "iiib":
                prep = prepare_r_block_inputs(
                    br, idx, "iiib", self.tile,
                    rank_np=self._rank_np, rank_dev=self._rank_dev,
                )
                rv = torch.as_tensor(r_valid, device=dev)
            rk = rr = None
            if approx:
                # R band keys are hashed on the host from the raw R slice
                # (the projection every shard and replica uses); padded and
                # empty rows stay out of the candidate union
                rk_np = np.zeros((rb, self._lsh.cfg.n_bands), np.int32)
                rk_np[: stop - r0] = self._lsh.keys_host(r_idx[r0:stop], r_val[r0:stop])
                rr_np = r_valid.copy()
                rr_np[: stop - r0] &= r_nnz[r0:stop] > 0
                rk, rr = torch.as_tensor(rk_np, device=dev), torch.as_tensor(rr_np, device=dev)
            # failover loop: every failure tombstones a shard copy or kills
            # a replica, so attempts are bounded by the copy count.  On an
            # unreplicated store `tried` stays empty: mark lost, raise
            # without allow_partial, redrive degraded with it.
            tried: Set[int] = set()
            last_err: Optional[Exception] = None
            attempts = 0
            while True:
                order = [r for r in self._route_order() if r not in tried]
                if not order:
                    exhausted = attempts > self.n_replicas * (self.n_shards + 2)
                    if not allow_partial or exhausted:
                        if isinstance(last_err, ShardLostError):
                            raise last_err
                        raise ShardLostError(
                            0,
                            "no live replica can serve a full fan-out; "
                            "recover() or resync_replicas()",
                        ) from last_err
                    # degraded redrive: the best surviving copy answers with
                    # its lost shards masked out
                    tried.clear()
                    order = self._route_order()
                    if not order:
                        raise ShardLostError(0, "all replicas dead") from last_err
                r = order[0]
                attempts += 1
                probing = r in self.health.half_open()
                if probing:
                    obs_recorder.get_recorder().record(
                        "half_open_probe", replica=r, r0=r0)
                self.stats.replica_dispatches[r] = (
                    self.stats.replica_dispatches.get(r, 0) + 1)
                try:
                    if self.fault_plan is not None:
                        self.fault_plan.on_dispatch(replica=r)
                    state, kept, thr, cand_cnt = self._fanout(
                        r, rb, br, prep, rv, approx, rk, rr)
                    self.health.record_success(r)
                    if tried:
                        self.stats.replica_failovers += 1
                        obs_recorder.get_recorder().fault(
                            "replica_failover", replica=r, r0=r0,
                            tried=sorted(tried))
                    served_missing |= self._lost[r]
                    break
                except ShardLostError as e:
                    last_err = e
                    if self.n_replicas == 1:
                        self._mark_lost(e.shard)
                        if not allow_partial:
                            raise
                    else:
                        self._note_shard_failure(r, e.shard)
                        tried.add(r)
                except ReplicaLostError as e:
                    if self.n_replicas == 1:
                        raise
                    last_err = e
                    self._mark_replica_dead(r)
                    tried.add(r)
            # the R block's result pull (IIIB's thresholds and kept counts
            # and the candidate counts ride along)
            out_scores.append(state.scores[: stop - r0].cpu())
            out_ids.append(state.ids[: stop - r0].cpu())
            if self.algorithm == "iiib":
                stats.list_entries += int(kept.sum())
                thr_np = thr.cpu().numpy()
                stats.min_prune_trace.append(thr_np)
                observe_thresholds(thr_np)
            if cand_cnt is not None:
                stats.candidate_rows += int(cand_cnt.sum())
                stats.scanned_rows += int(self._stacked_host["valid"].sum())
            stats.device_dispatches += 1
            stats.blocks += self._num_blocks_stacked * self.n_shards
            if self.algorithm == "bf":
                stats.dense_pairs += (
                    rb * self.s_block * self._num_blocks_stacked * self.n_shards
                )
            else:
                stats.tiles_scored += (
                    int(prep["tiles"].shape[0])
                    * self._num_blocks_stacked * self.n_shards
                )
                if self.algorithm == "iib":
                    stats.list_entries += sum(
                        blk.list_total for s in self.shards for blk in s._blocks
                    )
            stats.host_syncs += 1                # the R block's result pull
            obs_trace.end_span(_sp, attempts=attempts)
        dt = time.perf_counter() - t_q
        stats.query_wall_s += dt
        self.stats.query_wall_s += dt
        self.stats.queries += 1
        self.stats.device_dispatches += stats.device_dispatches
        self.stats.host_syncs += stats.host_syncs
        if self.n_replicas == 1:
            missing = tuple(sorted(self._lost[0]))
        else:
            missing = tuple(sorted(served_missing))
        if missing:
            self.stats.degraded_queries += 1
        return JoinResult(
            scores=torch.cat(out_scores).to(dev),
            ids=torch.cat(out_ids).to(dev),
            stats=stats,
            missing_shards=missing,
        )

    # -- mutation ------------------------------------------------------------

    def add(self, S_new: SparseBatch, ttl: Optional[float] = None,
            now: Optional[float] = None) -> np.ndarray:
        """Append a batch to the datastore; returns the new rows' global ids.

        Balance policy: the whole batch lands on the shard with the fewest
        live rows (chunked callers converge to balanced shards).  Only the
        target shard's TAIL blocks rebuild their tile indexes; the retained
        prefix and the other shards' index arrays are reused (padded if the
        list bound grew).  Placement writes through to every live replica
        and is INCREMENTAL while the padded geometry holds: only the target
        shard's slice is copied (``placed_shards`` grows by the replica
        count, not replicas × shards).  ``ttl`` attaches an expiry deadline
        ``now + ttl`` consumed by :meth:`expire`.
        """
        if S_new.dim != self.dim:
            raise ValueError(f"dim mismatch: store has {self.dim}, got {S_new.dim}")
        t0 = time.perf_counter()
        glost = set(self.lost_shards)
        candidates = [i for i in range(self.n_shards) if i not in glost]
        if not candidates:
            raise ShardLostError(min(glost), "all shards lost")
        tgt = min(candidates, key=lambda i: self.shards[i].live_rows)
        deadline = None
        if ttl is not None:
            deadline = (time.time() if now is None else now) + float(ttl)
        from_block = self.shards[tgt].n_s // self.s_block
        self.shards[tgt].extend(S_new, deadline=deadline)
        n_new = S_new.num_vectors
        gids = np.arange(self._next_gid, self._next_gid + n_new, dtype=np.int32)
        self._gids[tgt] = np.concatenate([self._gids[tgt], gids])
        self._next_gid += n_new
        self._dirty.add(tgt)
        self._shard_arrays[tgt] = self._assemble_shard(tgt, from_block=from_block)
        self._upload_stacks(shards={tgt})
        self.stats.build_wall_s += time.perf_counter() - t0
        return gids

    def delete(self, ids) -> int:
        """Tombstone rows by global id across shards — a valid-mask update,
        never an index rebuild (until :meth:`compact`)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        newly, touched = 0, set()
        for i, shard in enumerate(self.shards):
            local = np.nonzero(np.isin(self._gids[i], ids))[0]
            if local.size:
                n = shard.delete(local)
                if n:
                    touched.add(i)
                newly += n
        if newly:
            self.stats.deleted += newly
            self._dirty |= touched
            self._fold_tombstones(touched)
        return newly

    def expire(self, now: Optional[float] = None) -> int:
        """Tombstone rows whose TTL deadline has passed."""
        now = time.time() if now is None else now
        newly, touched = 0, set()
        for i, shard in enumerate(self.shards):
            n = shard.expire(now)
            if n:
                touched.add(i)
            newly += n
        if newly:
            self.stats.expired += newly
            self._dirty |= touched
            self._fold_tombstones(touched)
        return newly

    def _fold_tombstones(self, touched: Set[int]):
        """After delete()/expire() tombstoned rows of the ``touched`` shards:
        compact the shards over the dead-fraction threshold, and refresh the
        valid masks unless the compactions re-placed every touched shard.
        (The reference skips the refresh whenever any shard compacted, so a
        tombstone in a shard below the threshold stays unseen by the device
        until the next refresh: ROADMAP queue 3.)"""
        if not touched <= self._maybe_compact():
            self._refresh_valid()

    def _maybe_compact(self) -> Set[int]:
        """Compact shards over the dead-fraction threshold; returns them.
        Their stack upload carries their fresh valid masks."""
        over = [
            i for i, s in enumerate(self.shards)
            if s.dead_rows and s.dead_rows / s.n_s >= self.auto_compact
        ]
        if over:
            self.compact(shards=over)
        return set(over)

    def compact(self, shards: Optional[Sequence[int]] = None) -> int:
        """Physically reclaim tombstoned rows — the real rebuild that
        delete()/expire() defer.  Re-assembles only the compacted shards'
        stack slices (and, geometry permitting, re-places only those
        slices); global ids of surviving rows are unchanged (the store owns
        the id map).  A fully-dead shard compacts to the engine's single
        tombstoned placeholder row (its id kept in the map, never offered)
        and becomes the balance policy's next add() target."""
        t0 = time.perf_counter()
        removed = 0
        targets = range(self.n_shards) if shards is None else shards
        changed = []
        for i in targets:
            shard = self.shards[i]
            if shard.dead_rows == 0:
                continue
            removed += shard.compact()
            # follow the engine's surviving-row choice exactly (incl. the
            # placeholder row a fully-dead shard keeps)
            self._gids[i] = self._gids[i][shard.last_compact_keep]
            changed.append(i)
            self._dirty.add(i)
            self._shard_arrays[i] = self._assemble_shard(i)
        if changed:
            self.stats.compactions += len(changed)
            # a shrunken b_max changes the geometry; _upload_stacks falls
            # back to the full path then.  Compaction rewrites only its own
            # shards' rows, so every other shard's valid mask is current.
            self._upload_stacks(shards=set(changed))
        self.stats.build_wall_s += time.perf_counter() - t0
        return removed

    def refreeze(self) -> "ShardedKNNStore":
        """Recompute the IIIB superset rank from the LIVE rows of every
        shard (global frequencies) and reassemble all stacks — the store
        face of ``SparseKNNIndex.refreeze()``."""
        if self.algorithm != "iiib":
            return self
        t0 = time.perf_counter()
        freq = np.zeros(self.dim, np.int64)
        for shard in self.shards:
            ok = (shard._idx < self.dim) & shard._alive[:, None]
            freq += np.bincount(shard._idx[ok], minlength=self.dim)
        self._rank_np = iiib_mod.s_frequency_rank(freq)
        self._rank_dev = torch.as_tensor(self._rank_np, device=self.device)
        self._dirty_rank = True
        for i, shard in enumerate(self.shards):
            shard.refreeze(frozen_rank=self._rank_np)
            self._dirty.add(i)
            self._shard_arrays[i] = self._assemble_shard(i)
        self._upload_stacks()
        self.stats.build_wall_s += time.perf_counter() - t0
        return self

    # -- durability (DESIGN.md §9) -------------------------------------------

    _LEAVES = ("idx", "val", "nnz", "alive", "deadline", "gids")

    def _shard_key(self, i: int) -> str:
        return f"shard_{i:05d}"

    def _ckpt_tree(self) -> dict:
        """The persisted state: per-shard host mirrors (rows exactly as the
        engine holds them, tombstones included), tombstone/TTL masks, the
        global-id stacks, and the frozen IIIB rank.  ONE logical copy —
        replicas are a placement property, not data (device stacks, tile
        indexes and planner statistics are pure functions of this tree and
        rebuild / fan out on load)."""
        tree = {}
        for i, shard in enumerate(self.shards):
            tree[self._shard_key(i)] = {
                "idx": shard._idx.astype(np.int32),
                "val": shard._val.astype(np.float32),
                "nnz": shard._nnz.astype(np.int32),
                "alive": shard._alive,
                "deadline": shard._deadline,
                "gids": self._gids[i].astype(np.int32),
            }
        if self._rank_np is not None:
            tree["rank"] = self._rank_np
        return tree

    def _meta(self) -> dict:
        return {
            "spec": dataclasses.asdict(self.spec),
            "algorithm": self.algorithm,
            "s_block": self.s_block,
            "dim": self.dim,
            "n_shards": self.n_shards,
            "shard_rows": [int(s.n_s) for s in self.shards],
            "next_gid": int(self._next_gid),
            "auto_compact": self.auto_compact,
            # band-index config persists like the frozen IIIB rank: the
            # saved parameters win on restore, so keys round-trip
            "lsh": (dataclasses.asdict(self._lsh.cfg)
                    if self._lsh is not None else None),
        }

    def save(self, directory: str, extra: Optional[dict] = None,
             dirty_only: bool = False) -> str:
        """Commit the store to ``directory`` as a new checkpoint step
        (atomic two-phase commit via ``repro_torch.checkpoint``).  Returns
        the committed path.  ``extra`` rides along in the manifest.

        ``dirty_only`` (what :meth:`save_dirty` passes) hard-links every
        shard untouched since the last commit from that commit's dir
        instead of re-serializing it — an incremental save costs O(dirty
        shards) writes, not O(store).
        """
        from repro_torch.checkpoint import ckpt as _ckpt

        t0 = time.perf_counter()
        with obs_trace.span("ckpt.save", dirty_only=dirty_only):
            ls = _ckpt.latest_step(directory)
            step = 0 if ls is None else ls + 1
            link_from = link_paths = None
            if dirty_only and self._last_save_dir is not None:
                link_paths = {
                    f"['{self._shard_key(i)}']['{leaf}']"
                    for i in range(self.n_shards) if i not in self._dirty
                    for leaf in self._LEAVES
                }
                if self._rank_np is not None and not self._dirty_rank:
                    link_paths.add("['rank']")
                link_from = self._last_save_dir
            path = _ckpt.save(
                directory, step, self._ckpt_tree(),
                extra={"store": self._meta(), **(extra or {})},
                link_from=link_from, link_paths=link_paths,
            )
            self._dirty.clear()
            self._dirty_rank = False
            self._last_save_dir = path
            self.stats.saves += 1
            self.stats.save_wall_s += time.perf_counter() - t0
        return path

    def save_dirty(self, directory: str, extra: Optional[dict] = None) -> str:
        """Incremental :meth:`save`: only shards touched by add/delete/
        expire/compact/refreeze since the last commit are re-serialized."""
        return self.save(directory, extra=extra, dirty_only=True)

    @classmethod
    def load(
        cls,
        directory: str,
        num_shards: Optional[int] = None,
        step: Optional[int] = None,
        calibration=None,
        replicas: int = 1,
        replica_fail_threshold: int = 2,
        device=None,
        mesh=None,
        axes: Optional[Sequence[str]] = None,
    ) -> "ShardedKNNStore":
        """Warm-restart a saved store: host mirrors, spec, frozen IIIB
        rank, id stacks and tombstone state come from the newest valid
        checkpoint (``step`` pins one); device stacks and tile indexes are
        rebuilt on ``device``, re-split into ``num_shards`` (default: the
        saved count), or on ``mesh`` (over ``axes``), in as many shards as
        it holds.  ``replicas=`` fans the single persisted logical copy
        out — replication is a placement property, so a save from an
        unreplicated store restores replicated (and vice versa) without any
        on-disk difference.  At the saved shard count, queries after load
        are bit-identical to the saved store; a re-split keeps the
        concatenated row order (the tie-winning order) and answers within
        float32 rounding (other blocks make products of other shapes).  The
        manifest ``extra`` is exposed as ``store.loaded_extra``.
        """
        from repro_torch.checkpoint import ckpt as _ckpt

        if step is None:
            step = _ckpt.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no valid checkpoint in {directory}")
        _sp = obs_trace.start_span("ckpt.load", step=step)
        arrays, extra = _ckpt.load_arrays(directory, step)
        meta = extra["store"]
        n_saved = int(meta["n_shards"])

        def leaf(name: str) -> List[np.ndarray]:
            return [arrays[f"['shard_{i:05d}']['{name}']"] for i in range(n_saved)]

        # concatenate per-shard mirrors IN SHARD ORDER (this order is the
        # id-tie-winning order; any contiguous re-split preserves it),
        # padding the ragged feature axis to the widest shard
        dim = int(meta["dim"])
        f_max = max(a.shape[1] for a in leaf("idx"))
        idxs, vals = zip(*(_pad_feature_axis(ii, vv, f_max, dim)
                           for ii, vv in zip(leaf("idx"), leaf("val"))))
        S = from_arrays(np.concatenate(idxs), np.concatenate(vals),
                        np.concatenate(leaf("nnz")), dim)
        spec = dataclasses.replace(
            JoinSpec(**meta["spec"]),
            algorithm=meta["algorithm"], s_block=int(meta["s_block"]),
        )
        if mesh is None and num_shards is None:
            num_shards = n_saved
        store = cls(
            S, spec, num_shards=num_shards,
            auto_compact=float(meta["auto_compact"]), calibration=calibration,
            replicas=replicas, replica_fail_threshold=replica_fail_threshold,
            device=device, mesh=mesh, axes=axes,
            _row_ids=np.concatenate(leaf("gids")),
            _alive=np.concatenate(leaf("alive")),
            _deadline=np.concatenate(leaf("deadline")),
            _next_gid=int(meta["next_gid"]),
            _frozen_rank=arrays.get("['rank']"),
            _shard_sizes=[int(r) for r in meta["shard_rows"]],
            _lsh_cfg=meta.get("lsh"),
        )
        # When the loaded layout matches the saved one, the in-memory state
        # EQUALS the loaded commit: nothing is dirty, and incremental saves
        # may hard-link from it.  An ELASTIC load (different shard count /
        # split) re-partitioned the rows, so the saved per-shard leaves no
        # longer correspond to this store's shards — everything stays dirty
        # and the next save is a full one.
        if [s.n_s for s in store.shards] == [int(r) for r in meta["shard_rows"]]:
            store._dirty.clear()
            store._dirty_rank = False
            store._last_save_dir = os.path.join(directory, f"step_{step:08d}")
        store.loaded_extra = {k: v for k, v in extra.items() if k != "store"}
        obs_trace.end_span(_sp, n_shards=store.n_shards)
        return store

    # -- shard loss ----------------------------------------------------------

    @property
    def lost_shards(self) -> Tuple[int, ...]:
        """Shards with NO readable copy: lost on every replica (a dead
        replica counts as having lost everything it held).  Replica-local
        losses don't appear here — failover covers them until
        :meth:`resync_replicas` repairs the copy."""
        eff: Optional[Set[int]] = None
        for r in range(self.n_replicas):
            if self.health.state(r) == ReplicaHealth.DEAD:
                lost = set(range(self.n_shards))
            else:
                lost = self._lost[r]
            eff = set(lost) if eff is None else (eff & lost)
        return tuple(sorted(eff))

    @property
    def dead_replicas(self) -> Tuple[int, ...]:
        return tuple(self.health.dead())

    @property
    def needs_resync(self) -> bool:
        """True when some replica's device state diverges from the host
        mirror (dead, dirty from missed write-throughs, or carrying lost
        shard copies) — the cue to run :meth:`resync_replicas`.  Always
        False unreplicated: a single-replica loss is data loss."""
        if self.n_replicas == 1:
            return False
        return any(
            self.health.state(r) == ReplicaHealth.DEAD
            or self._replica_dirty[r] or self._lost[r]
            for r in range(self.n_replicas)
        )

    def _mark_lost(self, i: int, replica: Optional[int] = None) -> None:
        """Mark shard i failed on ``replica`` (default: EVERY replica —
        data loss).  Its valid mask zeroes on the affected copies (degraded
        queries see no candidates from them)."""
        if not 0 <= i < self.n_shards:
            raise ValueError(f"shard {i} out of range")
        targets = range(self.n_replicas) if replica is None else (replica,)
        newly = False
        for r in targets:
            if i not in self._lost[r]:
                self._lost[r].add(i)
                self._replica_dirty[r].add(i)
                newly = True
        if newly:
            self.stats.shard_losses += 1
            obs_recorder.get_recorder().fault(
                "shard_lost", shard=i,
                replica="all" if replica is None else replica)
            for r in targets:
                if self.health.state(r) != ReplicaHealth.DEAD:
                    self._refresh_replica_valid(r)

    def mark_lost(self, i: int, replica: Optional[int] = None) -> None:
        self._mark_lost(i, replica=replica)

    def recover(self, directory: str, step: Optional[int] = None) -> Tuple[int, ...]:
        """Rebuild every GLOBALLY lost shard from its checkpoint slice and
        rejoin it to the fan-out.  Reads ONLY the lost shards' leaves
        (sha-verified); the surviving shards' state — including mutations
        since the save — is untouched.  Mutations the lost shard took
        after the checkpoint are gone (that is what 'lost' means); its
        global ids are stable because the id stack is part of the slice.
        Replica-LOCAL losses are not recovered here (resync_replicas
        repairs them from the host mirror) — but the full re-placement at
        the end refreshes every live replica.  Returns the recovered
        shard indexes.
        """
        from repro_torch.checkpoint import ckpt as _ckpt

        glost = set(self.lost_shards)
        if not glost:
            return ()
        t0 = time.perf_counter()
        _sp = obs_trace.start_span("recover", shards=sorted(glost))
        if step is None:
            step = _ckpt.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no valid checkpoint in {directory}")
        recovered = []
        for i in sorted(glost):
            key = self._shard_key(i)
            arrays, extra = _ckpt.load_arrays(directory, step, prefix=f"['{key}']")
            if int(extra["store"]["n_shards"]) != self.n_shards:
                raise ValueError(
                    "checkpoint shard layout does not match the live store "
                    f"({extra['store']['n_shards']} vs {self.n_shards}); "
                    "use ShardedKNNStore.load() for elastic restarts"
                )
            g = lambda name: arrays[f"['{key}']['{name}']"]
            shard = self._build_shard(g("idx"), g("val"), g("nnz"))
            shard._alive = np.asarray(g("alive"), bool).copy()
            shard._deadline = np.asarray(g("deadline"), np.float64).copy()
            self.shards[i] = shard
            self._gids[i] = np.asarray(g("gids"), np.int32).copy()
            recovered.append(i)
        for r in range(self.n_replicas):
            self._lost[r].difference_update(recovered)
        for i in recovered:
            # post-checkpoint mutations on the shard were lost with it, so
            # its in-memory state matches the slice just read — but it may
            # DIFFER from the latest commit if that commit is newer, so
            # conservatively re-serialize it on the next incremental save
            self._dirty.add(i)
            self._shard_arrays[i] = self._assemble_shard(i)
        self._upload_stacks()
        self.stats.recoveries += len(recovered)
        self.stats.recovery_wall_s += time.perf_counter() - t0
        obs_trace.end_span(_sp, recovered=len(recovered))
        obs_recorder.get_recorder().record(
            "shard_recovered", shards=recovered,
            wall_s=round(time.perf_counter() - t0, 4))
        return tuple(recovered)

    # -- replica resync (DESIGN.md §10) --------------------------------------

    def resync_replicas(self) -> Tuple[int, ...]:
        """Anti-entropy pass: re-place every diverged replica's device
        state from the host mirror (the single source of truth every
        replica's tensors are a pure function of) and re-admit dead
        replicas HALF-OPEN — one successful probe dispatch returns them to
        the rotation, a failed probe drops them straight back to dead.

        Shape-stable divergence (missed write-throughs, lost shard copies)
        re-places only the dirty shards' slices; a replica that missed a
        geometry change gets a full re-placement.  No-op on an
        unreplicated store: with one copy there is nothing to resync FROM.
        Returns the resynced replicas.
        """
        if self.n_replicas == 1:
            return ()
        t0 = time.perf_counter()
        _sp = obs_trace.start_span("resync_replicas")
        resynced = []
        for r in range(self.n_replicas):
            was_dead = self.health.state(r) == ReplicaHealth.DEAD
            pending = self._replica_dirty[r] | self._lost[r]
            if not was_dead and not pending:
                continue
            self._lost[r].clear()
            self._replica_dirty[r].clear()
            stale_shape = self._stacks[r] is None or any(
                placed_shape(self._stacks[r][k]) != v.shape
                for k, v in self._stacked_host.items()
            )
            if stale_shape or len(pending) >= self.n_shards:
                self._place_replica_full(r)
            else:
                self._place_replica_shards(r, sorted(pending))
                # divergence may include tombstone flips that happened while
                # the replica was out — the valid mask re-places wholesale
                self._refresh_replica_valid(r)
            if was_dead:
                self.health.mark_resynced(r)
            resynced.append(r)
            self.stats.resyncs += 1
        if resynced:
            self.stats.resync_wall_s += time.perf_counter() - t0
            obs_recorder.get_recorder().record(
                "replicas_resynced", replicas=resynced,
                wall_s=round(time.perf_counter() - t0, 4))
        obs_trace.end_span(_sp, resynced=len(resynced))
        return tuple(resynced)

    def verify_replicas(self) -> bool:
        """Bit-parity audit: every non-dead replica's device tensors must
        equal the host mirror (index arrays, ids, and that replica's valid
        fold).  Raises ``ValueError`` naming the first divergent
        (replica, leaf); returns True when all replicas agree."""
        for r in range(self.n_replicas):
            if self.health.state(r) == ReplicaHealth.DEAD:
                continue
            for k, host in self._stacked_host.items():
                want = self._replica_valid(r) if k == "valid" else host
                got = placed_numpy(self._stacks[r][k])
                if not np.array_equal(got, want):
                    raise ValueError(
                        f"replica {r} leaf {k!r} diverges from the host "
                        "mirror (resync_replicas() repairs this)")
        return True
