"""Distributed KNN join: the paper's block nested-loop join over a device
mesh (the PyTorch counterpart of ``repro.core.ring``).

``ring_knn_join`` is a compat wrapper over ``engine.distributed_join``,
which runs the sharded datastore (``repro_torch.store.ShardedKNNStore``
over the mesh): S is partitioned into build-once per-shard index stacks
and each R block is one fan-out with a top-k reduction.  The ring driver
below (``_ring_join_impl``) remains the implementation for ``dim_axis``
(dimension-sharded tensor parallelism: each model position scores its
own dim range, and the partial scores are summed before the merge) and
for an S with fewer rows than ring positions, which the store does not
cover.

The mesh is a ``launch/mesh.py::DeviceMesh`` and one process drives
every device; the reference's collectives become tensor moves:

* Each ring position (the flattened ``ring_axes`` of the mesh, e.g.
  ``("data",)``) holds a resident **R shard** (the paper's in-buffer B_r)
  and one **S shard**, on its device.
* At every step a position joins its R shard with the visiting S shard,
  then the S shard moves to the next position (the reference's
  ``lax.ppermute``: a copy to the next device, with no host sync).
* The paper's index-per-block-pair structure is kept: each position
  builds the (tile-)inverted index of the visiting S shard, IIIB with the
  position's own MinPruneScore, which tightens as the ring goes round
  (paper §4.4: "results of previous loops prune forthcoming loops").
* ``dim_axis``: each model position holds its dim range of the R shard
  and of the visiting S shard; its partial scores go to the position's
  first model device and are summed there in model order (the
  reference's ``psum``) before the merge.  BF and IIB only: IIIB's
  frequency-ordered cumulative bound does not factorize across dim
  shards (it rings with dims replicated).
* Every step merges through ``core/topk.py::merge_step``: the topk_merge
  kernel on CUDA tensors.

A mesh may repeat one device; the result lies on the mesh's first
device.  Exactness is inherited from the single-device algorithms; the
ring only changes which (B_r, B_s) pair is joined where and when.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bf import bf_block_scores, block_ids
from repro_torch.core.iiib import iiib_join_block_uniform, prepare_r_block
from repro_torch.core.index import build_tile_index, dense_r_tiles, tile_scores
from repro_torch.core.topk import NEG_INF, TopKState, init_topk, merge_step, min_prune_score
from repro_torch.device import to_device
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.sparse.format import SparseBatch, from_arrays, num_tiles


def _restrict_dims(block: SparseBatch, lo: int, local_dim: int) -> SparseBatch:
    """Project a SparseBatch onto dims [lo, lo+local_dim), reindexed from 0."""
    idx = block.indices
    ok = (idx >= lo) & (idx < lo + local_dim) & (idx < block.dim)
    return SparseBatch(
        indices=torch.where(ok, idx - lo, local_dim).to(torch.int32),
        values=torch.where(ok, block.values, 0.0),
        nnz=ok.sum(dim=1).to(torch.int32),
        dim=local_dim,
    )


def ring_knn_join(
    R: SparseBatch,
    S: SparseBatch,
    k: int,
    mesh: DeviceMesh,
    algorithm: str = "iiib",
    ring_axes: Sequence[str] = ("data",),
    dim_axis: Optional[str] = None,
    tile: int = 128,
    n_r_valid: Optional[int] = None,
    n_s_valid: Optional[int] = None,
) -> TopKState:
    """R ⋈_KNN S over a device mesh.

    Builds a JoinSpec and dispatches to
    :func:`repro_torch.core.engine.distributed_join`: the sharded store by
    default, the ring driver when ``dim_axis`` is set (only that path
    still requires R/S row counts to divide the ring size).  Returns a
    TopKState for all R rows with global S ids; ``n_*_valid`` mask padding
    rows appended by the caller."""
    from repro_torch.core.engine import JoinSpec, distributed_join

    spec = JoinSpec(k=k, algorithm=algorithm, tile=tile)
    return distributed_join(
        R, S, spec, mesh, ring_axes=ring_axes, dim_axis=dim_axis,
        n_r_valid=n_r_valid, n_s_valid=n_s_valid,
    )


def _ring_join_impl(
    R: SparseBatch,
    S: SparseBatch,
    k: int,
    mesh: DeviceMesh,
    algorithm: str = "iiib",
    ring_axes: Sequence[str] = ("data",),
    dim_axis: Optional[str] = None,
    tile: int = 128,
    n_r_valid: Optional[int] = None,
    n_s_valid: Optional[int] = None,
) -> TopKState:
    """The ring driver (see the module docstring for the mapping)."""
    if algorithm not in ("bf", "iib", "iiib"):
        raise ValueError(algorithm)
    if algorithm == "iiib" and dim_axis is not None:
        raise ValueError("iiib rings with dims replicated (see DESIGN.md)")

    ring_axes = tuple(ring_axes)
    n_ring = math.prod(mesh.shape[a] for a in ring_axes)
    n_r, n_s = R.num_vectors, S.num_vectors
    if n_r % n_ring or n_s % n_ring:
        raise ValueError(f"pad R ({n_r} rows) and S ({n_s}) to the ring size {n_ring} "
                         "(pad_to_ring)")
    r_shard, s_shard = n_r // n_ring, n_s // n_ring
    n_r_valid = n_r if n_r_valid is None else n_r_valid
    n_s_valid = n_s if n_s_valid is None else n_s_valid
    n_dim = mesh.shape[dim_axis] if dim_axis else 1
    if R.dim % n_dim:
        raise ValueError(f"dim {R.dim} must divide the model axis ({n_dim})")
    local_dim = R.dim // n_dim

    # grid[p][m]: the device of ring position p, model position m
    flat = mesh.devices_along(ring_axes + ((dim_axis,) if dim_axis else ()))
    grid = [flat[p * n_dim:(p + 1) * n_dim] for p in range(n_ring)]

    def local(batch: SparseBatch, p: int, m: int, rows: int) -> SparseBatch:
        """Position p's row shard of ``batch`` on grid[p][m], in m's dims."""
        part = batch.rows(p * rows, (p + 1) * rows).to(grid[p][m])
        return _restrict_dims(part, m * local_dim, local_dim) if dim_axis else part

    r_loc = [[local(R, p, m, r_shard) for m in range(n_dim)] for p in range(n_ring)]
    # the S shard each position holds at step 0, in each model position's
    # dims (restricting before the ring equals restricting every step)
    s_cur = [[local(S, p, m, s_shard) for m in range(n_dim)] for p in range(n_ring)]
    all_tiles = np.arange(num_tiles(local_dim, tile), dtype=np.int32)
    if algorithm == "iib":
        r_tiles = [[dense_r_tiles(b, tile) for b in row] for row in r_loc]
    elif algorithm == "iiib":
        prep = [prepare_r_block(row[0], tile) for row in r_loc]   # (rank, maxw, r_tiles)
    states = [init_topk(r_shard, k, device=grid[p][0]) for p in range(n_ring)]

    for t in range(n_ring):
        for p in range(n_ring):
            home = grid[p][0]
            s_off = ((p - t) % n_ring) * s_shard
            s_valid = (s_off + torch.arange(s_shard, device=home)) < n_s_valid
            if algorithm == "iiib":
                rank, maxw, rt = prep[p]
                s_use = s_cur[p][0]
                index = build_tile_index(
                    s_use, max_rows=s_shard, tile=tile, rank=rank, maxw=maxw,
                    min_prune_score=min_prune_score(states[p]), uniform=True,
                )
                states[p] = iiib_join_block_uniform(
                    states[p], r_loc[p][0], rt, rank, index, s_use, s_off, s_valid, tile=tile)
                continue
            parts: List[torch.Tensor] = []
            for m in range(n_dim):
                if algorithm == "bf":
                    parts.append(bf_block_scores(r_loc[p][m], s_cur[p][m]))
                else:
                    index = build_tile_index(s_cur[p][m], max_rows=s_shard, tile=tile)
                    parts.append(tile_scores(r_tiles[p][m], index, all_tiles))
            scores = parts[0]
            for part in parts[1:]:                      # the psum, in model order
                scores = scores + to_device(part, home)
            ok = s_valid[None, :] if algorithm == "bf" else (scores > 0.0) & s_valid[None, :]
            states[p] = merge_step(states[p], torch.where(ok, scores, NEG_INF),
                                   block_ids(s_off, s_shard, device=home))
        if t < n_ring - 1:
            # rotate S to the next ring position
            s_cur = [[s_cur[(p - 1) % n_ring][m].to(grid[p][m]) for m in range(n_dim)]
                     for p in range(n_ring)]

    # mask padding R rows (harmless but deterministic output), gather in
    # ring order on the first device
    out = grid[0][0]
    scores, ids = [], []
    for p, st in enumerate(states):
        ok = ((p * r_shard + torch.arange(r_shard, device=st.scores.device)) < n_r_valid)[:, None]
        scores.append(to_device(torch.where(ok, st.scores, NEG_INF), out))
        ids.append(to_device(torch.where(ok, st.ids, -1), out))
    return TopKState(scores=torch.cat(scores), ids=torch.cat(ids))


def pad_to_ring(batch: SparseBatch, n_ring: int) -> Tuple[SparseBatch, int]:
    """Pad a SparseBatch with empty rows so the ring divides it (host-side;
    the result lies on the batch's device).  Returns (batch, real rows)."""
    n = batch.num_vectors
    target = -(-n // n_ring) * n_ring
    if target == n:
        return batch, n
    pad = target - n
    f = batch.max_features
    idx = np.concatenate([batch.indices.cpu().numpy(),
                          np.full((pad, f), batch.dim, np.int32)])
    val = np.concatenate([batch.values.cpu().numpy(), np.zeros((pad, f), np.float32)])
    nnz = np.concatenate([batch.nnz.cpu().numpy(), np.zeros(pad, np.int32)])
    return from_arrays(idx, val, nnz, batch.dim, device=batch.device), n
