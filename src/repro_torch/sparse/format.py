"""Padded-CSR sparse batch format and dim-tile statistics (PyTorch).

The same layout as the JAX package's ``repro.sparse.format``: a batch of
N sparse vectors is a padded feature matrix

  indices: (N, F) int32 — dimension index of each feature, ascending per
                          row, padded with ``dim`` (a sentinel that
                          scatters into a discard slot).
  values:  (N, F) f32   — feature weights, 0.0 in padding slots.
  nnz:     (N,)  int32  — number of valid features per row.

Tensors may live on any device; host-side constructors build on the CPU
and the engine moves what it needs to its compute device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import to_device

DEFAULT_TILE = 128


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """A batch of N sparse vectors of dimensionality ``dim`` (padded CSR)."""

    indices: torch.Tensor  # (N, F) int32, padded with self.dim
    values: torch.Tensor   # (N, F) f32, padded with 0
    nnz: torch.Tensor      # (N,)  int32
    dim: int

    @property
    def num_vectors(self) -> int:
        return self.indices.shape[0]

    @property
    def max_features(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to(self, device) -> "SparseBatch":
        """The batch on ``device`` (``device.to_device``: a copy to a CUDA
        device does not make the host wait)."""
        return SparseBatch(
            indices=to_device(self.indices, device), values=to_device(self.values, device),
            nnz=to_device(self.nnz, device), dim=self.dim,
        )

    def rows(self, lo: int, hi: int) -> "SparseBatch":
        """Row slice ``[lo, hi)`` (a view)."""
        return SparseBatch(
            indices=self.indices[lo:hi], values=self.values[lo:hi],
            nnz=self.nnz[lo:hi], dim=self.dim,
        )

    @classmethod
    def from_dense(cls, dense: np.ndarray, max_features: int | None = None) -> "SparseBatch":
        """Pack a dense (N, D) array (host-side; the result lies on the CPU)."""
        dense = np.asarray(dense)
        n, d = dense.shape
        nnz = (dense != 0).sum(axis=1).astype(np.int32)
        f = int(max_features if max_features is not None else max(int(nnz.max(initial=0)), 1))
        indices = np.full((n, f), d, dtype=np.int32)
        values = np.zeros((n, f), dtype=np.float32)
        for i in range(n):
            (nz,) = np.nonzero(dense[i])
            nz = nz[:f]
            indices[i, : len(nz)] = nz
            values[i, : len(nz)] = dense[i, nz]
        return from_arrays(indices, values, np.minimum(nnz, f), d)

    @classmethod
    def from_coo(
        cls,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        num_vectors: int,
        dim: int,
        max_features: int | None = None,
    ) -> "SparseBatch":
        """Pack COO triplets (host-side; the result lies on the CPU)."""
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        counts = np.bincount(rows, minlength=num_vectors)
        f = int(max_features if max_features is not None else max(int(counts.max(initial=0)), 1))
        indices = np.full((num_vectors, f), dim, dtype=np.int32)
        values = np.zeros((num_vectors, f), dtype=np.float32)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for i in range(num_vectors):
            lo, hi = starts[i], min(starts[i + 1], starts[i] + f)
            k = hi - lo
            indices[i, :k] = cols[lo:hi]
            values[i, :k] = vals[lo:hi]
        return from_arrays(indices, values, np.minimum(counts, f).astype(np.int32), dim)


def from_arrays(indices, values, nnz, dim: int, device="cpu") -> SparseBatch:
    """A batch from host arrays, e.g. the JAX package's ``SparseBatch``
    fields as ``np.asarray(b.indices)`` and so on: both packages then
    score the same bytes."""
    return SparseBatch(
        indices=torch.tensor(np.asarray(indices, np.int32), device=device),
        values=torch.tensor(np.asarray(values, np.float32), device=device),
        nnz=torch.tensor(np.asarray(nnz, np.int32), device=device),
        dim=int(dim),
    )


def densify(batch: SparseBatch) -> torch.Tensor:
    """(N, D) dense view, on the batch's device.  Scatter-add with a
    discard column for padding."""
    n = batch.num_vectors
    out = torch.zeros((n, batch.dim + 1), dtype=batch.values.dtype, device=batch.device)
    out.scatter_add_(1, batch.indices.long(), batch.values)
    return out[:, : batch.dim]


def densify_tile(batch: SparseBatch, tile_start: int, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """(N, tile) dense view of one dim-tile ``[tile_start, tile_start + tile)``."""
    rel = batch.indices.long() - tile_start
    in_tile = (rel >= 0) & (rel < tile)
    rel = torch.where(in_tile, rel, tile)  # discard slot
    vals = torch.where(in_tile, batch.values, 0.0)
    out = torch.zeros((batch.num_vectors, tile + 1), dtype=batch.values.dtype,
                      device=batch.device)
    out.scatter_add_(1, rel, vals)
    return out[:, :tile]


def num_tiles(dim: int, tile: int = DEFAULT_TILE) -> int:
    return -(-dim // tile)


def tile_occupancy(batch: SparseBatch, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """(N, n_tiles) bool — does vector i have any non-zero in dim-tile t?"""
    nt = num_tiles(batch.dim, tile)
    idx = batch.indices.long()
    tid = torch.clamp(idx // tile, max=nt)          # padding -> discard slot nt
    occ = torch.zeros((batch.num_vectors, nt + 1), dtype=torch.int32, device=idx.device)
    occ.scatter_add_(1, tid, (idx < batch.dim).to(torch.int32))
    return occ[:, :nt] > 0


def dim_frequency(batch: SparseBatch) -> torch.Tensor:
    """(D,) int32 — number of vectors in the batch with a non-zero in each
    dim (the paper's IIIB walks dims most frequent first)."""
    valid = batch.indices < batch.dim
    idx = torch.where(valid, batch.indices, batch.dim).long().reshape(-1)
    counts = torch.zeros(batch.dim + 1, dtype=torch.int32, device=batch.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[: batch.dim]


def max_weight_per_dim(batch: SparseBatch) -> torch.Tensor:
    """(D,) — ``maxWeight_d(B_r)`` from the paper: max value of dim d over
    the batch (0 where no vector has the dim)."""
    valid = batch.indices < batch.dim
    idx = torch.where(valid, batch.indices, batch.dim).long().reshape(-1)
    vals = torch.where(valid, batch.values, 0.0).reshape(-1)
    out = torch.zeros(batch.dim + 1, dtype=batch.values.dtype, device=batch.device)
    out.scatter_reduce_(0, idx, vals, "amax", include_self=True)
    return out[: batch.dim]


def reorder_dims(batch: SparseBatch, perm: torch.Tensor) -> SparseBatch:
    """Apply a dimension permutation: new_dim_of[d] = perm[d].  Rows are not
    re-sorted."""
    lut = torch.cat([perm.to(torch.int32),
                     torch.tensor([batch.dim], dtype=torch.int32, device=perm.device)])
    new_idx = lut[torch.clamp(batch.indices.long(), max=batch.dim)]
    return SparseBatch(indices=new_idx, values=batch.values, nnz=batch.nnz, dim=batch.dim)


def frequency_permutation(freq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv): perm[d] = new index of dim d in descending frequency
    order (stable: equal frequencies keep dim order), inv = the order."""
    order = torch.argsort(-freq, stable=True)    # order[j] = old dim at new pos j
    d = freq.shape[0]
    perm = torch.zeros(d, dtype=torch.int32, device=freq.device)
    perm[order] = torch.arange(d, dtype=torch.int32, device=freq.device)
    return perm, order
