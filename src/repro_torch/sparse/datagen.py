"""Synthetic sparse vectors mirroring the paper's evaluation data.

Numpy copies of ``repro.sparse.datagen``: for the same seed they draw the
same random numbers in the same order, so the arrays are byte-identical
to the JAX package's.

* :func:`synthetic_sparse` — the paper's synthetic setting (§5.1).
* :func:`spectra_like` — MS/MS-spectrum-like vectors after the Yeast /
  Worm datasets (§5.2): m/z binned at 0.1 Da (dim = m/z * 10), clustered
  peak positions and exponentially distributed intensities.
* :func:`gen_clustered` — the planted-neighbour workload of the approx
  tier's recall contract (a copy of ``benchmarks/common.py``'s).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.format import SparseBatch, from_arrays


def synthetic_sparse(
    num_vectors: int,
    dim: int = 10_000,
    nnz_mean: int = 120,
    nnz_std: int = 30,
    seed: int = 0,
    max_features: int | None = None,
) -> SparseBatch:
    """Random sparse vectors: |x| ~ N(nnz_mean, nnz_std), weights ~ U(0, 1]."""
    rng = np.random.default_rng(seed)
    nnz = np.clip(rng.normal(nnz_mean, nnz_std, size=num_vectors).astype(np.int64), 1, dim)
    f = int(max_features if max_features is not None else nnz.max())
    rows, cols, vals = [], [], []
    for i in range(num_vectors):
        k = min(int(nnz[i]), f)
        c = rng.choice(dim, size=k, replace=False)
        c.sort()
        rows.append(np.full(k, i, dtype=np.int64))
        cols.append(c)
        vals.append(rng.uniform(1e-3, 1.0, size=k))
    return SparseBatch.from_coo(
        np.concatenate(rows),
        np.concatenate(cols).astype(np.int64),
        np.concatenate(vals).astype(np.float32),
        num_vectors=num_vectors,
        dim=dim,
        max_features=f,
    )


def spectra_like(
    num_vectors: int,
    dim: int = 20_000,          # m/z up to 2000 Da at 0.1 granularity
    peaks_mean: int = 80,
    seed: int = 0,
    max_features: int | None = None,
) -> SparseBatch:
    """MS/MS-like spectra: clustered peak positions + exponential intensities."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(num_vectors):
        k = max(4, int(rng.poisson(peaks_mean)))
        # peak positions cluster around a random precursor-mass ladder
        base = rng.uniform(0.1, 0.9) * dim
        pos = np.clip(
            (base + rng.normal(0, dim * 0.15, size=k)).astype(np.int64), 0, dim - 1
        )
        pos = np.unique(pos)
        inten = rng.exponential(scale=1.0, size=len(pos)).astype(np.float32)
        inten /= max(inten.max(), 1e-6)  # normalize like preprocessed spectra
        rows.append(np.full(len(pos), i, dtype=np.int64))
        cols.append(pos)
        vals.append(inten)
    f = max_features
    if f is None:
        f = max(int(np.bincount(np.concatenate(rows)).max()), 1)
    return SparseBatch.from_coo(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        num_vectors=num_vectors,
        dim=dim,
        max_features=f,
    )


def gen_clustered(n_clusters: int, per_cluster: int, dim: int, nnz: int, seed: int,
                  noise: float = 0.05):
    """Planted-neighbour workload for recall measurement: (R, S) where S
    holds ``per_cluster`` noisy copies of each cluster centre and R one
    noisy probe per cluster, all on the centre's support (cosine ~0.95+
    within a cluster, near-orthogonal across).  Uniform random sparse data
    has no high-similarity neighbours, so a recall contract is only
    meaningful on planted structure with ``per_cluster >= k``."""
    rng = np.random.default_rng(seed)
    cidx = np.stack([
        np.sort(rng.choice(dim, size=nnz, replace=False))
        for _ in range(n_clusters)
    ]).astype(np.int32)
    cval = rng.random((n_clusters, nnz)).astype(np.float32) + 0.5
    cval /= np.linalg.norm(cval, axis=1, keepdims=True)

    def noisy(c):
        v = cval[c] + noise * rng.standard_normal(nnz).astype(np.float32)
        return np.abs(v).astype(np.float32)

    def batch(idx_rows, val_rows):
        return from_arrays(np.stack(idx_rows), np.stack(val_rows),
                           np.full(len(idx_rows), nnz, np.int32), dim)

    s_idx, s_val, r_idx, r_val = [], [], [], []
    for c in range(n_clusters):
        for _ in range(per_cluster):
            s_idx.append(cidx[c])
            s_val.append(noisy(c))
        r_idx.append(cidx[c])
        r_val.append(noisy(c))
    return batch(r_idx, r_val), batch(s_idx, s_val)
