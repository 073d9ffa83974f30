"""Synthetic sparse vectors: the paper's synthetic setting (§5.1).

A numpy copy of ``repro.sparse.datagen.synthetic_sparse``: for the same
seed it draws the same random numbers in the same order, so the arrays
are byte-identical to the JAX package's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.format import SparseBatch


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
