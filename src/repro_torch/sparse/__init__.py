"""Sparse-vector substrate: padded-CSR batches, dim-tile statistics, data generation."""
from repro_torch.sparse.datagen import spectra_like, synthetic_sparse
from repro_torch.sparse.format import (
    SparseBatch,
    densify,
    densify_tile,
    dim_frequency,
    max_weight_per_dim,
    reorder_dims,
    tile_occupancy,
)

__all__ = [
    "SparseBatch",
    "densify",
    "densify_tile",
    "dim_frequency",
    "max_weight_per_dim",
    "reorder_dims",
    "tile_occupancy",
    "synthetic_sparse",
    "spectra_like",
]
