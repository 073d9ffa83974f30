"""The benchmark's inputs, made from a seed in bulk with NumPy.

Frozen yardstick: the program never sees this file, and a later change
to the program's own generators (``repro_torch/sparse/datagen.py``)
does not move the benchmark's data.  The two generators draw the
program's distributions (the paper's §5.1 synthetic vectors and the
§5.2 spectra-like vectors) with whole-array calls, so a 207,804-row
library takes about a second, where the program's row loop takes 15.
They do not draw the same random stream as the program's generators:
the distributions are the same, the bytes are not.

The rows' sizes (a synthetic vector's nonzeros, a spectrum's peak
draws) are one sample of the configuration's distribution, the same for
every seed, which each seed puts in an order of its own; the seed draws
the positions, the values and that order.  So every seed makes the same
amount of work and arrays of one shape, and the library's memory does
not move with the seed.  Each returns padded-CSR host arrays ``(idx,
val, nnz)`` whose width F is the largest of those sizes (at most the
configuration's ``max_features``, where the program's generators cut a
row): the widest row's own width, as a ``SparseBatch`` of the same rows
has it (a spectrum's binning may merge a peak or two of it):

  idx (N, F) int32, ascending in each row, padded with ``dim``;
  val (N, F) float32, 0 in the padding;
  nnz (N,)  int32.
"""
from __future__ import annotations

import numpy as np

# the stream of the rows' sizes (with the row count), the same for every seed
SIZES_SEED = 0


def _sizes(n: int, draw) -> np.ndarray:
    """The configuration's ``n`` row sizes, ``draw(rng, n)`` from a stream
    that no seed moves."""
    return draw(np.random.default_rng([SIZES_SEED, n]), n)


def _pack(cols: np.ndarray, draw_vals, dim: int, width: int):
    """Rows of distinct candidate columns (``dim`` = empty slot, any order,
    at least ``width`` of them) -> sorted padded CSR of ``width`` slots a
    row (a longer row keeps its ``width`` lowest columns, as the program's
    generators cut at ``max_features``), with values drawn by
    ``draw_vals(idx)`` into the filled slots (the values are i.i.d., so
    drawing them after the sort leaves their distribution as it is)."""
    idx = np.ascontiguousarray(np.sort(cols.astype(np.int32), axis=1)[:, :width])
    nnz = (idx < dim).sum(axis=1).astype(np.int32)
    val = np.where(idx < dim, draw_vals(idx), 0.0).astype(np.float32)
    return idx, val, nnz


def _first_occurrence(cols: np.ndarray) -> np.ndarray:
    """(N, M) bool: True where a row's value has not appeared earlier in it."""
    order = np.argsort(cols, axis=1, kind="stable")
    s = np.take_along_axis(cols, order, axis=1)
    dup_sorted = np.zeros(s.shape, bool)
    dup_sorted[:, 1:] = s[:, 1:] == s[:, :-1]
    dup = np.empty_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return ~dup


def synthetic(n: int, dim: int, nnz_mean: float, nnz_std: float, max_features: int, seed):
    """The paper's synthetic vectors: |x| ~ N(nnz_mean, nnz_std) clipped to
    [1, min(dim, max_features)], the positions a uniform draw without
    replacement, the weights U[0.001, 1)."""
    rng = np.random.default_rng(seed)
    want = rng.permutation(_sizes(n, lambda g, m: np.clip(
        g.normal(nnz_mean, nnz_std, size=m).astype(np.int64), 1, min(dim, max_features))))
    width = int(want.max())
    # draws with replacement; the first `want` distinct values of a row, in
    # draw order, are a uniform draw without replacement
    extra = 64
    while True:
        cand = rng.integers(0, dim, size=(n, min(width + extra, 8 * dim)))
        first = _first_occurrence(cand)
        rank = np.cumsum(first, axis=1) - 1
        if (first.sum(axis=1) >= want).all():
            break
        extra *= 2
    keep = first & (rank < want[:, None])
    return _pack(np.where(keep, cand, dim), lambda idx: rng.uniform(1e-3, 1.0, size=idx.shape),
                 dim, width)


def spectra(n: int, dim: int, peaks_mean: float, max_features: int, seed):
    """MS/MS-like spectra: k = max(4, Poisson(peaks_mean)) peak draws around a
    precursor position U(0.1, 0.9)·dim with spread 0.15·dim, binned and
    deduplicated (at most ``max_features`` bins kept, the lowest);
    intensities Exp(1) normalised to a row maximum of 1."""
    rng = np.random.default_rng(seed)
    k = rng.permutation(_sizes(n, lambda g, m: np.maximum(4, g.poisson(peaks_mean, size=m))))
    width = int(k.max())
    base = rng.uniform(0.1, 0.9, size=n) * dim
    pos = np.clip((base[:, None] + rng.normal(0.0, dim * 0.15, size=(n, width)))
                  .astype(np.int32), 0, dim - 1)
    pos = np.where(np.arange(width)[None, :] < k[:, None], pos, dim)
    pos.sort(axis=1)
    pos[:, 1:][pos[:, 1:] == pos[:, :-1]] = dim           # binned: one peak a bin

    def intensities(idx):
        inten = rng.exponential(1.0, size=idx.shape).astype(np.float32)
        inten[idx == dim] = 0.0
        return inten / np.maximum(inten.max(axis=1, keepdims=True), 1e-6)

    return _pack(pos, intensities, dim, min(width, max_features))


GENERATORS = {"synthetic": synthetic, "spectra": spectra}


def make(config: dict, n: int, seed):
    """``n`` rows of a configuration (its ``dim`` and its ``generator``
    entry: ``kind`` and the generator's keyword arguments) from ``seed``
    (an int or a list of ints, as ``numpy.random.default_rng`` takes it)."""
    gen = config["generator"]
    kw = {key: v for key, v in gen.items() if key != "kind"}
    return GENERATORS[gen["kind"]](n, dim=config["dim"], seed=seed, **kw)


def inputs(config: dict, seed: int):
    """(R, S) of a configuration, each ``(idx, val, nnz)``, from one seed:
    R and S draw from two streams of it."""
    seed = int(seed) % 2**64
    return make(config, config["n_r"], [seed, 0]), make(config, config["n_s"], [seed, 1])
