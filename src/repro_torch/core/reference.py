"""Literal (paper-faithful) reference implementations of BF / IIB / IIIB.

These are the paper's Algorithms 2–4 implemented on the host with numpy,
at matching cost models:

* BF   — cost C2 = Σ_i Σ_j (|r_i| + |s_j|): every pair is scored, every
         feature of every s is touched for every r (CSR mat-vec per r).
* IIB  — cost C3 = Σ_i |s_i|  +  Σ_r Σ_{d ∈ r} |I_d|: inverted lists are
         built once per S block; each r only walks the lists of its own
         non-zero dimensions.
* IIIB — IIB + the threshold refinement of §4.4: dimensions are walked in
         descending frequency(B_r) order while a trivial upper bound
         t += maxWeight_d(B_r)·s[d] accumulates; features are indexed only
         once t > MinPruneScore.  Unindexed prefixes are completed by an
         exact residual dot product for every accumulator hit (Theorem 1).

A numpy copy of ``repro.core.reference``: the port's own ground truth,
so that its tests and ``chip_smoke.py`` need nothing of the JAX package.

The block nested-loop driver (Algorithm 1) lives in ``reference_join``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# host-side CSR block
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostCSR:
    """A block of sparse vectors in CSR, host-side."""

    indptr: np.ndarray   # (N+1,) int64
    indices: np.ndarray  # (nnz,) int64, ascending within each row
    values: np.ndarray   # (nnz,) float64
    dim: int

    @property
    def num_vectors(self) -> int:
        return len(self.indptr) - 1

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.values[lo:hi]

    @classmethod
    def from_padded(cls, indices: np.ndarray, values: np.ndarray, nnz: np.ndarray, dim: int) -> "HostCSR":
        indices = np.asarray(indices)
        values = np.asarray(values, dtype=np.float64)
        nnz = np.asarray(nnz)
        rows: List[np.ndarray] = []
        cols: List[np.ndarray] = []
        vals: List[np.ndarray] = []
        for i in range(indices.shape[0]):
            k = int(nnz[i])
            order = np.argsort(indices[i, :k], kind="stable")
            cols.append(indices[i, :k][order].astype(np.int64))
            vals.append(values[i, :k][order])
            rows.append(np.full(k, i))
        counts = np.array([len(c) for c in cols], dtype=np.int64)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return cls(
            indptr=indptr,
            indices=np.concatenate(cols) if cols else np.zeros(0, np.int64),
            values=np.concatenate(vals) if vals else np.zeros(0, np.float64),
            dim=dim,
        )

    def slice_rows(self, start: int, stop: int) -> "HostCSR":
        lo, hi = self.indptr[start], self.indptr[stop]
        return HostCSR(
            indptr=self.indptr[start : stop + 1] - lo,
            indices=self.indices[lo:hi],
            values=self.values[lo:hi],
            dim=self.dim,
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.num_vectors, self.dim))
        for i in range(self.num_vectors):
            idx, val = self.row(i)
            out[i, idx] = val
        return out


# ---------------------------------------------------------------------------
# per-R-block KNN candidate state (pruneScore bookkeeping)
# ---------------------------------------------------------------------------

class WorkCounters:
    """Feature-touch counters mirroring the paper's cost models.

    C2 (BF):   Σ_r Σ_s (|r| + |s|)        -> ``bf_touches``
    C3 (IIB):  Σ|s| + Σ_r Σ_{d∈r} |I_d|   -> ``build_touches + scan_touches``
    IIIB:      C3 over the *indexed* features only + rescue residual work.
    """

    def __init__(self):
        self.bf_touches = 0
        self.build_touches = 0     # features inserted into inverted lists
        self.scan_touches = 0      # inverted-list entries walked
        self.rescue_touches = 0    # residual-dot features (IIIB lines 20-21)

    def total(self) -> int:
        return (self.bf_touches + self.build_touches + self.scan_touches
                + self.rescue_touches)


class _KnnState:
    """Top-k candidate sets for one R block. pruneScore(r) = k-th best score."""

    def __init__(self, n: int, k: int):
        self.k = k
        self.scores = np.full((n, k), -np.inf)
        self.ids = np.full((n, k), -1, dtype=np.int64)

    def prune_score(self, r: int) -> float:
        return self.scores[r, -1]

    def min_prune_score(self) -> float:
        return float(self.scores[:, -1].min())

    def offer(self, r: int, cand_ids: np.ndarray, cand_scores: np.ndarray) -> None:
        if len(cand_ids) == 0:
            return
        sc = np.concatenate([self.scores[r], cand_scores])
        ids = np.concatenate([self.ids[r], cand_ids])
        top = np.argsort(-sc, kind="stable")[: self.k]
        self.scores[r] = sc[top]
        self.ids[r] = ids[top]


# ---------------------------------------------------------------------------
# Algorithm 2 — BF
# ---------------------------------------------------------------------------

def _bf_block(state: _KnnState, br: HostCSR, bs: HostCSR, s_offset: int,
              work: WorkCounters | None = None) -> None:
    """Score every (r, s) pair. Work ∝ Σ_r Σ_s |s| (+|r| densify) = C2."""
    r_dense = np.zeros(br.dim)
    s_rows = np.repeat(np.arange(bs.num_vectors), np.diff(bs.indptr))
    for r in range(br.num_vectors):
        idx, val = br.row(r)
        r_dense[idx] = val                       # |r| work
        if work is not None:
            work.bf_touches += len(bs.values) + len(idx)
        # CSR mat-vec: touches EVERY feature of EVERY s — the C2 term.
        contrib = bs.values * r_dense[bs.indices]
        scores = np.bincount(s_rows, weights=contrib, minlength=bs.num_vectors)
        r_dense[idx] = 0.0
        mask = scores > state.prune_score(r)
        cand = np.nonzero(mask)[0]
        state.offer(r, cand + s_offset, scores[cand])


# ---------------------------------------------------------------------------
# Algorithm 3 — IIB
# ---------------------------------------------------------------------------

def _build_inverted(bs: HostCSR) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSC inverted lists: for each dim d, the (s, s[d]) pairs. Work Σ|s|."""
    order = np.argsort(bs.indices, kind="stable")
    cols = bs.indices[order]
    vals = bs.values[order]
    rows = np.repeat(np.arange(bs.num_vectors), np.diff(bs.indptr))[order]
    colptr = np.searchsorted(cols, np.arange(bs.dim + 1))
    return colptr, rows, vals


def _iib_block(state: _KnnState, br: HostCSR, bs: HostCSR, s_offset: int,
               work: WorkCounters | None = None) -> None:
    colptr, inv_rows, inv_vals = _build_inverted(bs)
    if work is not None:
        work.build_touches += len(bs.values)     # Σ|s| index build
    for r in range(br.num_vectors):
        idx, val = br.row(r)
        acc = np.zeros(bs.num_vectors)
        touched: List[np.ndarray] = []
        for d, w in zip(idx, val):               # only r's own dims
            lo, hi = colptr[d], colptr[d + 1]    # walk I_d — the C3 term
            if lo == hi:
                continue
            if work is not None:
                work.scan_touches += hi - lo
            acc[inv_rows[lo:hi]] += w * inv_vals[lo:hi]
            touched.append(inv_rows[lo:hi])
        if not touched:
            continue
        cand = np.unique(np.concatenate(touched))
        scores = acc[cand]
        keep = scores > state.prune_score(r)
        state.offer(r, cand[keep] + s_offset, scores[keep])


# ---------------------------------------------------------------------------
# Algorithm 4 — IIIB
# ---------------------------------------------------------------------------

def _iiib_block(state: _KnnState, br: HostCSR, bs: HostCSR, s_offset: int,
                work: WorkCounters | None = None) -> None:
    mps = state.min_prune_score()

    # line 6: dims ordered by frequency in B_r (most frequent first)
    freq = np.zeros(br.dim, dtype=np.int64)
    np.add.at(freq, br.indices, 1)
    rank = np.empty(br.dim, dtype=np.int64)
    rank[np.argsort(-freq, kind="stable")] = np.arange(br.dim)

    # line 7: maxWeight_d(B_r)
    maxw = np.zeros(br.dim)
    np.maximum.at(maxw, br.indices, br.values)

    # lines 8-14: index only the feature suffix past the UB crossing
    idx_cols: List[np.ndarray] = []
    idx_rows: List[np.ndarray] = []
    idx_vals: List[np.ndarray] = []
    res_features: List[Tuple[np.ndarray, np.ndarray]] = []  # unindexed (prefix) per s
    for s in range(bs.num_vectors):
        d, w = bs.row(s)
        order = np.argsort(rank[d], kind="stable")          # frequency order
        d, w = d[order], w[order]
        t = np.cumsum(maxw[d] * w)
        crossed = t > mps
        if mps == -np.inf:
            crossed[:] = True                               # no threshold yet: index all
        first = int(np.argmax(crossed)) if crossed.any() else len(d)
        idx_cols.append(d[first:])
        idx_rows.append(np.full(len(d) - first, s))
        idx_vals.append(w[first:])
        if work is not None:
            work.build_touches += len(d) - first            # only indexed features
        res_features.append((d[:first], w[:first]))         # “removed” features (line 14)

    cols = np.concatenate(idx_cols) if idx_cols else np.zeros(0, np.int64)
    rows = np.concatenate(idx_rows) if idx_rows else np.zeros(0, np.int64)
    vals = np.concatenate(idx_vals) if idx_vals else np.zeros(0, np.float64)
    order = np.argsort(cols, kind="stable")
    cols, rows, vals = cols[order], rows[order], vals[order]
    colptr = np.searchsorted(cols, np.arange(bs.dim + 1))

    r_dense = np.zeros(br.dim)
    for r in range(br.num_vectors):
        idx, val = br.row(r)
        acc = np.zeros(bs.num_vectors)
        touched: List[np.ndarray] = []
        for d, w in zip(idx, val):
            lo, hi = colptr[d], colptr[d + 1]
            if lo == hi:
                continue
            if work is not None:
                work.scan_touches += hi - lo
            acc[rows[lo:hi]] += w * vals[lo:hi]
            touched.append(rows[lo:hi])
        if not touched:
            continue
        cand = np.unique(np.concatenate(touched))
        # lines 20-21: complete scores with the unindexed residual
        r_dense[idx] = val
        for s in cand:
            rd, rw = res_features[s]
            if len(rd):
                if work is not None:
                    work.rescue_touches += len(rd)
                acc[s] += float(r_dense[rd] @ rw)
        r_dense[idx] = 0.0
        scores = acc[cand]
        keep = scores > state.prune_score(r)
        state.offer(r, cand[keep] + s_offset, scores[keep])


# ---------------------------------------------------------------------------
# Algorithm 1 — block nested-loop driver
# ---------------------------------------------------------------------------

_ALGOS: dict[str, Callable[[_KnnState, HostCSR, HostCSR, int], None]] = {
    "bf": _bf_block,
    "iib": _iib_block,
    "iiib": _iiib_block,
}


def reference_join(
    R: HostCSR,
    S: HostCSR,
    k: int,
    algorithm: str = "iiib",
    r_block: int | None = None,
    s_block: int | None = None,
    work: WorkCounters | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Block nested-loop KNN join (paper Algorithm 1). Returns (scores, ids).

    ``ids`` are global S indices, score-descending per row; unfilled slots are
    -1 with -inf score.  ``work`` (optional) accumulates the paper's
    machine-independent cost-model counters (C2 / C3).
    """
    algo = _ALGOS[algorithm]
    r_block = r_block or R.num_vectors
    s_block = s_block or S.num_vectors
    all_scores = np.full((R.num_vectors, k), -np.inf)
    all_ids = np.full((R.num_vectors, k), -1, dtype=np.int64)
    for r0 in range(0, R.num_vectors, r_block):
        r1 = min(r0 + r_block, R.num_vectors)
        br = R.slice_rows(r0, r1)
        state = _KnnState(r1 - r0, k)            # InitPruneScore
        for s0 in range(0, S.num_vectors, s_block):
            s1 = min(s0 + s_block, S.num_vectors)
            algo(state, br, S.slice_rows(s0, s1), s0, work)
        all_scores[r0:r1] = state.scores
        all_ids[r0:r1] = state.ids
    return all_scores, all_ids


def oracle_knn(dense_r: np.ndarray, dense_s: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense argsort oracle — the unarguable ground truth for tests."""
    scores = dense_r @ dense_s.T
    ids = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(scores, ids, axis=1)
    return top, ids
