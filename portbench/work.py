"""Work counts and the chip's peaks: the yardstick of ``join_mfu`` and of the
kernels' roofline shares.

Frozen, and computed from the inputs with NumPy, never from how the
program does the work: a design that scores fewer dense tiles does not
lower its own bound.  A bound is the least time the inputs need on the
chip, the larger of operations over peak FLOP/s and bytes over peak
bandwidth; a roofline share is that bound over the measured time.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, dense rates at the 700 W limit (NVIDIA's data sheet).
# The join keeps float32 products (no TF32), so float32 outside the tensor
# cores is its compute peak.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]

ENTRY_BYTES = 8      # a nonzero: int32 index + float32 value
RESULT_BYTES = 8     # a result slot: float32 score + int32 id
SCORE_BYTES = 4      # a candidate score, float32


def peak(device_kind: str) -> dict:
    """The peaks of a card by its ``torch.cuda.get_device_name()``; the
    H100 SXM's for a name the table lacks."""
    return PEAKS.get(device_kind, DEFAULT_PEAK)


def dim_counts(idx: np.ndarray, dim: int) -> np.ndarray:
    """(dim,) int64: how many rows hold each dimension."""
    flat = np.asarray(idx).ravel()
    return np.bincount(flat[flat < dim], minlength=dim).astype(np.int64)


def join_flops(r_idx: np.ndarray, s_idx: np.ndarray, dim: int) -> float:
    """The multiply-adds the sparse dot products of R ⋈ S need, as FLOPs:
    2 · Σ_d nnz_R(d) · nnz_S(d)."""
    return 2.0 * float(np.dot(dim_counts(r_idx, dim).astype(np.float64),
                              dim_counts(s_idx, dim).astype(np.float64)))


def join_bytes(r_nnz: int, s_nnz: int, n_r: int, k: int) -> float:
    """Each nonzero of R and S read once, the (n_r, k) result written once."""
    return float(ENTRY_BYTES * (r_nnz + s_nnz) + RESULT_BYTES * n_r * k)


def merge_bytes(n: int, m: int, k: int) -> float:
    """A top-k merge of (n, m) candidate scores into an (n, k) state: the
    candidates read once, the state read and written once."""
    return float(SCORE_BYTES * n * m + 2 * RESULT_BYTES * n * k)


def bound_s(flops: float, nbytes: float, device_kind: str) -> tuple[float, str]:
    """(the least seconds, "flops" or "bytes": which of the two bounds it)."""
    p = peak(device_kind)
    t_ops, t_bytes = flops / p["fp32_flops"], nbytes / p["hbm_bytes_per_s"]
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_bounds(r_idx: np.ndarray, r_nnz: np.ndarray, s_idx: np.ndarray, s_nnz: np.ndarray,
                 dim: int, k: int, r_block: int, device_kind: str) -> list[tuple[float, str]]:
    """The bound of each R block's join against all of S (the work of one
    fused ``knn_topk`` launch), in R order."""
    s_counts = dim_counts(s_idx, dim).astype(np.float64)
    s_total = int(np.asarray(s_nnz).sum())
    out = []
    for lo in range(0, len(r_idx), r_block):
        hi = min(lo + r_block, len(r_idx))
        flops = 2.0 * float(np.dot(dim_counts(r_idx[lo:hi], dim).astype(np.float64), s_counts))
        nbytes = join_bytes(int(np.asarray(r_nnz[lo:hi]).sum()), s_total, hi - lo, k)
        out.append(bound_s(flops, nbytes, device_kind))
    return out
