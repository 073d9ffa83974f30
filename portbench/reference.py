"""The plain reference of an exact kNN join, and the comparison that decides
``correct``.

Frozen yardstick, in plain PyTorch and NumPy; it imports nothing of the
program.  It takes the benchmark's own padded-CSR host arrays (the
inputs both sides were handed) and the program's answers, and works out
everything else again:

* :func:`topk` — each query row's k best inner-product scores over S in
  float64: dense float64 products of the rows against S in blocks of
  rows, then ``torch.topk``.  A product of two float32 values is exact
  in float64, so its error is the float64 sum's alone.
* :func:`pair_scores` — the float64 score of given (row, S id) pairs.
* :func:`control` — the reference in the nearest precision below the
  program's float32: the same products in TF32 (on CUDA with TF32
  switched on; on the CPU, which has no TF32, by rounding the inputs to
  TF32's 10-bit mantissa and summing in float32, as TF32 does).  It is
  the control that the comparison has to fail.
* :func:`compare` — the numbers that decide ``correct``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def dense(idx: np.ndarray, val: np.ndarray, dim: int, device, dtype) -> torch.Tensor:
    """(N, dim + 1) dense rows; column ``dim`` takes the padding (its
    values are 0)."""
    idx_t = torch.as_tensor(np.asarray(idx), device=device).long()
    out = torch.zeros((idx_t.shape[0], dim + 1), dtype=dtype, device=device)
    out.scatter_add_(1, idx_t, torch.as_tensor(np.asarray(val), device=device).to(dtype))
    return out


def _row_blocks(n: int, block: int):
    for lo in range(0, n, block):
        yield lo, min(lo + block, n)


def _scan(q, s, k, dim, device, dtype, s_block, q_block):
    """(scores, ids) of the k best S rows for each q row, both host
    arrays, scoring in ``dtype`` (the products' precision is whatever
    the caller's context makes of a ``dtype`` matmul)."""
    q_idx, q_val = q
    s_idx, s_val = s
    n_q, n_s = len(q_idx), len(s_idx)
    out_s = np.empty((n_q, k), np.float64)
    out_i = np.empty((n_q, k), np.int64)
    for q0, q1 in _row_blocks(n_q, q_block):
        qd = dense(q_idx[q0:q1], q_val[q0:q1], dim, device, dtype)[:, :dim]
        best_s = torch.full((q1 - q0, k), float("-inf"), dtype=dtype, device=device)
        best_i = torch.full((q1 - q0, k), -1, dtype=torch.int64, device=device)
        for s0, s1 in _row_blocks(n_s, s_block):
            sd = dense(s_idx[s0:s1], s_val[s0:s1], dim, device, dtype)[:, :dim]
            sc = qd @ sd.T
            ids = torch.arange(s0, s1, device=device).expand(q1 - q0, -1)
            cat_s = torch.cat([best_s, sc], dim=1)
            cat_i = torch.cat([best_i, ids], dim=1)
            best_s, pos = torch.topk(cat_s, k, dim=1)
            best_i = torch.gather(cat_i, 1, pos)
            del sd, sc
        out_s[q0:q1] = best_s.double().cpu().numpy()
        out_i[q0:q1] = best_i.cpu().numpy()
    return out_s, out_i


def topk(q, s, k: int, dim: int, device, s_block: int = 4096, q_block: int = 8192):
    """The float64 reference: (scores (n_q, k) descending, ids (n_q, k))
    of each row of ``q`` = (idx, val) against ``s`` = (idx, val)."""
    return _scan(q, s, k, dim, device, torch.float64, s_block, q_block)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (round to nearest)."""
    bits = x.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _tf32_matmul(device):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def control(q, s, k: int, dim: int, device, s_block: int = 4096, q_block: int = 8192):
    """The reference in TF32: what a program that scored in TF32 would
    answer.  (scores, ids) as :func:`topk` gives them."""
    device = torch.device(device)
    if device.type == "cuda":
        with _tf32_matmul(device):
            return _scan(q, s, k, dim, device, torch.float32, s_block, q_block)
    q_idx, q_val = q
    s_idx, s_val = s
    rq = _tf32(torch.as_tensor(np.asarray(q_val, np.float32))).numpy()
    rs = _tf32(torch.as_tensor(np.asarray(s_val, np.float32))).numpy()
    return _scan((q_idx, rq), (s_idx, rs), k, dim, device, torch.float32, s_block, q_block)


def pair_scores(q, s, ids: np.ndarray, dim: int, device, q_block: int = 8192) -> np.ndarray:
    """float64 score of row i of ``q`` with S row ``ids[i, j]`` (ids
    outside [0, n_s) score NaN)."""
    q_idx, q_val = q
    s_idx, s_val = s
    n_s = len(s_idx)
    ids = np.asarray(ids, np.int64)
    ok = (ids >= 0) & (ids < n_s)
    safe = np.where(ok, ids, 0)
    out = np.empty(ids.shape, np.float64)
    for q0, q1 in _row_blocks(len(q_idx), q_block):
        qd = dense(q_idx[q0:q1], q_val[q0:q1], dim, device, torch.float64)  # (b, dim + 1)
        si = torch.as_tensor(s_idx[safe[q0:q1]], device=device).long()     # (b, k, F)
        sv = torch.as_tensor(s_val[safe[q0:q1]], device=device).double()
        got = torch.gather(qd[:, None, :].expand(-1, si.shape[1], -1), 2, si)
        out[q0:q1] = (got * sv).sum(dim=2).cpu().numpy()
    out[~ok] = np.nan
    return out


def compare(ids: np.ndarray, scores: np.ndarray, ref_scores: np.ndarray,
            id_scores: np.ndarray, n_s: int) -> dict:
    """The numbers that decide ``correct``, for answers ``(ids, scores)``
    of some rows against those rows' float64 top-k scores ``ref_scores``
    and the float64 scores ``id_scores`` of the answered ids:

    * ``score_gap``: the largest |answered score − reference score| at
      the same rank, over the row's best reference score;
    * ``id_gap``: the largest |answered score − the float64 score of the
      answered id|, on the same scale;
    * ``bad_ids``: answered ids outside S, repeated in a row, or missing
      (-1) where the reference has a positive score.

    A rank where the reference score is 0 or less has no true neighbour
    to find (no shared feature), and an empty slot there (score -inf, id
    -1) is as right as any id of score 0.  Scale-free, so a row of large
    scores and a row of small ones weigh alike.
    """
    ids = np.asarray(ids, np.int64)
    got = np.asarray(scores, np.float64)
    ref = np.asarray(ref_scores, np.float64)
    empty = (ids == -1) & ~np.isfinite(got)
    scale = np.maximum(ref[:, :1], np.finfo(np.float64).tiny)
    nothing = ref <= 0.0
    got_eff = np.where(empty & nothing, ref, np.where(np.isfinite(got), got, 0.0))
    score_gap = np.abs(got_eff - ref) / scale

    valid = (ids >= 0) & (ids < n_s)
    srt = np.sort(np.where(valid, ids, -1 - np.arange(ids.shape[1])[None, :]), axis=1)
    repeated = np.zeros(ids.shape, bool)
    repeated[:, 1:] = srt[:, 1:] == srt[:, :-1]
    bad = (~valid & ~(empty & nothing)) | repeated
    idg = np.where(valid & ~bad, np.abs(np.nan_to_num(id_scores) - got_eff), 0.0) / scale
    return {
        "score_gap": float(score_gap.max(initial=0.0)),
        "id_gap": float(idg.max(initial=0.0)),
        "bad_ids": int(bad.sum()),
    }


def judge(q, s, ids, scores, k: int, dim: int, device) -> dict:
    """:func:`compare` of answers for the rows ``q`` = (idx, val) against S
    ``s`` = (idx, val), the reference worked out here."""
    ref_s, _ = topk(q, s, k, dim, device)
    id_s = pair_scores(q, s, ids, dim, device)
    return compare(ids, scores, ref_s, id_s, len(s[0]))
