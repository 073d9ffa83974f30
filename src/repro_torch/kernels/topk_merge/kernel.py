"""Streaming top-k merge (the paper's candidate-set insert): the plain
insertion body and the CUDA kernel's wrapper.

M insertion passes of (N, M) candidates into an (N, k) descending state:

  pos       = #{j : state[j] >= cand}     (incumbents win ties)
  state'[j] = state[j]    j < pos
            = cand        j == pos
            = state[j-1]  j > pos

``insert_candidates`` is the plain form of that body, bit for bit the JAX
package's; tests hold the kernel and ``ref.topk_merge_plain`` against it.
``topk_merge_cuda`` launches the hand-written kernels of
``../csrc/topk_merge.cu`` on CUDA tensors, and runs
``ref.topk_merge_plain`` on CPU tensors.  For k <= 128: one warp a row
when M < ``SPLIT_MIN_M`` (the body of ``../csrc/topk_insert.cuh``, shared
with the fused knn_topk kernel), else one CTA of eight warps a row, each
warp walking an eighth of the row in column order and the eight partial
states merged in that order (``split_merge_model`` is its plain model).
For any larger k one CTA a row that writes each entry to its rank in the
stable sort.  Nothing falls back: a CUDA tensor that the kernels
cannot take raises.  ``topk_merge_cuda.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, launch
from repro_torch.kernels.topk_merge.ref import topk_merge_plain

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4
SPLIT_MIN_M = 512   # csrc/topk_merge.cu kSplitMinM


def insert_candidates(state_scores, state_ids, cand_scores, cand_ids):
    """(rows, k) state ⊕ (rows, M) candidates via M insertion passes."""
    k = state_scores.shape[1]
    lane = torch.arange(k, device=state_scores.device)[None, :]
    scores, ids = state_scores, state_ids
    for j in range(cand_scores.shape[1]):
        cand = cand_scores[:, j : j + 1]
        cid = cand_ids[:, j : j + 1]
        pos = (scores >= cand).sum(dim=1, keepdim=True)
        sh_s = torch.roll(scores, 1, dims=1)
        sh_i = torch.roll(ids, 1, dims=1)
        scores = torch.where(lane < pos, scores, torch.where(lane == pos, cand, sh_s))
        ids = torch.where(lane < pos, ids, torch.where(lane == pos, cid, sh_i))
    return scores, ids


def topk_merge_cuda(
    state_scores: torch.Tensor,  # (N, k) f32, descending; -inf for empty slots
    state_ids: torch.Tensor,     # (N, k) int32; -1 for empty slots
    cand_scores: torch.Tensor,   # (N, M) f32; -inf for no candidate
    cand_ids: torch.Tensor,      # (N, M) int32, or (M,) shared by every row
):
    """((N, k) scores, (N, k) ids): the state with the candidates merged in."""
    if state_scores.device.type == "cpu":
        return topk_merge_plain(state_scores, state_ids, cand_scores, cand_ids)
    if state_scores.device.type != "cuda":
        raise ValueError(f"topk_merge_cuda runs on cuda or cpu tensors, got {state_scores.device}")
    dev = state_scores.device
    if state_scores.dim() != 2 or cand_scores.dim() != 2:
        raise ValueError("state_scores and cand_scores must be 2-d")
    n, k = state_scores.shape
    m = cand_scores.shape[1]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    check("state_scores", state_scores, torch.float32, (n, k), dev)
    check("state_ids", state_ids, torch.int32, (n, k), dev)
    check("cand_scores", cand_scores, torch.float32, (n, m), dev)
    shared = cand_ids.dim() == 1
    check("cand_ids", cand_ids, torch.int32, (m,) if shared else (n, m), dev)

    out_s = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return out_s, out_i
    # the second state buffer of the large-k kernel (k > 128), which uses it
    # when the state is too large for shared memory
    scratch_s = torch.empty_like(out_s) if k > 128 else out_s
    scratch_i = torch.empty_like(out_i) if k > 128 else out_i
    launch("topk_merge", _ARGTYPES, dev,
           state_scores.data_ptr(), state_ids.data_ptr(), cand_scores.data_ptr(),
           cand_ids.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), scratch_s.data_ptr(),
           scratch_i.data_ptr(), n, k, m, 0 if shared else m)
    topk_merge_cuda.launches += 1
    return out_s, out_i


topk_merge_cuda.launches = 0
