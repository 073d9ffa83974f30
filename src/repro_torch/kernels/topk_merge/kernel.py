"""Plain version of the top-k insertion merge (the paper's candidate-set
insert), the body of the fused knn_topk kernel's epilogue.

M insertion passes of (N, M) candidates into an (N, k) descending state:

  pos       = #{j : state[j] >= cand}     (incumbents win ties)
  state'[j] = state[j]    j < pos
            = cand        j == pos
            = state[j-1]  j > pos

The CUDA kernel (kernels/csrc/knn_topk.cu) runs this per row in a warp;
the tests hold this version bit for bit against the JAX package's.
"""
from __future__ import annotations

import torch


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
