"""Plain PyTorch version of the streaming top-k merge: concatenate, stable
descending sort, keep k.

Bit-identical to M insertion passes (``kernel.insert_candidates``): the
stable sort puts the incumbents first among equal scores, and earlier
candidates before later ones, just as pos = #{state >= cand} does.
"""
from __future__ import annotations

import torch


def topk_merge_plain(state_scores, state_ids, cand_scores, cand_ids):
    """((N, k) scores, (N, k) ids) of (N, k) state ⊕ (N, M) candidates;
    ``cand_ids`` is (N, M) or (M,) shared by every row."""
    n, m = cand_scores.shape
    if cand_ids.dim() == 1:
        cand_ids = cand_ids[None, :].expand(n, m)
    all_scores = torch.cat([state_scores, cand_scores.float()], dim=1)
    all_ids = torch.cat([state_ids, cand_ids.to(torch.int32)], dim=1)
    top_scores, pos = torch.sort(all_scores, dim=1, descending=True, stable=True)
    k = state_scores.shape[1]
    return top_scores[:, :k].contiguous(), torch.gather(all_ids, 1, pos[:, :k])
