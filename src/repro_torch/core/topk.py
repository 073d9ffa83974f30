"""Streaming top-k state for the KNN join (PyTorch).

Per outer vector r: the k best scores so far, descending, and their global
S ids.  ``prune_scores`` is column k-1 (the paper's pruneScore: -inf until
k candidates have been seen) and ``min_prune_score`` its min over a block
(IIIB's MinPruneScore).

Tie order is part of the contract: the earliest-offered candidate wins.
``topk_update`` therefore merges with a *stable* descending sort of
``[state, candidates]`` and keeps the first k — ``torch.topk`` promises no
order among equal scores.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class TopKState:
    scores: torch.Tensor  # (N, k) f32, descending; -inf for empty slots
    ids: torch.Tensor     # (N, k) int32, global S indices; -1 for empty slots

    @property
    def k(self) -> int:
        return self.scores.shape[1]


def init_topk(num_vectors: int, k: int, device="cpu") -> TopKState:
    return TopKState(
        scores=torch.full((num_vectors, k), NEG_INF, dtype=torch.float32, device=device),
        ids=torch.full((num_vectors, k), -1, dtype=torch.int32, device=device),
    )


def topk_update(state: TopKState, new_scores: torch.Tensor, new_ids: torch.Tensor) -> TopKState:
    """Merge an (N, M) block of candidate scores into the running top-k.

    ``new_ids`` is (M,) (shared columns) or (N, M).  Invalid candidates
    must carry score -inf.
    """
    n, m = new_scores.shape
    if new_ids.dim() == 1:
        new_ids = new_ids[None, :].expand(n, m)
    all_scores = torch.cat([state.scores, new_scores.float()], dim=1)
    all_ids = torch.cat([state.ids, new_ids.to(torch.int32)], dim=1)
    top_scores, pos = torch.sort(all_scores, dim=1, descending=True, stable=True)
    k = state.k
    return TopKState(
        scores=top_scores[:, :k].contiguous(),
        ids=torch.gather(all_ids, 1, pos[:, :k]),
    )


def pad_topk_state(state: TopKState, n_pad: int) -> TopKState:
    """Pad to ``n_pad`` rows with empty (-inf, -1) slots (kernel block plumbing)."""
    n, k = state.scores.shape
    dev = state.scores.device
    scores = torch.full((n_pad, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.full((n_pad, k), -1, dtype=torch.int32, device=dev)
    scores[:n] = state.scores
    ids[:n] = state.ids
    return TopKState(scores=scores, ids=ids)


def prune_scores(state: TopKState) -> torch.Tensor:
    """(N,) — pruneScore(r): the k-th best score so far (-inf if < k seen)."""
    return state.scores[:, -1]


def min_prune_score(state: TopKState, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar MinPruneScore = min over the block's rows of pruneScore(r).

    ``valid`` masks padding rows out of the min: a padded row's prune score
    stays -inf forever and would pin the threshold at -inf.
    """
    ps = prune_scores(state)
    if valid is not None:
        ps = torch.where(valid, ps, float("inf"))
    return torch.min(ps)
