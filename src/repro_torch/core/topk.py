"""Streaming top-k state for the KNN join (PyTorch).

Per outer vector r: the k best scores so far, descending, and their global
S ids.  ``prune_scores`` is column k-1 (the paper's pruneScore: -inf until
k candidates have been seen) and ``min_prune_score`` its min over a block
(IIIB's MinPruneScore).

Tie order is part of the contract: the earliest-offered candidate wins.
``topk_update`` therefore merges with a *stable* descending sort of
``[state, candidates]`` and keeps the first k — ``torch.topk`` promises no
order among equal scores.  ``merge_step`` (the join drivers' block step) and
``merge_topk_states`` merge with the same tie order, through the
topk_merge kernel on CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
from repro_torch.kernels.topk_merge.ref import topk_merge_plain

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class TopKState:
    scores: torch.Tensor  # (N, k) f32, descending; -inf for empty slots
    ids: torch.Tensor     # (N, k) int32, global S indices; -1 for empty slots

    @property
    def k(self) -> int:
        return self.scores.shape[1]


def init_topk(num_vectors: int, k: int, device=None) -> TopKState:
    """An empty (-inf, -1) state on ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    return TopKState(
        scores=torch.full((num_vectors, k), NEG_INF, dtype=torch.float32, device=device),
        ids=torch.full((num_vectors, k), -1, dtype=torch.int32, device=device),
    )


def topk_update(state: TopKState, new_scores: torch.Tensor, new_ids: torch.Tensor) -> TopKState:
    """Merge an (N, M) block of candidate scores into the running top-k.

    ``new_ids`` is (M,) (shared columns) or (N, M).  Invalid candidates
    must carry score -inf.
    """
    return TopKState(*topk_merge_plain(state.scores, state.ids, new_scores, new_ids))


def merge_step(state: TopKState, new_scores: torch.Tensor, new_ids: torch.Tensor) -> TopKState:
    """A join driver's block step: ``topk_update``'s merge (incumbents and
    earlier candidates win ties) through ``topk_merge_cuda``, the kernel on
    CUDA states and its plain version on CPU states.  ``new_ids`` is (M,)
    (shared columns) or (N, M)."""
    return TopKState(*topk_merge_cuda(state.scores, state.ids, new_scores, new_ids))


def merge_topk_states(a: TopKState, b: TopKState) -> TopKState:
    """Merge two per-row top-k states; ties favour ``a`` (the lower shard).

    ``b``'s k entries are inserted into ``a`` in order, as the topk_merge
    insertion body does, through ``topk_merge_cuda`` (M = k): the kernel on
    CUDA states, its plain version on CPU states.  Bit-identical to the JAX
    package's ``merge_topk_states``.
    """
    return TopKState(*topk_merge_cuda(a.scores, a.ids, b.scores, b.ids))


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
