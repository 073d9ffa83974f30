"""Public op: streaming top-k merge."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda


def topk_merge(
    state_scores: torch.Tensor,
    state_ids: torch.Tensor,
    cand_scores: torch.Tensor,
    cand_ids: torch.Tensor,
    device=None,
):
    """Merge (N, M) candidates into the running (N, k) state on ``device``
    (CUDA unless named).  Exact top-k; incumbents win ties.  ``cand_ids``
    is (N, M) or (M,) shared by every row.  Returns ((N, k) scores,
    (N, k) ids)."""
    dev = resolve_device(device)

    def put(x, dtype):
        return x.to(device=dev, dtype=dtype).contiguous()

    return topk_merge_cuda(put(state_scores, torch.float32), put(state_ids, torch.int32),
                           put(cand_scores, torch.float32), put(cand_ids, torch.int32))
