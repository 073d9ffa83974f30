"""Plain PyTorch version of the fused score→top-k kernel.

Same signature and outputs as the CUDA kernel (kernels/knn_topk/kernel.py).
For each R block it walks the S blocks in order; per block it sums
R_tile · S_tileᵀ over the pair's active tiles (as the JAX package's
``knn_score_ref`` does), masks the candidates (score > 0, ``s_valid``,
score > the block's frozen threshold) and merges with the stable-sort
``topk_update``.  The threshold update stays on the device
(``torch.where``), so the loop makes no host sync per block.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import TopKState, topk_update

NEG_INF = float("-inf")


def knn_topk_plain(
    r_tiles: torch.Tensor,    # (T+1, NR, tile) f32 — sentinel tile last, all zeros
    s_tiles: torch.Tensor,    # (T+1, NS, tile) f32
    active: torch.Tensor,     # (nR, nS, A) int32
    s_valid: torch.Tensor,    # (1, NS) int32
    s_ids: torch.Tensor,      # (1, NS) int32
    init_scores: torch.Tensor,  # (NR, k) f32
    init_ids: torch.Tensor,     # (NR, k) int32
    thr: torch.Tensor | None = None,       # (1, 1) f32 seed MinPruneScore
    nr_valid: torch.Tensor | None = None,  # (1,) int32 real R rows
    block_r: int = 256,
    block_s: int = 256,
):
    """((NR, k) scores, (NR, k) ids, (nR, 1) MinPruneScore per R block)."""
    dev = r_tiles.device
    n_r, n_s = r_tiles.shape[1], s_tiles.shape[1]
    valid = s_valid[0] > 0
    thr0 = (thr.reshape(()) if thr is not None
            else torch.tensor(NEG_INF, dtype=torch.float32, device=dev))
    nrv = nr_valid.reshape(()) if nr_valid is not None else n_r
    act = active.long()
    out_s, out_i, thr_out = [], [], []
    for bi, i0 in enumerate(range(0, n_r, block_r)):
        st = TopKState(init_scores[i0 : i0 + block_r], init_ids[i0 : i0 + block_r])
        th = thr0
        row_ok = (i0 + torch.arange(block_r, device=dev)) < nrv
        rt_all = r_tiles[:, i0 : i0 + block_r]
        for bj, j0 in enumerate(range(0, n_s, block_s)):
            tiles = act[bi, bj]
            rt = rt_all[tiles]                               # (A, block_r, tile)
            sblk = s_tiles[tiles, j0 : j0 + block_s]         # (A, block_s, tile)
            chunk = torch.bmm(rt, sblk.transpose(1, 2)).sum(dim=0)
            ok = (chunk > 0.0) & valid[None, j0 : j0 + block_s] & (chunk > th)
            st = topk_update(st, torch.where(ok, chunk, NEG_INF), s_ids[0, j0 : j0 + block_s])
            kth = torch.where(row_ok, st.scores[:, -1], float("inf")).min()
            th = torch.where(ok.any(), kth, th)
        out_s.append(st.scores)
        out_i.append(st.ids)
        thr_out.append(th.reshape(1))
    return torch.cat(out_s), torch.cat(out_i), torch.stack(thr_out)
