"""Brute-force (BF) KNN join — the paper's Algorithm 2 (the PyTorch
counterpart of ``repro.core.bf``).

"Score every pair" is a dense blocked product: each dim chunk of the R
block multiplies the same chunk of the S block and the partial scores
accumulate in fp32, chunk by chunk.  It touches every dimension whether
or not it holds mass, exactly as BF touches every feature.  Each block
step merges its scores into the running top-k through the topk_merge
kernel (``topk_merge_cuda``: the kernel on CUDA tensors, its plain
version on CPU tensors), ``core/topk.py::merge_step``.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch

from repro_torch.core.topk import NEG_INF, TopKState, merge_step
from repro_torch.sparse.format import SparseBatch, densify_tile


def dense_chunks(batch: SparseBatch, dim_chunk: int = 2048) -> List[torch.Tensor]:
    """The (N, dim_chunk) dense views of a batch, one per dim chunk."""
    return [densify_tile(batch, start, dim_chunk) for start in range(0, batch.dim, dim_chunk)]


def chunk_scores(r_chunks: List[torch.Tensor], s_chunks: List[torch.Tensor]) -> torch.Tensor:
    """(|Br|, |Bs|) sum over dim chunks, in chunk order, of R_c @ S_cᵀ."""
    acc = torch.zeros((r_chunks[0].shape[0], s_chunks[0].shape[0]), dtype=torch.float32,
                      device=r_chunks[0].device)
    for rc, sc in zip(r_chunks, s_chunks):
        acc += rc @ sc.T
    return acc


def bf_block_scores(r_block: SparseBatch, s_block: SparseBatch,
                    dim_chunk: int = 2048) -> torch.Tensor:
    """(|Br|, |Bs|) dot-product scores via chunked dense products."""
    if r_block.dim != s_block.dim:
        raise ValueError(f"dim mismatch: {r_block.dim} vs {s_block.dim}")
    return chunk_scores(dense_chunks(r_block, dim_chunk), dense_chunks(s_block, dim_chunk))


def block_ids(s_offset: Union[int, torch.Tensor], num_s: int, device=None) -> torch.Tensor:
    """(num_s,) int32 global ids of a block's columns: ``s_offset`` is the
    global id of the block's first row, or an explicit (num_s,) id array."""
    if isinstance(s_offset, torch.Tensor) and s_offset.dim() == 1:
        return s_offset.to(torch.int32)
    dev = s_offset.device if isinstance(s_offset, torch.Tensor) else device
    return (s_offset + torch.arange(num_s, dtype=torch.int32, device=dev)).to(torch.int32)


def _bf_merge(state, scores, s_offset, s_valid, num_s):
    ids = block_ids(s_offset, num_s, device=scores.device)
    if s_valid is not None:
        scores = torch.where(s_valid[None, :], scores, NEG_INF)
    return merge_step(state, scores, ids)


def bf_join_block(
    state: TopKState,
    r_block: SparseBatch,
    s_block: SparseBatch,
    s_offset: Union[int, torch.Tensor],
    s_valid: Optional[torch.Tensor] = None,
    dim_chunk: int = 2048,
) -> TopKState:
    """One (B_r, B_s) BF join step: score everything, merge into the top-k.
    ``s_valid`` masks padding rows of a partial final block."""
    scores = bf_block_scores(r_block, s_block, dim_chunk=dim_chunk)
    return _bf_merge(state, scores, s_offset, s_valid, s_block.num_vectors)


def bf_scan_join(state, r_block, s_idx, s_val, s_nnz, s_ids, s_valid, dim, dim_chunk=2048):
    """BF over ALL stacked S blocks (``(B, s_block, …)`` tensors), in S
    order: the counterpart of the reference's ``lax.scan``.  The R block's
    dense chunks are made once and reused by every S block (the same
    values, so the same scores as ``bf_join_block``)."""
    r_chunks = dense_chunks(r_block, dim_chunk)
    for b in range(s_idx.shape[0]):
        blk = SparseBatch(indices=s_idx[b], values=s_val[b], nnz=s_nnz[b], dim=dim)
        scores = chunk_scores(r_chunks, dense_chunks(blk, dim_chunk))
        state = _bf_merge(state, scores, s_ids[b], s_valid[b], blk.num_vectors)
    return state
