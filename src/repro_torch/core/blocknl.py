"""Block nested-loop KNN join — paper Algorithm 1 as a one-shot wrapper.

``knn_join`` builds a throwaway :class:`SparseKNNIndex` over S in
streaming mode and runs one query.  ``None`` block sizes mean a single
block covering the whole set.  Callers with a query stream against a
fixed S should hold on to the index instead.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex
from repro_torch.core.topk import TopKState
from repro_torch.sparse.format import DEFAULT_TILE, SparseBatch


def knn_join(
    R: SparseBatch,
    S: SparseBatch,
    k: int,
    algorithm: str = "iiib",
    r_block: Optional[int] = None,
    s_block: Optional[int] = None,
    tile: int = DEFAULT_TILE,
    stats: Optional[JoinStats] = None,
    use_kernel: bool = False,
    warm_start: float = 0.0,
    seed: int = 0,
    device=None,
) -> TopKState:
    """R ⋈_KNN S on ``device`` (CUDA unless named).  Returns a TopKState
    over all of R (global S ids).

    ``algorithm`` is the paper's BF, IIB or IIIB; ``use_kernel`` routes
    IIB's scoring through the fused score→top-k kernel.  ``warm_start``
    (IIIB only) first joins each R block against a random
    ``warm_start``-fraction sample of S (drawn with ``seed``), so the
    MinPruneScore is live from the first S block; the sampled rows are
    masked out of their home blocks, so each S row is offered once."""
    if algorithm not in ("bf", "iib", "iiib"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    n_r, n_s = R.num_vectors, S.num_vectors
    spec = JoinSpec(
        k=k,
        algorithm=algorithm,
        r_block=min(r_block or n_r, n_r),
        s_block=min(s_block or n_s, n_s),
        tile=tile,
        use_kernel=use_kernel,
        warm_start=warm_start,
        seed=seed,
    )
    index = SparseKNNIndex.build(S, spec, cache_device_blocks=False, device=device)
    res = index.query(R, stats=stats)
    if stats is not None:
        stats.build_wall_s += index.stats.build_wall_s
    return TopKState(scores=res.scores, ids=res.ids)
