"""The paper's contribution: KNN join for high-dimensional sparse data.

Public API (build-once/query-many engine):
  JoinSpec            — frozen join configuration (k, algorithm, geometry)
  plan / JoinPlan     — C2/C3 cost-model planner resolving open spec fields
  SparseKNNIndex      — build(S, spec) once, query(R) many; extend(S_new)
  JoinResult          — (scores, ids, stats) of one query
  JoinStats           — work counters incl. index_builds / wall times

Compat wrappers (one-shot batch joins, identical results):
  knn_join            — block nested-loop join (bf | iib | iiib), host-driven
  distributed_join    — the multi-device join over a device mesh (backed by
                        the sharded datastore, repro_torch.store; the ring
                        driver in core/ring.py remains for dim_axis)

Support:
  TopKState           — streaming top-k candidate state
  (reference_join, the literal paper algorithms in numpy, is in
  core/reference.py; SparseBatch in repro_torch.sparse)

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from repro_torch.core.blocknl import knn_join
from repro_torch.core.engine import (
    JoinPlan,
    JoinResult,
    JoinSpec,
    JoinStats,
    SparseKNNIndex,
    distributed_join,
    plan,
)
from repro_torch.core.topk import (
    TopKState,
    init_topk,
    min_prune_score,
    prune_scores,
    topk_update,
)

__all__ = [
    "JoinPlan",
    "JoinResult",
    "JoinSpec",
    "JoinStats",
    "SparseKNNIndex",
    "TopKState",
    "distributed_join",
    "init_topk",
    "knn_join",
    "min_prune_score",
    "plan",
    "prune_scores",
    "topk_update",
]
