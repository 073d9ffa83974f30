"""Quickstart on the PyTorch port: build the sparse KNN index once, query
it many times (the twin of examples/quickstart.py, through
``repro_torch.core``).

The engine (repro_torch.core.engine) separates the paper's join into a
build phase — S is padded into blocks and each block's tile-inverted
index is constructed ONCE — and a query phase that streams any number of
R batches against the cached structures.  ``knn_join`` remains as a
one-shot wrapper over the same engine.  Runs on CUDA unless ``--device
cpu`` is given.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import JoinSpec, JoinStats, SparseKNNIndex
from repro_torch.core.reference import oracle_knn
from repro_torch.sparse import densify, synthetic_sparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="compute device (cuda unless cpu)")
    args = ap.parse_args()

    # 1. a datastore S and two query batches (D = 10,000; ~120 non-zeros
    #    each, the paper's synthetic setting)
    S = synthetic_sparse(4_000, dim=10_000, nnz_mean=120, seed=1)
    R1 = synthetic_sparse(1_000, dim=10_000, nnz_mean=120, seed=0)
    R2 = synthetic_sparse(1_000, dim=10_000, nnz_mean=120, seed=2)

    # 2. build once: every S block's inverted index is constructed here
    spec = JoinSpec(k=5, algorithm="iib", r_block=512, s_block=1024)
    index = SparseKNNIndex.build(S, spec, device=args.device)
    print(f"built {index.num_blocks} S-block indexes on {index.device} in "
          f"{index.stats.build_wall_s:.2f}s ({index.stats.index_builds} builds)")

    # 3. query many: each call reuses the cached indexes (zero builds)
    stats = JoinStats()
    res1 = index.query(R1, stats=stats)
    index.query(R2)
    scores, ids = res1.scores.cpu().numpy(), res1.ids.cpu().numpy()
    print("top-5 neighbour ids of r1_0:", ids[0])
    print("top-5 scores of r1_0:      ", scores[0])
    print(f"work per query: {stats.tiles_scored} tile-matmuls, "
          f"{stats.list_entries} list entries, {stats.index_builds} index builds")
    assert index.stats.index_builds == index.num_blocks  # not queries x blocks

    # 4. verify against the dense oracle
    osc, _ = oracle_knn(densify(R1).numpy(), densify(S).numpy(), 5)
    pos = osc > 0
    ok = np.allclose(np.where(pos, scores, 0), np.where(pos, osc, 0), atol=1e-4)
    print("matches dense oracle:", ok)
    assert ok


if __name__ == "__main__":
    main()
