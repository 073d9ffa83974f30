#!/usr/bin/env python3
"""Time the fused-kernel IIB path of the repro_torch package found under
a given source directory, on one CUDA card, at synthetic-10k (blocks of
2048): three cached builds, five cached queries of all 10,000 rows and
five streaming knn_joins of 2048 rows (chip_smoke.py's phases 2 and 3).

    python3 tools/time_fused_path.py SRC_DIR

To compare two trees, unpack one with ``git archive`` into a gitignored
directory and run both in one call, in turns (old, new, new, old).
"""
import sys
import time

import numpy as np
import torch


def timed(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main(src: str) -> None:
    sys.path.insert(0, src)
    from repro_torch.core.blocknl import knn_join
    from repro_torch.core.engine import JoinSpec, SparseKNNIndex
    from repro_torch.sparse.datagen import synthetic_sparse

    S = synthetic_sparse(10_000, seed=1)
    R = synthetic_sparse(10_000, seed=0)
    spec = JoinSpec(k=5, algorithm="iib", r_block=2048, s_block=2048, use_kernel=True)
    index = SparseKNNIndex.build(S, spec)
    index.query(R)                       # builds and loads the kernels
    build = timed(lambda: SparseKNNIndex.build(S, spec), 3)
    query = timed(lambda: index.query(R), 5)
    join = timed(lambda: knn_join(R.rows(0, 2048), S, 5, algorithm="iib", r_block=2048,
                                  s_block=2048, use_kernel=True), 5)
    print(src, "build", np.round(build, 4).tolist(), "query", np.round(query, 4).tolist(),
          "median", round(float(np.median(query)), 4), "knn_join", np.round(join, 4).tolist(),
          "median", round(float(np.median(join)), 4))


if __name__ == "__main__":
    main(sys.argv[1])
