#!/usr/bin/env python3
"""Run chip_smoke.py's phase 13 (b) and (c) over distinct CUDA cards, and
time the store and the ring over distinct cards against the same mesh on
one card, in turns.

    python3 tools/time_mesh_join.py

Needs two or more cards (exits 1 with fewer).  At synthetic-10k (R = S =
10,000 rows, dim 10,000, k 5, blocks of 2,048): the references phase 13
holds its runs to (one SparseKNNIndex a driver, the num_shards=4 store a
driver, a BF store of spectra S 20,480 rows standing in for phase 11's
yeast-worm store), then ``phase13_store`` and ``phase13_ring`` over
``[cuda:0, cuda:1, ...]`` (bit for bit, and within tolerance of one
index).  Then each of: the 4-shard IIB store query, and the ring driver
for BF, IIB and IIIB on 4 positions, over one card repeated and over the
distinct cards, in turns (one, many, many, one) REPS times, each a host
clock around work that ends in every card's synchronize.
"""
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 3


def cards():
    """The distinct cards, and cuda:0 as many times."""
    n = torch.cuda.device_count()
    many = [torch.device("cuda", i % n) for i in range(8)]
    return many, [torch.device("cuda", 0)] * 8


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def in_turns(fns, reps):
    """{name: [seconds]} of each fn, in the order one, many, many, one."""
    out = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(reps):
        for name in order:
            sync_all()
            t0 = time.perf_counter()
            fns[name]()
            sync_all()
            out[name].append(time.perf_counter() - t0)
    return out


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("time_mesh_join: needs two or more CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import subprocess

    import chip_smoke as cs
    from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex
    from repro_torch.core.ring import _ring_join_impl
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.launch.mesh import make_host_mesh, make_store_mesh
    from repro_torch.sparse.datagen import spectra_like, synthetic_sparse
    from repro_torch.store import ShardedKNNStore

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    many, one = cards()
    first = one[0]

    def reset_counts():
        topk_merge_cuda.launches = 0

    S = synthetic_sparse(cs.N_S, dim=cs.DIM, nnz_mean=cs.NNZ_MEAN, seed=1)
    R = synthetic_sparse(cs.N_R, dim=cs.DIM, nnz_mean=cs.NNZ_MEAN, seed=0)
    singles, store_queries = {}, {}
    for alg in cs.DRIVERS:
        spec = JoinSpec(k=cs.K, algorithm=alg, r_block=cs.BLOCK, s_block=cs.BLOCK, tile=cs.TILE)
        singles[alg] = SparseKNNIndex.build(S, spec, device=first).query(R)
        store = ShardedKNNStore.build(S, spec, num_shards=cs.RING, device=first)
        built = cs.store_counts(store)
        stats = JoinStats()
        store_queries[alg] = (store.query(R, stats=stats), stats, built)
        del store
    n_r, n_s, dim, peaks_mean = cs.SPECTRA
    yR = spectra_like(n_r, dim=dim, peaks_mean=peaks_mean, seed=0)
    yS = spectra_like(n_s, dim=dim, peaks_mean=peaks_mean, seed=1)
    bf = JoinSpec(k=cs.K, algorithm="bf", r_block=cs.BLOCK, s_block=cs.BLOCK, tile=cs.TILE)
    yeast = (ShardedKNNStore.build(yS, bf, num_shards=cs.RING, device=first), yR)

    def label(devs):
        return "[" + ", ".join(str(d) for d in devs) + "]"

    t0 = time.perf_counter()
    n = cs.phase13_store(smi, label(many[:cs.RING]), many[:cs.RING], R, S, store_queries, yeast,
                         reset_counts)
    n += cs.phase13_ring(smi, label(many), many, R, S, singles, reset_counts)
    print(f"phase 13 (b), (c) over distinct cards: {time.perf_counter() - t0:.1f} s, "
          f"topk_merge launches {n}")

    spec = JoinSpec(k=cs.K, algorithm="iib", r_block=cs.BLOCK, s_block=cs.BLOCK, tile=cs.TILE)
    stores = {name: ShardedKNNStore.build(S, spec, mesh=make_store_mesh(cs.RING, devices=devs))
              for name, devs in (("one", one[:cs.RING]), ("many", many[:cs.RING]))}
    rows = [("store iib", {name: (lambda st=st: st.query(R)) for name, st in stores.items()})]
    meshes = {name: make_host_mesh(cs.RING, 1, devices=devs[:cs.RING])
              for name, devs in (("one", one), ("many", many))}
    for alg in cs.DRIVERS:
        rows.append((f"ring {alg}", {
            name: (lambda m=m, alg=alg: _ring_join_impl(R, S, cs.K, m, algorithm=alg))
            for name, m in meshes.items()}))
    for what, fns in rows:
        a, b = (fns[name]() for name in ("one", "many"))
        same = torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)
        times = in_turns(fns, REPS)
        med = {name: float(np.median(t)) for name, t in times.items()}
        print(f"{what} on {smi}: [{first}] x {cs.RING} "
              f"{'; '.join(f'{t:.4f}' for t in times['one'])} s (median {med['one']:.4f}), "
              f"{label(many[:cs.RING])} {'; '.join(f'{t:.4f}' for t in times['many'])} s (median "
              f"{med['many']:.4f}), {med['one'] / med['many']:.2f}x; the two bit for bit {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
