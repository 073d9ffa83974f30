"""KNN-join job launcher (the paper's workload as a service; the PyTorch
counterpart of ``repro.launch.join_job``).

Runs R ⋈_KNN S with the requested algorithm either on one device
(build-once/query-many engine, ``core/engine.py``) or sharded over a
device mesh (``--ring``: ``repro_torch.store.ShardedKNNStore`` over
``make_store_mesh(--data-par)``, one build-once index stack per shard,
fan-out queries with a top-k reduction).  In both modes the S side is
built once and ``--repeat N`` replays the query against it (the serving
shape), reporting per-query wall times plus the ``index_builds`` /
``device_dispatches`` counters (builds stay at the number of S blocks,
dispatches at the number of R blocks, whatever the queries × shards).
It prints one JSON line with the reference's keys.

``--device`` picks the compute device: CUDA unless ``cpu`` is named.  With
``--ring --data-par N`` the mesh is every visible CUDA device (N of them,
or it raises), or N CPU entries with ``--device cpu``.  As in the
reference, the data are generated from ``--seed`` at ``--dim`` with the
generator's default density (``--nnz`` sizes the config only).

  PYTHONPATH=src python -m repro_torch.launch.join_job --nr 2000 --ns 4000 \
      --dim 10000 --k 5 --algorithm iiib --ring --data-par 4 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.paper_knn import JoinConfig
from repro_torch.sparse.datagen import spectra_like, synthetic_sparse


def _spec(cfg: JoinConfig):
    from repro_torch.core.engine import JoinSpec

    return JoinSpec(k=cfg.k, algorithm=cfg.algorithm, r_block=cfg.r_block,
                    s_block=cfg.s_block, tile=cfg.tile)


def build_index(cfg: JoinConfig, S, device=None):
    """Build the reusable S-side index once (engine build phase) on
    ``device`` (CUDA unless named)."""
    from repro_torch.core.engine import SparseKNNIndex

    return SparseKNNIndex.build(S, _spec(cfg), device=device)


def run_host(cfg: JoinConfig, R, S, stats=None, device=None):
    """One-shot join on one device (build + single query)."""
    return build_index(cfg, S, device=device).query(R, stats=stats).state


def build_store(cfg: JoinConfig, S, num_shards: int, device=None):
    """Build the sharded datastore once over ``make_store_mesh(num_shards)``:
    that many CUDA devices, or CPU entries when ``device`` is the CPU."""
    from repro_torch.launch.mesh import make_store_mesh
    from repro_torch.store import ShardedKNNStore

    cpu = device is not None and torch.device(device).type == "cpu"
    mesh = make_store_mesh(num_shards, devices="cpu" if cpu else None)
    return ShardedKNNStore.build(S, _spec(cfg), mesh=mesh)


def dryrun_ring(cfg: JoinConfig, multi_pod: bool = False, mesh=None) -> dict:
    """The ring join's plan on the production mesh (or ``mesh``), from the
    shapes alone: the counterpart of the reference's lower and compile of
    the ring program with no data.

    The port's ring (``core/ring.py``) builds each visiting S shard's index
    on the host from its data at every step, so it cannot be traced on meta
    tensors; what the placement fixes is recorded instead: the ring's size
    and steps, the rows padded to it (``pad_to_ring``), each position's R
    and S shard bytes at ``f = 2 · nnz_mean`` features a row (i32 indices,
    f32 values, an i32 nnz), and the S bytes each ring step sends (every
    position passes its S shard on).  A sparse join's FLOPs depend on the
    data (which tiles are occupied, what IIIB prunes) and are not
    predicted."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    n_ring = mesh.shape["data"] * mesh.shape.get("pod", 1)
    f = cfg.nnz_mean * 2
    nr = -(-cfg.n_r // n_ring) * n_ring
    ns = -(-cfg.n_s // n_ring) * n_ring
    row = 4 * f + 4 * f + 4
    s_shard = ns // n_ring * row
    return {
        "mesh": dict(mesh.shape), "n_ring": n_ring, "nr": nr, "ns": ns, "features": f,
        "r_shard_bytes": nr // n_ring * row, "s_shard_bytes": s_shard,
        "steps": n_ring, "rotations": n_ring - 1,
        "s_bytes_sent_per_step": n_ring * s_shard,
        "s_bytes_sent": (n_ring - 1) * n_ring * s_shard,
    }


def _ready(t: torch.Tensor) -> None:
    """Wait for the device that computes ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nr", type=int, default=2000)
    ap.add_argument("--ns", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=10_000)
    ap.add_argument("--nnz", type=int, default=120)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--algorithm", default="iiib", choices=["bf", "iib", "iiib"])
    ap.add_argument("--spectra", action="store_true", help="MS/MS-like data")
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--r-block", type=int, default=2048)
    ap.add_argument("--s-block", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1,
                    help="query the same built index N times (serving shape)")
    ap.add_argument("--device", default="cuda", help="compute device (cuda unless cpu)")
    args = ap.parse_args(argv)

    cfg = JoinConfig(
        name="cli", n_r=args.nr, n_s=args.ns, dim=args.dim, nnz_mean=args.nnz,
        k=args.k, algorithm=args.algorithm,
        r_block=args.r_block, s_block=args.s_block,
    )
    gen = spectra_like if args.spectra else synthetic_sparse
    R = gen(args.nr, seed=args.seed, dim=args.dim)
    S = gen(args.ns, seed=args.seed + 1, dim=args.dim)

    t0 = time.time()
    summary = {
        "algorithm": args.algorithm, "nr": args.nr, "ns": args.ns, "k": args.k,
    }
    if args.ring:
        # sharded store: build once over the mesh, replay queries
        store = build_store(cfg, S, args.data_par, device=args.device)
        query_s = []
        for _ in range(max(args.repeat, 1)):
            tq = time.time()
            res = store.query(R)
            _ready(res.scores)
            query_s.append(round(time.time() - tq, 3))
        summary.update({
            "wall_s": round(time.time() - t0, 3),
            "build_s": round(store.stats.build_wall_s, 3),
            "query_s": query_s,
            "shards": store.n_shards,
            "shard_rows": store.shard_rows,
            "s_blocks": store.num_blocks,
            "index_builds": store.stats.index_builds,
            "device_dispatches": store.stats.device_dispatches,
            "host_syncs": store.stats.host_syncs,
        })
    else:
        index = build_index(cfg, S, device=args.device)
        query_s = []
        for _ in range(max(args.repeat, 1)):
            tq = time.time()
            res = index.query(R)
            _ready(res.scores)
            query_s.append(round(time.time() - tq, 3))
        summary.update({
            "wall_s": round(time.time() - t0, 3),
            "build_s": round(index.stats.build_wall_s, 3),
            "query_s": query_s,
            "s_blocks": index.num_blocks,
            "index_builds": index.stats.index_builds,
        })
    # the reference's mean: numpy's float32 mean of the top-1 column
    summary["mean_top1"] = float(res.scores[:, 0].cpu().numpy().mean())
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
