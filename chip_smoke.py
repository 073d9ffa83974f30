#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the fused score→top-k CUDA kernel from src/repro_torch/kernels/csrc,
then, at the paper's synthetic setting (configs/paper_knn.py "synthetic-10k":
n_r = n_s = 10,000, dim 10,000, mean nnz 120, k = 5, tile 128, r_block =
s_block = 2048):

  phase 1  the kernel against its plain PyTorch version on the card: edge
           cases at small shapes (k = 12, k = 128, ragged S block, masked
           columns, seeded threshold), then one 2048-row R block against the
           full S stack at the engine's own shapes, with timings;
  phase 2  the main path, cached mode: SparseKNNIndex.build + two queries,
           one kernel launch per R block, 256 rows checked against a float64
           top-k computed with scipy.sparse;
  phase 3  the main path, streaming mode: knn_join on 2048 rows, one launch
           per S block, equal to phase 2's rows.

Prints the card's name and power limit, the build time, each phase's
numbers, one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; with
no CUDA device it exits 1 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# fp32 parity is the bar: no TF32 in the plain versions' matmuls or in the
# dense yardstick (PyTorch's cuBLAS default is already off; cuDNN's is on)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N_R = N_S = 10_000
DIM = 10_000
NNZ_MEAN = 120
K = 5
TILE = 128
BLOCK = 2048
RTOL, ATOL = 1e-5, 1e-6


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up (CUDA events)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def peaks(name):
    """(fp32 FLOP/s, bytes/s) published for the card (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    return 67e12, 3.35e12


def phase1_edge_cases(dev):
    from repro_torch.core.topk import init_topk, min_prune_score
    from repro_torch.kernels.knn_score.ops import _pad_rows, active_lists, dense_tiles_with_sentinel
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.kernels.knn_topk.ops import column_meta, pad_state
    from repro_torch.kernels.knn_topk.ref import knn_topk_plain
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.sparse.format import tile_occupancy
    from repro_torch.testing import assert_topk_close

    cases = [  # name, nr, ns, dim, block_r, block_s, k, masked, seeded thr
        ("k8", 64, 64, 256, 64, 64, 8, False, False),
        ("k5-ragged-rows-and-s", 70, 90, 640, 64, 64, 5, False, False),
        ("k12-small-blocks", 48, 100, 512, 16, 32, 12, False, False),
        ("k3-tall-thin", 32, 200, 1024, 32, 64, 3, False, False),
        ("k128-ragged-s", 300, 1100, 512, 256, 256, 128, False, False),
        ("k7-masked-columns", 40, 300, 512, 32, 96, 7, True, False),
        ("k5-seeded-thr", 200, 600, 1024, 104, 256, 5, False, True),
    ]
    worst = 0.0
    for name, nr, ns, dim, br, bs, k, masked, seeded in cases:
        R = synthetic_sparse(nr, dim=dim, nnz_mean=14, nnz_std=4, seed=nr + ns).to(dev)
        S = synthetic_sparse(ns, dim=dim, nnz_mean=14, nnz_std=4, seed=nr * ns).to(dev)
        r_tiles = _pad_rows(dense_tiles_with_sentinel(R, TILE), br)
        s_tiles = _pad_rows(dense_tiles_with_sentinel(S, TILE), bs)
        active = torch.as_tensor(active_lists(
            tile_occupancy(R, TILE).cpu().numpy(), tile_occupancy(S, TILE).cpu().numpy(),
            br, bs), device=dev)
        s_valid = np.random.default_rng(ns).random(ns) > 0.3 if masked else None
        valid, ids = column_meta(ns, s_tiles.shape[1], s_valid=s_valid, device=dev)
        state = init_topk(nr, k, device=dev)
        if seeded:  # a warm state and its MinPruneScore from a first pass
            half = S.rows(0, ns // 2)
            h_tiles = _pad_rows(dense_tiles_with_sentinel(half, TILE), bs)
            h_active = torch.as_tensor(active_lists(
                tile_occupancy(R, TILE).cpu().numpy(), tile_occupancy(half, TILE).cpu().numpy(),
                br, bs), device=dev)
            hv, hi = column_meta(ns // 2, h_tiles.shape[1], device=dev)
            i_s, i_i = pad_state(state, r_tiles.shape[1])
            w_s, w_i, _ = knn_topk_plain(r_tiles, h_tiles, h_active, hv, hi, i_s, i_i,
                                         block_r=br, block_s=bs)
            state = type(state)(w_s[:nr], w_i[:nr])
        init_s, init_i = pad_state(state, r_tiles.shape[1])
        thr = min_prune_score(state).reshape(1, 1)
        nrv = torch.full((1,), nr, dtype=torch.int32, device=dev)
        args = (r_tiles, s_tiles, active, valid, ids, init_s, init_i)
        kw = dict(thr=thr, nr_valid=nrv, block_r=br, block_s=bs)
        got = knn_topk_fused(*args, **kw)
        torch.cuda.synchronize()
        ref = knn_topk_plain(*args, **kw)
        err = assert_topk_close(got[0].cpu(), got[1].cpu(), ref[0].cpu(), ref[1].cpu(), RTOL, ATOL)
        np.testing.assert_allclose(got[2].cpu().numpy(), ref[2].cpu().numpy(), rtol=RTOL, atol=ATOL)
        worst = max(worst, err)
        print(f"phase 1 {name}: NR={r_tiles.shape[1]} NS={s_tiles.shape[1]} k={k} "
              f"max|dscore|={err:.3e} thr_out={got[2].flatten().tolist()[:4]}")
    return worst


def scipy_topk(R, S, rows, k):
    """float64 top-k of the sampled R rows against all of S (scipy.sparse)."""
    import scipy.sparse as sp

    def csr(b):
        idx, val = b.indices.cpu().numpy(), b.values.cpu().numpy()
        keep = idx < b.dim
        r = np.nonzero(keep)[0]
        return sp.csr_matrix((val[keep].astype(np.float64), (r, idx[keep])),
                             shape=(b.num_vectors, b.dim))

    dense = (csr(R)[rows] @ csr(S).T).toarray()
    dense = np.where(dense > 0, dense, -np.inf)
    ids = np.argsort(-dense, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dense, ids, axis=1), ids


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core.blocknl import knn_join
    from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex
    from repro_torch.kernels.knn_topk import kernel as knn_topk_kernel
    from repro_torch.kernels.knn_topk.ref import knn_topk_plain
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.testing import assert_topk_close

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    lib, log = knn_topk_kernel.build()
    print(f"build knn_topk.cu: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, root)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    edge_err = phase1_edge_cases(dev)

    t0 = time.perf_counter()
    S = synthetic_sparse(N_S, dim=DIM, nnz_mean=NNZ_MEAN, seed=1)
    R = synthetic_sparse(N_R, dim=DIM, nnz_mean=NNZ_MEAN, seed=0)
    print(f"data: synthetic-10k R and S generated in {time.perf_counter() - t0:.2f} s")

    # phase 2: the main path, cached mode (counts from 0 just before, read just after)
    spec = JoinSpec(k=K, algorithm="iib", r_block=BLOCK, s_block=BLOCK, tile=TILE,
                    use_kernel=True)
    knn_topk_kernel.knn_topk_fused.launches = 0
    t0 = time.perf_counter()
    index = SparseKNNIndex.build(S, spec)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q1 = index.query(R)
    torch.cuda.synchronize()
    stats = JoinStats()
    t0 = time.perf_counter()
    q2 = index.query(R, stats=stats)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    cached_launches = knn_topk_kernel.knn_topk_fused.launches
    r_blocks = -(-N_R // BLOCK)
    assert cached_launches == 2 * r_blocks, (cached_launches, r_blocks)
    assert stats.device_dispatches == r_blocks, stats
    assert q2.scores.shape == (N_R, K) and bool(torch.isfinite(q2.scores).all())
    assert torch.equal(q1.scores, q2.scores) and torch.equal(q1.ids, q2.ids)
    rows = np.sort(np.random.default_rng(0).choice(N_R, size=256, replace=False))
    o_s, o_i = scipy_topk(R, S, rows, K)
    oracle_err = assert_topk_close(q2.scores.cpu().numpy()[rows], q2.ids.cpu().numpy()[rows],
                                   o_s, o_i, RTOL, ATOL)
    print(f"phase 2 cached: build {build_s:.3f} s, query {query_s:.3f} s, launches "
          f"{cached_launches} for 2 queries x {r_blocks} R blocks, device_dispatches "
          f"{stats.device_dispatches}, tiles_scored {stats.tiles_scored}, 256 rows vs "
          f"float64 scipy max|dscore|={oracle_err:.3e}")

    # phase 1 at the engine's own shapes: one 2048-row R block, all of S
    br = R.rows(0, BLOCK).to(dev)
    args, kwargs, n_active = index.kernel_inputs(br, R.indices[:BLOCK].numpy(), BLOCK)
    fused = knn_topk_kernel.knn_topk_fused
    got = fused(*args, **kwargs)
    ref = knn_topk_plain(*args, **kwargs)
    torch.cuda.synchronize()
    engine_err = assert_topk_close(got[0].cpu(), got[1].cpu(), ref[0].cpu(), ref[1].cpu(),
                                   RTOL, ATOL)
    np.testing.assert_allclose(got[2].cpu().numpy(), ref[2].cpu().numpy(), rtol=RTOL, atol=ATOL)
    kernel_ms = cuda_ms(lambda: fused(*args, **kwargs), reps=3)
    plain_ms = cuda_ms(lambda: knn_topk_plain(*args, **kwargs), reps=2)
    r_dense = torch.zeros((BLOCK, DIM), device=dev)
    r_dense.scatter_add_(1, br.indices.long().clamp(max=DIM - 1),
                         torch.where(br.indices < DIM, br.values, 0.0))
    s_dev = S.to(dev)
    s_dense = torch.zeros((N_S, DIM), device=dev)
    s_dense.scatter_add_(1, s_dev.indices.long().clamp(max=DIM - 1),
                         torch.where(s_dev.indices < DIM, s_dev.values, 0.0))
    library_ms = cuda_ms(lambda: torch.topk(r_dense @ s_dense.T, K, dim=1), reps=3)
    del r_dense, s_dense
    block_r, block_s = kwargs["block_r"], kwargs["block_s"]
    flops = 2.0 * block_r * block_s * TILE * n_active
    out_bytes = sum(t.numel() * t.element_size() for t in got)
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    in_bytes += 4 * 2  # thr and nr_valid
    flop_rate, byte_rate = peaks(name)
    bound_ms = max(flops / flop_rate, (in_bytes + out_bytes) / byte_rate) * 1e3
    bound_by = "operations" if flops / flop_rate >= (in_bytes + out_bytes) / byte_rate else "bytes"
    n_ctas = args[0].shape[1] // block_r
    print(f"phase 1 engine shapes: NR={args[0].shape[1]} NS={args[1].shape[1]} T+1="
          f"{args[0].shape[0]} A={args[2].shape[2]} active entries {n_active} CTAs {n_ctas} "
          f"max|dscore|={engine_err:.3e}")
    print(f"  knn_topk kernel {kernel_ms:.3f} ms/launch, plain {plain_ms:.3f} ms, "
          f"dense matmul+topk {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
          f"{flops:.3e} flop, {in_bytes + out_bytes:.3e} B)")

    # phase 3: the main path, streaming mode
    knn_topk_kernel.knn_topk_fused.launches = 0
    st = JoinStats()
    t0 = time.perf_counter()
    out = knn_join(R.rows(0, BLOCK), S, K, algorithm="iib", r_block=BLOCK, s_block=BLOCK,
                   tile=TILE, use_kernel=True, stats=st)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launches = knn_topk_kernel.knn_topk_fused.launches
    s_blocks = -(-N_S // BLOCK)
    assert stream_launches == s_blocks == st.device_dispatches, (stream_launches, st)
    stream_err = assert_topk_close(out.scores.cpu(), out.ids.cpu(), q2.scores[:BLOCK].cpu(),
                                   q2.ids[:BLOCK].cpu(), RTOL, ATOL)
    print(f"phase 3 streaming: knn_join of {BLOCK} rows in {stream_s:.3f} s, launches "
          f"{stream_launches} for {s_blocks} S blocks, vs cached max|dscore|={stream_err:.3e}")

    print(json.dumps({"kernels": [{
        "name": "knn_topk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/knn_topk.cu",
        "replaces": "src/repro/kernels/knn_topk/kernel.py:63",
        "launches": cached_launches + stream_launches,
        "max_abs_err": max(edge_err, engine_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
