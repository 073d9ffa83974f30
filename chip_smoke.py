#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the three CUDA kernels of src/repro_torch/kernels/csrc (knn_topk,
knn_score, topk_merge; one nvcc each, in parallel), then, at the paper's
synthetic setting (configs/paper_knn.py "synthetic-10k":
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
           per S block, equal to phase 2's rows;
  phase 4  knn_score and topk_merge against their plain versions on the
           card: edge cases (block sizes 16 to 256, tile 256, ragged S; k
           from 1 to 128, ragged M, ties, -inf, shared ids), then the
           engine's shapes, with timings;
  phase 5  the unfused path at full width: per R block knn_score against
           all of S, the > 0 mask, topk_merge into a fresh state; equal to
           phase 2's query and to the float64 rows;
  phase 6  merge_topk_states: S split at row 5,000, both halves queried
           through a cached index each and merged; equal to phase 2's
           query, and the kernel's merge equal to the plain body.

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


def bound(flops, nbytes, name):
    """(least ms, "operations" or "bytes"): the larger of the two times."""
    flop_rate, byte_rate = peaks(name)
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(got, want):
    """max |got - want| over the finite entries of ``want`` (0 if none)."""
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0


def phase4_score_cases(dev):
    """knn_score_cuda against knn_score_plain at small shapes; the max |Δ|."""
    from repro_torch.kernels.knn_score.kernel import knn_score_cuda
    from repro_torch.kernels.knn_score.ops import _pad_rows, active_lists, dense_tiles_with_sentinel
    from repro_torch.kernels.knn_score.ref import knn_score_plain
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.sparse.format import tile_occupancy

    cases = [  # nr, ns, dim, tile, block_r, block_s: tests/test_kernels.py's five, then more
        (64, 64, 256, 128, 64, 64),
        (70, 90, 640, 128, 64, 64),
        (128, 64, 384, 128, 128, 32),
        (32, 32, 512, 256, 32, 32),
        (16, 200, 1024, 128, 16, 64),
        (200, 300, 1024, 128, 104, 24),     # block 104 and 24
        (300, 1100, 2048, 128, 256, 256),   # ragged S
    ]
    worst = 0.0
    for nr, ns, dim, tile, br, bs in cases:
        R = synthetic_sparse(nr, dim=dim, nnz_mean=15, nnz_std=4, seed=nr + ns).to(dev)
        S = synthetic_sparse(ns, dim=dim, nnz_mean=15, nnz_std=4, seed=nr * ns).to(dev)
        r_tiles = _pad_rows(dense_tiles_with_sentinel(R, tile), br)
        s_tiles = _pad_rows(dense_tiles_with_sentinel(S, tile), bs)
        active = torch.as_tensor(active_lists(
            tile_occupancy(R, tile).cpu().numpy(), tile_occupancy(S, tile).cpu().numpy(),
            br, bs), device=dev)
        got = knn_score_cuda(r_tiles, s_tiles, active, block_r=br, block_s=bs)
        torch.cuda.synchronize()
        want = knn_score_plain(r_tiles, s_tiles, active, block_r=br, block_s=bs)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        print(f"phase 4 knn_score nr={nr} ns={ns} tile={tile} blocks={br}x{bs}: "
              f"NR={r_tiles.shape[1]} NS={s_tiles.shape[1]} max|dscore|={err:.3e}")
    return worst


def merge_inputs(dev, seed, n, k, m, shared_ids, kind):
    """A descending (n, k) state with empty slots and (n, m) candidates:
    "mixed" (tied levels, -inf among them, and distinct scores), "ties"
    (every candidate 0.5, as some incumbents are) or "neginf" (half -inf)."""
    g = torch.Generator().manual_seed(seed)
    levels = torch.tensor([float("-inf"), 0.25, 0.5, 1.0])
    ss = levels[torch.randint(0, 4, (n, k), generator=g)].sort(dim=1, descending=True).values
    si = torch.where(torch.isfinite(ss), torch.randint(0, 1000, (n, k), generator=g), -1)
    cs = torch.where(torch.rand((n, m), generator=g) < 0.5,
                     levels[torch.randint(0, 4, (n, m), generator=g)],
                     torch.rand((n, m), generator=g))
    if kind == "ties":
        cs = torch.full((n, m), 0.5)
    elif kind == "neginf":
        cs = torch.where(torch.rand((n, m), generator=g) < 0.5, float("-inf"), cs)
    ci = torch.arange(m) if shared_ids else torch.randint(0, 10**6, (n, m), generator=g)
    return (ss.to(dev), si.to(dev, torch.int32), cs.to(dev), ci.to(dev, torch.int32))


def phase4_merge_cases(dev):
    """topk_merge_cuda against topk_merge_plain, bit for bit."""
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import topk_merge_plain

    cases = [  # n, k, m, shared ids, kind
        (64, 1, 64, False, "mixed"),
        (100, 5, 300, True, "mixed"),      # M not a multiple of 32, shared (M,) ids
        (33, 8, 64, False, "ties"),
        (256, 16, 50, False, "neginf"),
        (40, 128, 200, True, "mixed"),
        (2048, 5, 10_240, True, "mixed"),  # the unfused path's shapes
    ]
    for n, k, m, shared, kind in cases:
        args = merge_inputs(dev, n + m, n, k, m, shared, kind)
        got = topk_merge_cuda(*args)
        torch.cuda.synchronize()
        want = topk_merge_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n, k, m, kind)
        print(f"phase 4 topk_merge n={n} k={k} m={m} {kind}{' shared-ids' if shared else ''}: "
              f"bit-identical")


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
    from repro_torch.core.topk import TopKState, init_topk, merge_topk_states
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn_score.kernel import knn_score_cuda
    from repro_torch.kernels.knn_score.ops import knn_score
    from repro_torch.kernels.knn_score.ref import knn_score_plain
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.kernels.knn_topk.ref import knn_topk_plain
    from repro_torch.kernels.topk_merge.kernel import insert_candidates, topk_merge_cuda
    from repro_torch.kernels.topk_merge.ops import topk_merge
    from repro_torch.kernels.topk_merge.ref import topk_merge_plain
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.sparse.format import densify
    from repro_torch.testing import assert_topk_close

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build {len(built)} kernels (one nvcc each, in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    for kname, (lib, log) in sorted(built.items()):
        print(f"  {kname} -> {os.path.relpath(lib, root)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    counters = (knn_topk_fused, knn_score_cuda, topk_merge_cuda)

    def reset_counts():
        for fn in counters:
            fn.launches = 0

    edge_err = phase1_edge_cases(dev)

    t0 = time.perf_counter()
    S = synthetic_sparse(N_S, dim=DIM, nnz_mean=NNZ_MEAN, seed=1)
    R = synthetic_sparse(N_R, dim=DIM, nnz_mean=NNZ_MEAN, seed=0)
    print(f"data: synthetic-10k R and S generated in {time.perf_counter() - t0:.2f} s")

    # phase 2: the main path, cached mode (counts from 0 just before, read just after)
    spec = JoinSpec(k=K, algorithm="iib", r_block=BLOCK, s_block=BLOCK, tile=TILE,
                    use_kernel=True)
    reset_counts()
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
    cached_launches = knn_topk_fused.launches
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
    got = knn_topk_fused(*args, **kwargs)
    ref = knn_topk_plain(*args, **kwargs)
    torch.cuda.synchronize()
    engine_err = assert_topk_close(got[0].cpu(), got[1].cpu(), ref[0].cpu(), ref[1].cpu(),
                                   RTOL, ATOL)
    np.testing.assert_allclose(got[2].cpu().numpy(), ref[2].cpu().numpy(), rtol=RTOL, atol=ATOL)
    kernel_ms = cuda_ms(lambda: knn_topk_fused(*args, **kwargs), reps=3)
    plain_ms = cuda_ms(lambda: knn_topk_plain(*args, **kwargs), reps=2)
    s_dev = S.to(dev)
    r_dense, s_dense = densify(br), densify(s_dev)
    library_ms = cuda_ms(lambda: torch.topk(r_dense @ s_dense.T, K, dim=1), reps=3)
    score_library_ms = cuda_ms(lambda: r_dense @ s_dense.T, reps=3)
    del r_dense, s_dense
    block_r, block_s = kwargs["block_r"], kwargs["block_s"]
    flops = 2.0 * block_r * block_s * TILE * n_active
    topk_bytes = nbytes(*args, *got) + 4 * 2  # thr and nr_valid
    bound_ms, bound_by = bound(flops, topk_bytes, name)
    n_ctas = args[0].shape[1] // block_r
    print(f"phase 1 engine shapes: NR={args[0].shape[1]} NS={args[1].shape[1]} T+1="
          f"{args[0].shape[0]} A={args[2].shape[2]} active entries {n_active} CTAs {n_ctas} "
          f"max|dscore|={engine_err:.3e}")
    print(f"  knn_topk kernel {kernel_ms:.3f} ms/launch, plain {plain_ms:.3f} ms, "
          f"dense matmul+topk {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: "
          f"{flops:.3e} flop, {topk_bytes:.3e} B)")

    # phase 3: the main path, streaming mode
    reset_counts()
    st = JoinStats()
    t0 = time.perf_counter()
    out = knn_join(R.rows(0, BLOCK), S, K, algorithm="iib", r_block=BLOCK, s_block=BLOCK,
                   tile=TILE, use_kernel=True, stats=st)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launches = knn_topk_fused.launches
    s_blocks = -(-N_S // BLOCK)
    assert stream_launches == s_blocks == st.device_dispatches, (stream_launches, st)
    stream_err = assert_topk_close(out.scores.cpu(), out.ids.cpu(), q2.scores[:BLOCK].cpu(),
                                   q2.ids[:BLOCK].cpu(), RTOL, ATOL)
    print(f"phase 3 streaming: knn_join of {BLOCK} rows in {stream_s:.3f} s, launches "
          f"{stream_launches} for {s_blocks} S blocks, vs cached max|dscore|={stream_err:.3e}")

    # phase 4: knn_score and topk_merge against their plain versions
    score_err = phase4_score_cases(dev)
    phase4_merge_cases(dev)
    r_tiles, s_tiles, active = args[:3]
    sc = knn_score_cuda(r_tiles, s_tiles, active, block_r=block_r, block_s=block_s)
    sc_plain = knn_score_plain(r_tiles, s_tiles, active, block_r=block_r, block_s=block_s)
    torch.testing.assert_close(sc, sc_plain, rtol=RTOL, atol=ATOL)
    score_err = max(score_err, float((sc - sc_plain).abs().max()))
    del sc_plain
    score_ms = cuda_ms(lambda: knn_score_cuda(r_tiles, s_tiles, active, block_r=block_r,
                                              block_s=block_s), reps=5)
    score_plain_ms = cuda_ms(lambda: knn_score_plain(r_tiles, s_tiles, active,
                                                     block_r=block_r, block_s=block_s), reps=2)
    score_bound_ms, score_bound_by = bound(flops, nbytes(r_tiles, s_tiles, active, sc), name)
    print(f"phase 4 knn_score engine shapes: NR={sc.shape[0]} NS={sc.shape[1]} CTAs "
          f"{(sc.shape[0] // 64) * (sc.shape[1] // 64)} max|dscore|={score_err:.3e}")
    print(f"  knn_score kernel {score_ms:.3f} ms/launch, plain {score_plain_ms:.3f} ms, "
          f"dense matmul {score_library_ms:.3f} ms, bound {score_bound_ms:.3f} ms "
          f"({score_bound_by})")
    fresh = init_topk(sc.shape[0], K)
    cand = torch.where(sc > 0, sc, float("-inf"))
    cand_ids = torch.arange(sc.shape[1], dtype=torch.int32, device=dev)
    m_args = (fresh.scores, fresh.ids, cand, cand_ids)
    got_m, want_m = topk_merge_cuda(*m_args), topk_merge_plain(*m_args)
    assert torch.equal(got_m[0], want_m[0]) and torch.equal(got_m[1], want_m[1])
    merge_err = max_abs_err(got_m[0], want_m[0])
    merge_ms = cuda_ms(lambda: topk_merge_cuda(*m_args), reps=20)
    merge_plain_ms = cuda_ms(lambda: topk_merge_plain(*m_args), reps=5)
    merge_library_ms = cuda_ms(lambda: torch.topk(torch.cat([fresh.scores, cand], 1), K, dim=1),
                               reps=20)
    merge_bytes = nbytes(*m_args, *got_m)
    merge_bound_ms, merge_bound_by = bound(cand.numel() * 1.0, merge_bytes, name)
    print(f"phase 4 topk_merge engine shapes: N={cand.shape[0]} M={cand.shape[1]} k={K} "
          f"bit-identical")
    print(f"  topk_merge kernel {merge_ms:.4f} ms/launch, plain {merge_plain_ms:.3f} ms, "
          f"cat+topk {merge_library_ms:.3f} ms, bound {merge_bound_ms:.4f} ms "
          f"({merge_bound_by}: {merge_bytes:.3e} B)")
    del sc, cand, m_args, got_m, want_m

    # phase 5: the unfused path at full width, one R block at a time
    all_ids = torch.arange(N_S, dtype=torch.int32, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    parts_s, parts_i = [], []
    for r0 in range(0, N_R, BLOCK):
        sc = knn_score(R.rows(r0, min(r0 + BLOCK, N_R)), s_dev, tile=TILE)
        st0 = init_topk(sc.shape[0], K)
        m_s, m_i = topk_merge(st0.scores, st0.ids, torch.where(sc > 0, sc, float("-inf")),
                              all_ids)
        parts_s.append(m_s)
        parts_i.append(m_i)
    unfused_s, unfused_i = torch.cat(parts_s), torch.cat(parts_i)
    torch.cuda.synchronize()
    unfused_s_wall = time.perf_counter() - t0
    unfused_counts = (knn_score_cuda.launches, topk_merge_cuda.launches)
    assert unfused_counts == (r_blocks, r_blocks), unfused_counts
    assert knn_topk_fused.launches == 0
    unfused_err = assert_topk_close(unfused_s.cpu(), unfused_i.cpu(), q2.scores.cpu(),
                                    q2.ids.cpu(), RTOL, ATOL)
    unfused_oracle = assert_topk_close(unfused_s.cpu().numpy()[rows],
                                       unfused_i.cpu().numpy()[rows], o_s, o_i, RTOL, ATOL)
    print(f"phase 5 unfused: knn_score + mask + topk_merge over {r_blocks} R blocks in "
          f"{unfused_s_wall:.3f} s (fused cached query {query_s:.3f} s), launches "
          f"knn_score {unfused_counts[0]} topk_merge {unfused_counts[1]}, vs fused "
          f"max|dscore|={unfused_err:.3e}, 256 rows vs float64 scipy "
          f"max|dscore|={unfused_oracle:.3e}")
    del parts_s, parts_i, unfused_s, unfused_i

    # phase 6: merge_topk_states over S split at row 5,000
    half = N_S // 2
    reset_counts()
    t0 = time.perf_counter()
    qa = SparseKNNIndex.build(S.rows(0, half), spec).query(R)
    qb = SparseKNNIndex.build(S.rows(half, N_S), spec).query(R)
    b_ids = torch.where(qb.ids >= 0, qb.ids + half, qb.ids)
    a_state, b_state = TopKState(qa.scores, qa.ids), TopKState(qb.scores, b_ids)
    merged = merge_topk_states(a_state, b_state)
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    split_counts = (knn_topk_fused.launches, topk_merge_cuda.launches)
    assert split_counts == (2 * r_blocks, 1), split_counts
    split_err = assert_topk_close(merged.scores.cpu(), merged.ids.cpu(), q2.scores.cpu(),
                                  q2.ids.cpu(), RTOL, ATOL)
    plain_merge = insert_candidates(a_state.scores, a_state.ids, b_state.scores, b_state.ids)
    assert torch.equal(merged.scores, plain_merge[0]) and torch.equal(merged.ids, plain_merge[1])
    print(f"phase 6 merge_topk_states: two half-S indexes queried and merged in {split_s:.3f} s, "
          f"launches knn_topk {split_counts[0]} topk_merge {split_counts[1]}, vs full query "
          f"max|dscore|={split_err:.3e}, kernel merge bit-identical to the plain body")

    print(json.dumps({"kernels": [
        {
            "name": "knn_topk",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knn_topk.cu",
            "replaces": "src/repro/kernels/knn_topk/kernel.py:63",
            "launches": cached_launches + stream_launches + split_counts[0],
            "max_abs_err": max(edge_err, engine_err),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        },
        {
            "name": "knn_score",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knn_score.cu",
            "replaces": "src/repro/kernels/knn_score/kernel.py:37",
            "launches": unfused_counts[0],
            "max_abs_err": score_err,
            "ms": score_ms,
            "plain_ms": score_plain_ms,
            "bound_ms": score_bound_ms,
            "bound_by": score_bound_by,
            "library_ms": score_library_ms,
        },
        {
            "name": "topk_merge",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_merge.cu",
            "replaces": "src/repro/kernels/topk_merge/kernel.py:52",
            "launches": unfused_counts[1] + split_counts[1],
            "max_abs_err": merge_err,
            "ms": merge_ms,
            "plain_ms": merge_plain_ms,
            "bound_ms": merge_bound_ms,
            "bound_by": merge_bound_by,
            "library_ms": merge_library_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
