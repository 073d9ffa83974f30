#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the five CUDA kernels of src/repro_torch/kernels/csrc (knn_topk,
knn_score, topk_merge, flash_attn, wkv) and the first designs of knn_topk,
knn_score, flash_attn (f32 and bf16), wkv and topk_merge's k <= 128 path
kept in csrc/legacy (one nvcc each, all in parallel), then, at the paper's
synthetic setting
(configs/paper_knn.py "synthetic-10k":
n_r = n_s = 10,000, dim 10,000, mean nnz 120, k = 5, tile 128, r_block =
s_block = 2048):

  phase 1  the kernel against its plain PyTorch version on the card: edge
           cases at small shapes (k = 12, k = 128, ragged S block, masked
           columns, seeded threshold, equal scores in two S ranges, an R
           block that offers nothing), then one 2048-row R block against the
           full S stack at the engine's own shapes, with timings, the split's
           CTAs and ranges, ptxas's registers and spills, and the outputs
           and time of the kernel's first (sequential) design on the same
           inputs (csrc/legacy/), which must be equal bit for bit;
  phase 2  the main path, cached mode: SparseKNNIndex.build + two queries,
           one kernel launch per R block, 256 rows checked against a float64
           top-k computed with scipy.sparse; then two small joins (cached
           and streaming) held against the CPU path: k = 150, which takes
           the score and merge kernels instead of the fused one, and tile
           126, whose dense tiles are padded to 128;
  phase 3  the main path, streaming mode: knn_join on 2048 rows, one launch
           per S block, equal to phase 2's rows;
  phase 4  knn_score and topk_merge against their plain versions on the
           card: edge cases (block sizes 16 to 256, tile 256, ragged S; k
           from 1 to 128, ragged M, ties, -inf, shared ids, M from 512 on
           for topk_merge's split kernel), then the engine's shapes, with
           timings; both also bit for bit against their first designs, and
           timed beside them;
  phase 5  the unfused path at full width: per R block knn_score against
           all of S, the > 0 mask, topk_merge into a fresh state; equal to
           phase 2's query and to the float64 rows;
  phase 6  merge_topk_states: S split at row 5,000, both halves queried
           through a cached index each and merged; equal to phase 2's
           query, and the kernel's merge equal to the plain body; then
           merge_topk_states at k = 200 (the large-k kernel) on 10,000
           rows, bit-identical to the plain body, timed;

and, at the widths of models the repo supports (S = 4096):

  phase 7  flash_attn against its plain version (edge cases: causal or
           not, window, f32 and bf16 at every head width the kernels take
           and at 1, 48 and 80, which the wrapper pads, Sq != Skv,
           Sq < 16, Skv not a multiple of 8, ragged 96, GQA g = 1, 2, 8,
           10, windows whose edge falls inside a q tile, rows with no
           visible key, B·H = 65,536 heads), both tensor-core kernels' instructions
           (HMMA/HGMMA in cuobjdump -sass, which must be nonzero) and
           ptxas's registers and spills per head width, then qwen3-0.6b
           (H 16, KVH 8, hd 128, causal, B 2) and recurrentgemma-2b (H 10,
           KVH 1, hd 256, window 2048, B 1) in f32 (3xTF32) and bf16,
           each timed beside scaled_dot_product_attention and, in turns,
           the first (fp32-FMA) design, with the f32 check's reading for
           an output of one TF32 product (the plain version with TF32
           matmuls) and the bf16 check's for three planted faults (each
           must fail); then the op flash_sdpa at both widths and at the
           reduced configs' (hd 16, H 4, KVH 2, f32), the main path,
           against the model's _sdpa with _causal_mask (f32);
  phase 8  wkv against its plain version and, bit for bit, its first
           design (csrc/legacy/wkv_v1.cu) (edge cases: the reference
           tests' shapes, ragged T, strong decay, bf16, several waves),
           and at chunk 8 (the reduced configs', which the first design
           lacks) against its plain version only,
           then rwkv6-3b (B 2, T 4096, H 40, K 64, chunk 128): the three
           kernels' grids, shared memory, registers and device times
           (torch.profiler), timed beside the first design in turns, then
           again at B 16; then the op wkv, the main path, against the
           model's _chunked_wkv (f32).

and, through the entry points a user calls:

  phase 9  the paper's three drivers, BF, IIB without the fused kernel and
           IIIB (masked superset index, threshold in the carry), each
           block step merging through topk_merge: for each, a cached
           SparseKNNIndex built at synthetic-10k and queried three times
           (all 10,000 rows; equal to each other, to 256 float64 scipy
           rows and to phase 2's fused result; 5 dispatches, 5 host syncs
           and 25 topk_merge launches a query), with build and query
           times, the held and peak device memory, the work counters,
           IIIB's threshold traces and kept share, and a torch.profiler
           breakdown of one query's device time by kernel group; then
           knn_join of 2048 rows for each driver and by default (iiib),
           bit for bit the cached rows; IIIB with a 5% warm start; the
           three drivers cached on spectra at the yeast-worm config's
           widths (dim 20,000, 80 peaks a row; n_r 2,048, n_s 20,480)
           against scipy; and topk_merge on one IIIB block step's
           (2048, 2048) offers, bit for bit its plain version, timed;
  phase 10 the datastore's lifecycle and the approx tier, for each path
           (bf, iib, iib with the fused kernel, iiib): built on S's first
           8,000 rows and extended to 10,000 (index builds for the 2 tail
           blocks only; bit for bit phase 9's or phase 2's 10,000-row
           result), 500 seeded deletes (no index build, no deleted id,
           the survivors' build's answer with ids mapped), 256 rows with a
           TTL extended and expired, compact (bit for bit the survivors'
           build), refreeze (IIIB: its kept share before and after, bit for
           bit a build with the survivors' own rank), each step timed with
           the median of 3 queries, launches counted, and the same
           sequence streaming; knn_topk against its plain version at the
           engine's shapes with the stack's columns masked three ways
           (tombstone holes, whole dead 256-column tiles, every column
           dead); a k = 150 query on the datastore with deletes (knn_score
           and topk_merge launched, its first 5 columns the k = 5 answer);
           then on the planted workload at synthetic-10k widths (1,250
           clusters x 8 rows, R blocks of 16 probes; the default plan's
           recall first, for BF), each path's approx query (target recall
           0.95 for cosine >= 0.75: 40 bands x 10 rows): recall against
           the exact face, candidate fraction below 1, the exact face bit
           for bit an exact build's, streaming bit for bit, 16 rows against
           the CPU path, no deleted row, with the key hashing, band lookup,
           approx and exact query times; and topk_merge on an approx block
           step's offers;
  phase 11 the sharded store on one card (ShardedKNNStore, 4 shards): at
           synthetic-10k for bf, iib and iiib, at s_block 500 bit for bit
           one index of the same blocks, and at s_block 2,048 built once and
           queried 3 times (5 dispatches, 5 host syncs and 5 x (4 shards x 2
           block steps + 3 tree merges) topk_merge launches a query, index
           builds frozen), with build and query times beside phase 9's one
           index, held and peak device memory, and the checks against phase
           9's rows and 256 float64 scipy rows; topk_merge on one tree merge
           and one shard block step, timed beside its plain version and
           torch.topk; 2 replicas x 4 shards (iib) through a replica_error
           mid-query (bit for bit the clean query, one failover), an add and
           deletes while it is dead, resync_replicas, verify_replicas and
           the half-open probe; an unreplicated shard_error (raises, then
           allow_partial); add, delete, TTL expiry, compact and refreeze on
           an iiib store, each against a fresh store over the live rows;
           then the yeast-worm config's S (207,804 rows, dim 20,000, 80
           peaks) in 4 shards for bf, iib and iiib (iiib at the full S when
           the host holds 3x its stacks), R 4,096 rows, against scipy, with
           build and query times and held and peak device memory;
  phase 12 the store's checkpoints and the serving front-end, on phase
           11's stores: (c) a KNNScheduler over the 4-shard IIB store
           (r_block 2,048) serving all 10,000 R rows as seeded requests of
           1-64 rows with k from 1 to 5, submitted at once (no failure, no
           query-time index build, each answer within tolerance of the
           direct 10,000-row query, one batch rebuilt with _assemble and
           queried directly bit for bit the answers), after a warm run
           under ProfileCapture whose trace must hold topk_merge kernels;
           (d) the same stream through a shard_error on shard 1, with
           recover from a checkpoint saved first: allow_partial (degraded
           answers without shard 1's ids, recovery in the background, a
           second wave all full and bit for bit its assembled batch) and
           queued behind recovery (every answer full); (a) durability at
           synthetic-10k for IIB and IIIB: add 2,000 rows (256 with a TTL),
           delete 500, expire, save, load at 4 shards (bit for bit, index
           builds frozen) and at 2 (within tolerance), an add to one shard
           and save_dirty (the clean shards' leaves hard-linked, counted by
           inode), mark_lost(1) with an allow_partial query, recover (bit
           for bit), and a corrupt leaf in the newest step (latest_step
           falls back, recover rebuilds from step 0, bit for bit its
           query); (b) the yeast-worm BF store (S not cut): save, load,
           mark_lost and recover, each bit for bit on one R block of 2,048.
           Times, MiB written and hard-linked, MiB/s, ServeMetrics' p50/p99
           and rows/s, batches and mean fill, and topk_merge launches, each
           beside the card's name and power limit.  Checkpoints go to a
           temporary directory, removed at the end;
  phase 13 the multi-device join and the job launcher: (a) the CLI
           (launch/join_job.py::main) at synthetic-10k for bf, iib and
           iiib (--repeat 3) and at yeast-worm widths (--spectra, R 2,048
           x S 20,480 as phase 9 cuts them), each summary's mean_top1 and
           counters bit for bit a direct SparseKNNIndex query of the same
           data, then `python -m repro_torch.launch.join_job --ring` and
           examples/torch_quickstart.py as processes of their own (exit 0,
           a JSON line; the oracle match); (b) ShardedKNNStore over a mesh
           of cuda:0 four times (launch/mesh.py::make_store_mesh), bit for
           bit phase 11's num_shards=4 store with every JoinStats and
           StoreStats counter equal, for bf, iib and iiib at synthetic-10k
           and for bf at yeast-worm's full S (one R block of 2,048), and a
           (2, 2) ('replica', 'shard') mesh through a replica_error
           failover, resync and the half-open probe, bit for bit the
           num_shards=2 x replicas=2 store; (c) the ring join at
           synthetic-10k on a (4, 2) ('data', 'model') mesh of cuda:0:
           _ring_join_impl for bf, iib and iiib (16 ring steps, each a
           topk_merge launch), ring_knn_join with dim_axis='model' for bf
           and iib, and distributed_join's store route (iiib), each against
           phase 9's single index and, at R 300 x S 600 (dim 2,000),
           against its own CPU path (a mesh of CPU entries); times and
           topk_merge launches printed; (d) where the machine has more
           than one card, (b) and (c) again over distinct cards.

and the LM serving path at full published width and depth:

  phase 14 launch/serve.py::Server on the card, random weights from a seed,
           prompts of 1,024 seeded tokens, max_seq 2,048: (a) qwen3-0.6b
           bf16 (28 layers, d 1,024, H 16, KVH 8, hd 128, vocab 151,936),
           4 slots, 8 requests of max_new 32; (b) the same in f32 (the
           3xTF32 kernel), 2 slots, 2 requests; (c) rwkv6-3b bf16 (32
           layers, d 2,560, 40 heads of 64, chunk 128), 2 slots, 4 requests
           of max_new 16.  Per request prefill ms and decode ms a token,
           tokens/s, latency_summary, device memory held and peak; the
           launches asserted exactly (flash_attn one a layer a prefill and a
           decode step: 7,168 bf16 in (a), 1,792 f32 in (b); wkv one a layer
           a prefill: 128 in (c)); then a replay of the same prefill and
           decode_step calls on the same tokens and weights with
           kernels=False (the JAX package's plain _sdpa and _chunked_wkv),
           launching nothing: the logits within LM_TOL_FACTOR * sqrt(L) *
           unit * RMS, the greedy token equal wherever the replay's top two
           are further apart than twice that; (d) `python -m
           repro_torch.launch.serve --arch qwen3-0.6b` and (e)
           examples/torch_knnlm_serve.py, each a process of its own (exit
           0; the JAX CLI's JSON keys; the example's summary line); (f) the
           flash_attn and wkv wrappers at the main path's shapes (qwen3-0.6b
           prefill and a decode step, rwkv6-3b prefill) against their plain
           versions, timed beside SDPA and their bounds;
  phase 15 the other families through Server, full published widths:
           (a) olmoe-1b-7b bf16, 4 requests of 1,024 x max_new 16; (a')
           the same in f32 (3xTF32), 2 requests; (b) phi3.5-moe bf16 with
           its depth cut 32 -> 4 (its bf16 weights do not fit one card),
           2 x 1,024 x 8; (c) recurrentgemma-2b bf16, prompts of 1,024,
           3,000 (past the 2,048 window) and 1,024 on 2 slots, x 32; (d)
           llama-3.2-vision-11b bf16, 2 x 1,024 x 16 on the zero stub
           patches, then one request on N(0, 1) patches with the cross
           gates at 0.5; (e) whisper-medium bf16, 4 x 256 x 32 (max_seq
           448) on zero frames, then one on N(0, 1) frames.  Every
           flash_attn launch asserted (an attention core a prefill and a
           decode step, testing.attention_calls); each run replayed with
           kernels=False (MoE: each call rerun with the kernels and
           replayed from copies of its cache, routed to the kernel route's
           experts, the plain route's own expert flips counted and their
           router gaps held to the rounding; the logits held to phase 14's
           tolerance or 4x the spread between the plain route and one
           with an f32 attention core); a torch.profiler reading of (a)
           and (c); (f) `python -m repro_torch.launch.serve --arch
           recurrentgemma-2b` as a process; (g) flash_attn at phase 15's
           shapes against its plain version, timed beside SDPA.

and training on one card:

  phase 16 (a) 3 train steps (launch/steps.py, AdamW, the chunked CE) of
           the reduced model of one arch a family (qwen3-0.6b,
           olmoe-1b-7b, rwkv6-3b, recurrentgemma-2b, llama-3.2-vision-11b,
           whisper-medium; f32, TF32 off) on the card and on the CPU from
           the same weights and make_lm_batch batches: losses, grad_norm
           and the parameters within testing.train_close's tolerances
           (the share used printed), no kernel launched (the train step
           runs the plain route, as the reference trains); (b) qwen3-0.6b
           at full width through launch/train.py::build and its step (bf16
           compute, f32 master weights, remat), batch 8 x 1,024, CE chunks
           of 512, 10 steps: the median step after 2 of warm-up, tokens/s,
           held and peak memory, the model FLOP rate beside the bf16 dense
           peak, one step's device busy time and idle share by kernel group
           (torch.profiler), every loss finite; (c) launch/train.py::main on
           a reduced config through an injected failure (RESTORE after,
           failures 1), then a new process resuming from its last
           checkpoint; (d) flash_attention_cuda and wkv_cuda raise on an
           input that requires grad, and a model built to train with
           kernels=True still serves through them, every launch asserted;

and training and serving over a mesh whose positions all sit on the card:

  phase 17 (a) qwen3-0.6b at full width (as phase 16 (b)), 3 steps on a
           (2, 2) mesh in "2d" (launch/placement.py's blocks, the mesh step
           of launch/steps.py) and 3 on (1, 1) from one init: losses and
           grad_norm within 2^-7, the parameters within two Adam steps a
           step (the share used printed); step ms, state, held and peak
           memory, the bytes gathered and reduced a step, the blocks a
           position, one (2, 2) step under torch.profiler; (b)
           launch/compressed_train.py on a (2, 1) mesh, batch 4 x 1,024, 4
           steps with exact sync and with psum_int8: both fall, within
           0.05 of each other, the int8 payload and step ms; (c) Server
           over a (2, 1) mesh: phase 14 (a)'s and (c)'s requests give
           phase 14's tokens, with 7,168 flash_attn and 128 wkv launches
           (asserted); (d) launch/train.py: checkpoints saved on --data-par
           4 --model-par 2 and on one device, each resumed on 2 x 2 by a
           process of its own ("resumed from step 4");

and the dry run (launch/dryrun.py), its plans held to runs on the card:

  phase 18 (a) the 40 (arch x shape) cells at full width on the 16 x 16
           mesh of meta entries, in this process: a line a cell (the
           largest position's argument, temp-estimate and gathered-model
           bytes, whether it fits this card, FLOPs a position, bytes
           gathered and reduced a step), the skips cell_supported's, no
           cell failing (past DRY_BUDGET_S the remaining train_4k cells are
           cut and named); (b) qwen3-0.6b 8 x 1,024 traced for (1, 1) and
           (2, 2), then one real step each through launch/train.py::build
           on the card: state bytes, gathered/reduced (step.stats) and the
           step's FLOPs (launch/op_analysis.py over the real step) equal the
           prediction exactly, peak live bytes beside the card's peak; (c)
           qwen3-0.6b's prefill of 1,024 tokens and a decode at the full
           cache, rwkv6-3b's prefill of 1,024, with the kernels: the
           predicted flash_attn and wkv launches equal the wrappers'
           counters, the kernel and ATen FLOPs the real calls'.

Every flash_attn and wkv comparison goes through repro_torch.testing
(flash_close, wkv_close: one tolerance table with the card tests) and
prints the largest share of its tolerance that any element used.

Prints the card's name and power limit, the build time, each phase's
numbers, one JSON line describing all five kernels (flash_attn twice: its
f32 3xTF32 kernel and its bf16 kernel), and as its last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; with
no CUDA device it exits 1 and prints no result.
"""
import contextlib
import json
import os
import re
import shutil
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


def peaks(name, dtype=torch.float32):
    """(FLOP/s for ``dtype``, bytes/s) published for the card (NVIDIA data
    sheets): the fp32 rate outside the tensor cores, the dense bf16 rate,
    and for "tf32" the dense TF32 tensor-core rate."""
    pcie = "PCIe" in name
    byte_rate = 2.0e12 if pcie else 3.35e12
    if dtype == torch.bfloat16:
        return (756e12 if pcie else 989e12), byte_rate
    if dtype == "tf32":
        return (378e12 if pcie else 495e12), byte_rate
    return (51e12 if pcie else 67e12), byte_rate


def phase1_edge_cases(dev):
    from repro_torch.core.topk import init_topk, min_prune_score
    from repro_torch.kernels.knn_score.ops import _pad_rows, active_lists, dense_tiles_with_sentinel
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.kernels.knn_topk.ops import column_meta, pad_state
    from repro_torch.kernels.knn_topk.ref import knn_topk_plain
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.sparse.format import tile_occupancy
    from repro_torch.testing import assert_topk_close, doubled, with_zero_rows

    def tiles_and_lists(R, S, br, bs):
        r_tiles = _pad_rows(dense_tiles_with_sentinel(R, TILE), br)
        s_tiles = _pad_rows(dense_tiles_with_sentinel(S, TILE), bs)
        active = torch.as_tensor(active_lists(
            tile_occupancy(R, TILE).cpu().numpy(), tile_occupancy(S, TILE).cpu().numpy(),
            br, bs), device=dev)
        return r_tiles, s_tiles, active

    cases = [  # name, nr, ns, dim, block_r, block_s, k, masked, seeded thr, variant
        ("k8", 64, 64, 256, 64, 64, 8, False, False, None),
        ("k5-ragged-rows-and-s", 70, 90, 640, 64, 64, 5, False, False, None),
        ("k12-small-blocks", 48, 100, 512, 16, 32, 12, False, False, None),
        ("k3-tall-thin", 32, 200, 1024, 32, 64, 3, False, False, None),
        ("k128-ragged-s", 300, 1100, 512, 256, 256, 128, False, False, None),
        ("k7-masked-columns", 40, 300, 512, 32, 96, 7, True, False, None),
        ("k5-seeded-thr", 200, 600, 1024, 104, 256, 5, False, True, None),
        # S's second half repeats its first: equal scores in two S ranges
        ("ties-across-ranges", 300, 1024, 512, 256, 128, 16, False, False, "ties"),
        # R block 1 zeroed after the warm pass: it offers nothing, keeps thr_in
        ("no-offer", 100, 320, 1024, 32, 64, 5, False, True, "no-offer"),
    ]
    worst = 0.0
    for name, nr, ns, dim, br, bs, k, masked, seeded, variant in cases:
        R = synthetic_sparse(nr, dim=dim, nnz_mean=14, nnz_std=4, seed=nr + ns).to(dev)
        if variant == "ties":
            S = doubled(synthetic_sparse(ns // 2, dim=dim, nnz_mean=14, nnz_std=4, seed=7)).to(dev)
        else:
            S = synthetic_sparse(ns, dim=dim, nnz_mean=14, nnz_std=4, seed=nr * ns).to(dev)
        s_valid = np.random.default_rng(ns).random(ns) > 0.3 if masked else None
        state = init_topk(nr, k, device=dev)
        if seeded:  # a warm state and its MinPruneScore from a first pass
            half = S.rows(0, ns // 2)
            r_tiles, h_tiles, h_active = tiles_and_lists(R, half, br, bs)
            hv, hi = column_meta(ns // 2, h_tiles.shape[1], device=dev)
            i_s, i_i = pad_state(state, r_tiles.shape[1])
            w_s, w_i, _ = knn_topk_plain(r_tiles, h_tiles, h_active, hv, hi, i_s, i_i,
                                         block_r=br, block_s=bs)
            state = type(state)(w_s[:nr], w_i[:nr])
        if variant == "no-offer":
            R = with_zero_rows(R, br, 2 * br)
        r_tiles, s_tiles, active = tiles_and_lists(R, S, br, bs)
        valid, ids = column_meta(ns, s_tiles.shape[1], s_valid=s_valid, device=dev)
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
        if variant == "ties":   # some row holds both copies of one S row
            ids_ = got[1][:nr]
            assert bool(((ids_[:, :, None] == ids_[:, None, :] + ns // 2)
                         & (ids_[:, None, :] >= 0)).any())
        if variant == "no-offer":   # block 1 kept its seed and thr_in
            assert float(got[2][1]) == float(thr)
            assert torch.equal(got[0][br:2 * br], init_s[br:2 * br])
            assert float(init_s[br:2 * br, -1].min()) > float(thr)
        worst = max(worst, err)
        print(f"phase 1 {name}: NR={r_tiles.shape[1]} NS={s_tiles.shape[1]} k={k} "
              f"max|dscore|={err:.3e} thr_out={got[2].flatten().tolist()[:4]}")
    return worst


def phase2_large_k_and_odd_tile(dev):
    """Two small joins, cached and streaming, against the CPU path: k = 150
    (over the fused kernel's 128 slots, so the score and merge kernels run
    in its place) and tile 126 (dense tiles padded to 128).  The launches of
    the three join kernels must show the route; returns the worst max
    |Δscore|."""
    from repro_torch.core.blocknl import knn_join
    from repro_torch.core.engine import JoinSpec, SparseKNNIndex
    from repro_torch.kernels.knn_score.kernel import knn_score_cuda
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.testing import assert_topk_close

    R = synthetic_sparse(600, dim=2000, nnz_mean=40, seed=2)
    S = synthetic_sparse(2000, dim=2000, nnz_mean=40, seed=3)
    counters = (knn_topk_fused, knn_score_cuda, topk_merge_cuda)
    runs = -(-600 // 256) * (1 + -(-2000 // 512))   # R blocks cached, then pairs streaming
    worst = 0.0
    for k, tile in ((150, TILE), (K, 126)):
        kw = dict(algorithm="iib", r_block=256, s_block=512, tile=tile, use_kernel=True)
        spec = JoinSpec(k=k, **kw)
        before = [fn.launches for fn in counters]
        cached = SparseKNNIndex.build(S, spec).query(R)
        streamed = knn_join(R, S, k, **kw)
        torch.cuda.synchronize()
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        assert launched == ([0, runs, runs] if k > 128 else [runs, 0, 0]), (k, tile, launched)
        cpu = SparseKNNIndex.build(S, spec, device="cpu").query(R)
        errs = [assert_topk_close(got.scores.cpu(), got.ids.cpu(), cpu.scores, cpu.ids, RTOL, ATOL)
                for got in (cached.state, streamed)]
        assert cached.scores.shape == streamed.scores.shape == (600, k)
        worst = max(worst, *errs)
        print(f"phase 2 k={k} tile={tile}: cached and streaming vs the CPU path max|dscore|="
              f"{max(errs):.3e}; launches knn_topk {launched[0]} knn_score {launched[1]} "
              f"topk_merge {launched[2]}")
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


def bound(flops, nbytes, name, dtype=torch.float32):
    """(least ms, "operations" or "bytes"): the larger of the two times."""
    flop_rate, byte_rate = peaks(name, dtype)
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_usage(log):
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from an ``nvcc -Xptxas -v`` log."""
    usage, fn, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)), *spills)
    return usage


def usage_of(usage, part):
    """"N registers, S/L B spilled" of the one entry whose name holds ``part``."""
    hits = [v for f, v in usage.items() if part in f]
    if len(hits) != 1:
        return f"ptxas usage of {part} not found"
    regs, st, ld = hits[0]
    return f"{regs} registers, spills {st} B stored / {ld} B loaded"


def sass_mma_counts(lib, part):
    """{function: HMMA + HGMMA instructions} for the functions of the
    library ``lib`` whose name holds ``part``, read from ``cuobjdump -sass``
    (the toolkit's); raises if cuobjdump is missing or fails."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if part in fn:
                counts[fn] = 0
        elif fn in counts and re.search(r"\bH(?:G)?MMA\b", line):
            counts[fn] += 1
    return counts


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
    from repro_torch.kernels.legacy import topk_merge_v1
    from repro_torch.kernels.topk_merge.kernel import SPLIT_MIN_M, topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import topk_merge_plain

    cases = [  # n, k, m, shared ids, kind
        (64, 1, 64, False, "mixed"),
        (100, 5, 300, True, "mixed"),      # M not a multiple of 32, shared (M,) ids
        (33, 8, 64, False, "ties"),
        (256, 16, 50, False, "neginf"),
        (40, 128, 200, True, "mixed"),
        (300, 5, 1001, True, "mixed"),     # M >= 512 takes the split kernel
        (64, 8, 1027, False, "ties"),      # the split kernel: ties across slices, rows off
        (50, 128, 2000, True, "neginf"),   # the 16-byte grid (M not a multiple of 4)
        (2048, 5, 10_240, True, "mixed"),  # the unfused path's shapes
        (64, 150, 500, True, "ties"),      # k > 128: the large-k kernel
        (20, 1000, 3000, False, "mixed"),
    ]
    for n, k, m, shared, kind in cases:
        args = merge_inputs(dev, n + m, n, k, m, shared, kind)
        got = topk_merge_cuda(*args)
        torch.cuda.synchronize()
        want = topk_merge_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (n, k, m, kind)
        route = ("large-k" if k > 128 else "split" if m >= SPLIT_MIN_M else "warp-a-row")
        if k <= 128:   # the first (warp-a-row) design, bit for bit
            old = topk_merge_v1(*args)
            assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1]), (n, k, m, kind)
        print(f"phase 4 topk_merge n={n} k={k} m={m} {kind}{' shared-ids' if shared else ''} "
              f"({route} kernel): bit-identical to the plain version"
              f"{' and the first design' if k <= 128 else ''}")


# Phase 7: flash attention at the widths of two models the repo supports,
# S = 4096 (train_4k's sequence, src/repro/launch/shapes.py:5)
FLASH_WIDTHS = {  # b, s, h, kvh, hd, window; causal
    "qwen3-0.6b": (2, 4096, 16, 8, 128, 0),           # src/repro/configs/qwen3_06b.py
    "recurrentgemma-2b": (1, 4096, 10, 1, 256, 2048),  # configs/recurrentgemma_2b.py, local attn
}
# the reduced configs' attention (src/repro/configs/base.py:92-117: hd 16,
# H 4, KVH 2, f32), on the main path of phase 7 beside the model widths
FLASH_REDUCED = (2, 4096, 4, 2, 16, 0)


def flash_qkv(dev, b, s, h, kvh, hd, seed):
    """f32 q (b, s, h, hd), k and v (b, s, kvh, hd), N(0, 1), made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]


def phase7_edge_cases(dev):
    """flash_attention_cuda against flash_attention_plain at small shapes;
    the worst (|Δ|, share of the tolerance used) in f32 and in bf16."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.testing import flash_close

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # bh, kvh, sq, skv, hd, causal, window, dtype
        *[(bh, bh, sq, skv, hd, causal, 0, f32)   # tests/test_flash_attn.py:20-25
          for bh, sq, skv, hd in ((2, 128, 128, 64), (1, 256, 256, 128), (3, 128, 256, 64),
                                  (2, 256, 128, 32))
          for causal in (True, False)],
        (2, 2, 256, 256, 64, True, 64, f32),       # window 64
        (2, 2, 128, 128, 64, True, 0, bf16),
        (3, 3, 200, 136, 64, True, 0, bf16),       # bf16, Sq != Skv, ragged
        (8, 8, 96, 96, 64, True, 0, f32),          # ragged 96, GQA g = 1
        (8, 4, 96, 96, 64, False, 0, f32),         # ragged 96 non-causal, g = 2
        (16, 2, 96, 96, 128, True, 0, f32),        # g = 8
        (4, 2, 160, 160, 256, True, 0, f32),       # hd 256
        (2, 1, 300, 300, 256, True, 128, bf16),    # hd 256, window, bf16
        (2, 2, 128, 64, 32, True, 16, f32),        # late rows see no key: zeros
        # the bf16 tensor-core kernel at every head width and edge
        (2, 2, 128, 128, 32, True, 0, bf16),       # hd 32
        (4, 2, 200, 200, 128, True, 0, bf16),      # hd 128, g 2
        (10, 1, 130, 130, 128, True, 0, bf16),     # g 10
        (4, 2, 100, 77, 64, False, 0, bf16),       # non-causal, Skv not a multiple of 8 or 16
        (3, 3, 9, 9, 128, True, 0, bf16),          # Sq < 16
        (2, 2, 128, 64, 64, True, 16, bf16),       # late rows see no key: zeros
        (2, 1, 200, 200, 128, True, 100, bf16),    # window edge inside a q tile
        # the f32 3xTF32 kernel at every edge, and the widths the wrapper pads
        (4, 2, 64, 64, 16, True, 8, f32),          # hd 16, window 8: the reduced configs
        (2, 2, 9, 25, 16, False, 0, f32),          # hd 16, Sq < 16, non-causal
        (4, 2, 70, 70, 48, True, 0, f32),          # hd 48 -> 64
        (3, 3, 90, 90, 80, False, 0, f32),         # hd 80 -> 128
        (4, 2, 40, 40, 1, True, 0, f32),           # hd 1 -> 16
        (10, 1, 130, 130, 128, True, 0, f32),      # g 10
        (4, 2, 100, 77, 64, False, 0, f32),        # non-causal, Skv not a multiple of 8
        (3, 3, 9, 9, 128, True, 0, f32),           # Sq < 16
        (2, 2, 128, 64, 64, True, 16, f32),        # late rows see no key: zeros
        (2, 1, 200, 200, 128, True, 100, f32),     # window edge inside a q tile
        (2, 1, 300, 300, 256, True, 40, f32),      # hd 256, window edge inside q tiles
        (4, 2, 64, 64, 16, True, 8, bf16),         # bf16 hd 16
        (4, 2, 70, 70, 48, True, 0, bf16),         # bf16 hd 48 -> 64
        (3, 3, 90, 90, 80, False, 0, bf16),        # bf16 hd 80 -> 128
        # B·H past 65,535: BH is gridDim.x (the query tiles are gridDim.y)
        (65_536, 65_536, 16, 16, 16, True, 0, f32),
    ]
    worst = {f32: (0.0, 0.0), bf16: (0.0, 0.0)}
    for bh, kvh, sq, skv, hd, causal, window, dtype in cases:
        g = torch.Generator(device=dev).manual_seed(sq * skv + hd)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((bh, sq, hd), (kvh, skv, hd), (kvh, skv, hd)))
        kw = dict(causal=causal, sm_scale=hd ** -0.5, window=window)
        got = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, **kw)
        err, used = flash_close(got, want)
        assert got.shape == q.shape and bool(torch.isfinite(got).all())
        if window == 16 and skv == 64:   # rows from 79 on see no key: exactly 0
            assert not got[:, 79:].any()
        worst[dtype] = tuple(map(max, worst[dtype], (err, used)))
        print(f"phase 7 flash bh={bh} kvh={kvh} sq={sq} skv={skv} hd={hd} causal={causal} "
              f"window={window} {str(dtype)[6:]}: max|d|={err:.3e} tol used {used:.3f}")
    return worst


def phase7_planted_faults(q, k, v, window, want):
    """What the bf16 check reads, against the plain version ``want``, for
    outputs with a planted fault, each computed in f32 by the model's _sdpa
    on the same bf16 inputs and rounded to bf16: the diagonal kv tile
    dropped, kv tile 0 dropped for rows past it, and v's lanes 1 and 2
    swapped in each group of 4 (a bf16 load fault).  Each must fail."""
    from repro_torch.kernels.flash_attn.ops import heads_first
    from repro_torch.models.attention import _causal_mask, _sdpa
    from repro_torch.testing import flash_tolerance, tolerance_used

    s, hd = q.shape[1], q.shape[3]
    vis = _causal_mask(s, s, 0, window, device=q.device)[0, 0]
    pos = torch.arange(s, device=q.device)
    same_tile = (pos[:, None] // 64) == (pos[None, :] // 64)
    tile0 = (pos[:, None] >= 64) & (pos[None, :] < 64)
    lanes = torch.arange(hd, device=q.device).view(-1, 4)[:, [0, 2, 1, 3]].reshape(-1)
    qf, kf, vf = q.float(), k.float(), v.float()
    faults = {
        "diagonal tile dropped": lambda: _sdpa(qf, kf, vf, (vis & ~same_tile)[None, None]),
        "tile 0 dropped": lambda: _sdpa(qf, kf, vf, (vis & ~tile0)[None, None]),
        "v lanes 1,2 swapped": lambda: _sdpa(qf, kf, vf[..., lanes], vis[None, None]),
    }
    tol = flash_tolerance(want)
    readings = {}
    for fault, fn in faults.items():
        readings[fault] = tolerance_used(heads_first(fn().to(q.dtype)), want, *tol)[1]
        assert readings[fault] > 1.0, (fault, readings[fault])
    return readings


def phase7_tf32_planted_fault(qf, kf, vf, kw, want):
    """What the f32 check reads, against the plain version ``want``, for
    the plain version computed with TF32 matmuls (one TF32 product where
    the kernel takes three); it must fail."""
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.testing import flash_tolerance, tolerance_used

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        planted = flash_attention_plain(qf, kf, vf, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    reading = tolerance_used(planted, want, *flash_tolerance(want))[1]
    assert reading > 1.0, ("one TF32 product passes the f32 check", reading)
    return reading


def phase7_full_width(dev, name, model, dtype):
    """Kernel against plain at one model's width, with timings: a dict of
    the kernel line's numbers for this case, and the first (fp32-FMA)
    design's check and time in turns beside the kernel.  The check's
    readings for planted faults too: one TF32 product in f32, three faults
    in bf16."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda, visible_pairs
    from repro_torch.kernels.flash_attn.ops import heads_first
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.kernels.legacy import flash_attn_v1
    from repro_torch.models.attention import _causal_mask
    from repro_torch.testing import flash_close

    b, s, h, kvh, hd, window = FLASH_WIDTHS[model]
    q, k, v = (x.to(dtype) for x in flash_qkv(dev, b, s, h, kvh, hd, seed=hd))
    qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
    kw = dict(causal=True, sm_scale=hd ** -0.5, window=window)
    got = flash_attention_cuda(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(qf, kf, vf, **kw)
    err, used = flash_close(got, want)
    if dtype == torch.bfloat16:
        faults = phase7_planted_faults(q, k, v, window, want)
        print(f"phase 7 flash {model} bf16 check: kernel uses {used:.3f} of the tolerance; "
              "planted faults read " + ", ".join(f"{f} {r:.1f}x" for f, r in faults.items()))
    else:
        tf32_reading = phase7_tf32_planted_fault(qf, kf, vf, kw, want)
        print(f"phase 7 flash {model} f32 check: the 3xTF32 kernel uses {used:.3f} of the "
              f"tolerance; one TF32 product (plain with TF32 matmuls) reads {tf32_reading:.1f}x")
    first = flash_attn_v1(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    first_err, first_used = flash_close(first, want)
    del first, want
    turns = [cuda_ms(lambda: fn(qf, kf, vf, **kw), reps=r)
             for fn, r in ((flash_attention_cuda, 10), (flash_attn_v1, 5), (flash_attn_v1, 5),
                           (flash_attention_cuda, 10))]
    ms, first_ms = turns[0], turns[1]
    print(f"  first design (fp32 FMAs): max|d|={first_err:.3e} tol used {first_used:.3f}; in "
          f"turns (kernel, first, first, kernel) {'; '.join(f'{x:.3f}' for x in turns)} ms/launch")
    plain_ms = cuda_ms(lambda: flash_attention_plain(qf, kf, vf, **kw), reps=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (B, H, S, hd) views
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        mask = _causal_mask(s, s, 0, window, device=dev)[0, 0]
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=5)
    else:
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), reps=5)
    flops = 4.0 * hd * visible_pairs(s, s, True, window) * b * h
    flash_bytes = nbytes(qf, kf, vf, got)
    if dtype == torch.bfloat16:
        bound_ms, bound_by = bound(flops, flash_bytes, name, dtype)
        fma_bound_ms = None
    else:   # three TF32 products a product on the tensor cores; fp32 FMAs beside it
        bound_ms, bound_by = bound(3 * flops, flash_bytes, name, "tf32")
        fma_bound_ms = bound(flops, flash_bytes, name)[0]
    q_tile = 64 if dtype == torch.bfloat16 and hd > 128 else 128   # rows a CTA (csrc/flash_attn.cu)
    n_ctas = -(-s // q_tile) * b * h
    print(f"phase 7 flash {model} {str(dtype)[6:]}: B={b} S={s} H={h} KVH={kvh} hd={hd} "
          f"window={window} CTAs {n_ctas} max|d|={err:.3e} tol used {used:.3f}")
    bounds = (f"bound {bound_ms:.4f} ms ({bound_by}: {flops:.3e} flop, {flash_bytes:.3e} B)"
              if fma_bound_ms is None else
              f"bound {bound_ms:.4f} ms (3xTF32: {3 * flops:.3e} TF32 flop at the dense TF32 "
              f"rate; {flops:.3e} flop, {flash_bytes:.3e} B), fp32-FMA bound "
              f"{fma_bound_ms:.4f} ms")
    print(f"  flash_attn kernel {ms:.3f} ms/launch, first design {first_ms:.3f} ms "
          f"({first_ms / ms:.2f}x), plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, "
          f"{bounds}, {flops / ms / 1e9:.1f} TFLOP/s")
    return dict(max_abs_err=err, used=used, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, first_ms=first_ms,
                fma_bound_ms=fma_bound_ms)


def phase7_main_path(dev, reset_counts, counters):
    """The op flash_sdpa at both widths, f32 and bf16, as a model calls it;
    the kernel's launch count over exactly these calls."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attn.ops import flash_sdpa, heads_first
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.models.attention import _causal_mask, _sdpa
    from repro_torch.testing import flash_close

    widths = dict(FLASH_WIDTHS, reduced=FLASH_REDUCED)
    inputs = {m: flash_qkv(dev, *widths[m][:5], seed=7) for m in widths}
    calls = [(m, dtype) for m in FLASH_WIDTHS for dtype in (torch.float32, torch.bfloat16)]
    calls.append(("reduced", torch.float32))
    reset_counts()
    t0 = time.perf_counter()
    outs = [flash_sdpa(*(x.to(dtype) for x in inputs[m]), causal=True,
                       window=widths[m][5]) for m, dtype in calls]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_cuda.launches
    f32_launches = flash_attention_cuda.f32_mma_launches
    bf16_launches = flash_attention_cuda.bf16_launches
    assert launches == len(calls), launches
    assert bf16_launches == sum(dtype == torch.bfloat16 for _, dtype in calls), bf16_launches
    assert f32_launches == sum(dtype == torch.float32 for _, dtype in calls), f32_launches
    assert all(fn.launches == 0 for fn in counters if fn is not flash_attention_cuda)
    worst = 0.0
    for (m, dtype), out in zip(calls, outs):
        b, s, h, kvh, hd, window = widths[m]
        q, k, v = (x.to(dtype) for x in inputs[m])
        assert out.shape == (b, s, h, hd) and out.dtype == dtype
        assert bool(torch.isfinite(out).all())
        if dtype == torch.float32:   # the model's own attention, f32
            want = _sdpa(q, k, v, _causal_mask(s, s, 0, window, device=dev))
        else:                        # _sdpa would round its scores to bf16
            want = flash_attention_plain(heads_first(q), heads_first(k), heads_first(v),
                                         causal=True, sm_scale=hd ** -0.5, window=window)
            want = want.reshape(b, h, s, hd).transpose(1, 2)
        err, used = flash_close(out, want)
        if dtype == torch.float32:
            worst = max(worst, err)
        print(f"phase 7 flash_sdpa {m} {str(dtype)[6:]}: vs "
              f"{'_sdpa + _causal_mask' if dtype == torch.float32 else 'plain'} "
              f"max|d|={err:.3e} tol used {used:.3f}")
    print(f"phase 7 main path: {len(calls)} flash_sdpa calls in {wall:.3f} s, launches "
          f"flash_attn {launches} (the f32 3xTF32 kernel {f32_launches}, the bf16 kernel "
          f"{bf16_launches})")
    return f32_launches, bf16_launches, worst


# Phase 8: wkv at rwkv6-3b's width (src/repro/configs/rwkv6_3b.py: d_model
# 2560, head size 64, so H = 40; chunk 128), B = 2, T = 4096
WKV_WIDTH = (2, 4096, 40, 64, 128)   # b, t, h, head size, chunk
def wkv_inputs(dev, shape, u_shape, shift, seed):
    """r, k, v ~ 0.5·N(0,1), lw = -exp(N(0,1) + shift), u ~ 0.1·N(0,1), f32,
    made on the card.  shift -6 is the model's initial decay
    (src/repro/models/rwkv6.py:53); -1 makes the ±30 clamps bite."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (0.5 * torch.randn(shape, generator=g, device=dev) for _ in range(3))
    lw = -torch.exp(torch.randn(shape, generator=g, device=dev) + shift)
    u = 0.1 * torch.randn(u_shape, generator=g, device=dev)
    return r, k, v, lw, u


def phase8_edge_cases(dev):
    """wkv_cuda against wkv_plain at small shapes; the worst (|Δ|, share of
    the tolerance used) in f32 and bf16."""
    from repro_torch.kernels.legacy import wkv_v1
    from repro_torch.kernels.wkv.kernel import wkv_cuda
    from repro_torch.kernels.wkv.ref import wkv_plain
    from repro_torch.testing import wkv_close

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # bh, t, head size, chunk, decay shift, dtype
        (2, 64, 32, 16, -4.0, f32),      # tests/test_wkv_kernel.py:26-31
        (3, 128, 64, 32, -4.0, f32),
        (1, 256, 64, 128, -4.0, f32),
        (2, 128, 16, 128, -4.0, f32),
        (2, 96, 64, 64, -4.0, f32),      # ragged T = 96
        (4, 96, 64, 128, -4.0, f32),     # ragged, one partial chunk
        (3, 256, 64, 32, -1.0, f32),     # strong decay, chunk 32
        (2, 512, 64, 128, -1.0, f32),    # strong decay, chunk 128: clamps at ±30
        (2, 256, 64, 128, -6.0, bf16),
        (2, 200, 32, 64, -1.0, bf16),    # bf16, ragged, strong decay
        (300, 260, 64, 128, -1.0, f32),  # several waves of CTAs for both designs
        (5, 100, 16, 16, -1.0, bf16),    # the smallest head and chunk, ragged
    ]
    worst = {f32: (0.0, 0.0), bf16: (0.0, 0.0)}
    for bh, t, kk, chunk, shift, dtype in cases:
        r, k, v, lw, u = wkv_inputs(dev, (bh, t, kk), (bh, kk), shift, seed=t * kk + chunk)
        r, k, v, lw = (x.to(dtype) for x in (r, k, v, lw))
        got = wkv_cuda(r, k, v, lw, u, chunk=chunk)
        old = wkv_v1(r, k, v, lw, u, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(got, old), ("wkv differs from its first design", bh, t, kk, chunk)
        err, used = wkv_close(got, wkv_plain(r, k, v, lw, u, chunk=chunk))
        worst[dtype] = tuple(map(max, worst[dtype], (err, used)))
        print(f"phase 8 wkv bh={bh} t={t} K={kk} chunk={chunk} shift={shift} "
              f"{str(dtype)[6:]}: bit-identical to the first design, vs plain max|d|={err:.3e} "
              f"tol used {used:.3f}")
    for bh, t, kk, shift, dtype in (   # chunk 8, the reduced configs' (no first design)
            (8, 4096, 16, -6.0, f32), (5, 100, 16, -1.0, bf16), (3, 200, 32, -1.0, f32),
            (3, 200, 64, -4.0, f32), (2, 90, 64, -6.0, bf16)):
        r, k, v, lw, u = wkv_inputs(dev, (bh, t, kk), (bh, kk), shift, seed=t * kk + 8)
        r, k, v, lw = (x.to(dtype) for x in (r, k, v, lw))
        got = wkv_cuda(r, k, v, lw, u, chunk=8)
        torch.cuda.synchronize()
        assert got.shape == r.shape and bool(torch.isfinite(got).all())
        err, used = wkv_close(got, wkv_plain(r, k, v, lw, u, chunk=8))
        worst[dtype] = tuple(map(max, worst[dtype], (err, used)))
        print(f"phase 8 wkv bh={bh} t={t} K={kk} chunk=8 shift={shift} {str(dtype)[6:]}: vs "
              f"plain max|d|={err:.3e} tol used {used:.3f}")
    return worst


def device_ms(fn, reps, part):
    """{kernel: mean device ms a call} of the CUDA kernels whose name holds
    ``part``, from torch.profiler over ``reps`` calls of ``fn``; empty when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        m = re.search(r"(\w*%s\w*)" % part, evt.key)
        if m and total:
            out[m.group(1)] = out.get(m.group(1), 0.0) + total / 1e3 / reps
    return out


def phase8_full_width(dev, name, usage, reset_counts, counters):
    """The kernels against their plain version and their first design at
    rwkv6-3b's width, with timings (the first design in turns), launch
    shapes and each kernel's device time; then B 16; then the op wkv as
    the model calls it, f32 and bf16, against the model's _chunked_wkv
    (f32) and the plain version (bf16)."""
    from repro_torch.kernels.legacy import wkv_v1
    from repro_torch.kernels.wkv.kernel import launch_shapes, wkv_cuda, wkv_flops
    from repro_torch.kernels.wkv.ops import wkv
    from repro_torch.kernels.wkv.ref import wkv_plain
    from repro_torch.models.rwkv6 import _chunked_wkv
    from repro_torch.testing import wkv_close

    b, t, h, kk, chunk = WKV_WIDTH
    r, k, v, lw, u = wkv_inputs(dev, (b, t, h, kk), (h, kk), -6.0, seed=3)
    flat = [x.transpose(1, 2).reshape(b * h, t, kk).contiguous() for x in (r, k, v, lw)]
    uf = u[None].expand(b, h, kk).reshape(b * h, kk).contiguous()
    got = wkv_cuda(*flat, uf, chunk=chunk)
    old = wkv_v1(*flat, uf, chunk=chunk)
    torch.cuda.synchronize()
    v1_same = torch.equal(got, old)
    v1_err = max_abs_err(got, old)
    del old
    want = wkv_plain(*flat, uf, chunk=chunk)
    err, used = wkv_close(got, want)
    out_max = float(want.abs().max())
    turns = [cuda_ms(lambda: fn(*flat, uf, chunk=chunk), reps=10)
             for fn in (wkv_cuda, wkv_v1, wkv_v1, wkv_cuda)]
    ms, v1_ms = turns[0], turns[1]
    plain_ms = cuda_ms(lambda: wkv_plain(*flat, uf, chunk=chunk), reps=3)
    flat16 = [x.bfloat16() for x in flat]
    got16 = wkv_cuda(*flat16, uf, chunk=chunk)
    old16 = wkv_v1(*flat16, uf, chunk=chunk)
    torch.cuda.synchronize()
    v1_same16 = torch.equal(got16, old16)
    err16, used16 = wkv_close(got16, wkv_plain(*flat16, uf, chunk=chunk))
    del got16, old16
    ms16 = cuda_ms(lambda: wkv_cuda(*flat16, uf, chunk=chunk), reps=10)
    v1_ms16 = cuda_ms(lambda: wkv_v1(*flat16, uf, chunk=chunk), reps=10)
    flops = wkv_flops(b * h, t, kk, chunk)
    wkv_bytes = nbytes(*flat, uf, got)
    scratch_bytes = 4 * 4 * b * h * -(-t // chunk) * kk * kk   # U written, read, S written, read
    bound_ms, bound_by = bound(flops, wkv_bytes, name)
    print(f"phase 8 wkv rwkv6-3b: B={b} T={t} H={h} K={kk} chunk={chunk} "
          f"max|d|={err:.3e} tol used {used:.3f} (max|out| {out_max:.3f}); bf16 "
          f"max|d|={err16:.3e} tol used {used16:.3f}; vs the first design bit-identical "
          f"f32 {v1_same} (max|d| {v1_err:.3e}), bf16 {v1_same16}")
    assert v1_same and v1_same16, "wkv differs from its first design"
    for kname, (ctas, threads, smem) in launch_shapes(b * h, t, kk, chunk).items():
        part = kname if kname == "wkv_carry_kernel" else f"{kname}ILi{chunk}ELi{kk}Ef"
        print(f"  {kname}: {ctas} CTAs of {threads} threads, {smem} B dynamic shared memory, "
              f"{usage_of(usage, part)} (f32)")
    print(f"  first design: {b * h} CTAs of 256 threads, "
          f"{usage_of(usage, f'wkv_kernelILi{chunk}ELi{kk}Ef')} (f32)")
    per_kernel = device_ms(lambda: wkv_cuda(*flat, uf, chunk=chunk), 5, "wkv_")
    print("  device ms a call (torch.profiler): " + (", ".join(
        f"{key} {val:.4f}" for key, val in sorted(per_kernel.items())) or "not measured"))
    print(f"  wkv kernels {ms:.3f} ms/call (bf16 {ms16:.3f} ms), first design {v1_ms:.3f} ms "
          f"(bf16 {v1_ms16:.3f} ms), in turns {'; '.join(f'{x:.3f}' for x in turns)}; plain "
          f"{plain_ms:.3f} ms, no library call, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops:.3e} flop, {wkv_bytes:.3e} B; scratch {scratch_bytes:.3e} B more), "
          f"{flops / ms / 1e9:.2f} TFLOP/s (first design {flops / v1_ms / 1e9:.2f})")
    del want, got, flat16

    # B 16: the first design fills the card (640 CTAs); the gain is then the per-SM rate
    b16 = 16
    f16 = wkv_inputs(dev, (b16 * h, t, kk), (b16 * h, kk), -6.0, seed=16)
    got = wkv_cuda(*f16, chunk=chunk)
    old = wkv_v1(*f16, chunk=chunk)
    torch.cuda.synchronize()
    same16 = torch.equal(got, old)
    del got, old
    turns16 = [cuda_ms(lambda: fn(*f16, chunk=chunk), reps=3)
               for fn in (wkv_cuda, wkv_v1, wkv_v1, wkv_cuda)]
    flops16 = wkv_flops(b16 * h, t, kk, chunk)
    print(f"phase 8 wkv rwkv6-3b B={b16} (BH {b16 * h}): bit-identical to the first design "
          f"{same16}; in turns (kernels, first design, first design, kernels) "
          f"{'; '.join(f'{x:.3f}' for x in turns16)} ms/call; {flops16 / turns16[0] / 1e9:.2f} "
          f"TFLOP/s against {flops16 / turns16[1] / 1e9:.2f}")
    assert same16, "wkv differs from its first design at B 16"
    del f16

    reset_counts()
    t0 = time.perf_counter()
    out32 = wkv(r, k, v, lw, u, chunk=chunk)
    out16 = wkv(*(x.bfloat16() for x in (r, k, v, lw)), u, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wkv_cuda.launches
    assert launches == 2, launches
    assert all(fn.launches == 0 for fn in counters if fn is not wkv_cuda)
    for out, dtype in ((out32, torch.float32), (out16, torch.bfloat16)):
        assert out.shape == (b, t, h, kk) and out.dtype == dtype
        assert bool(torch.isfinite(out).all())
    op_err, op_used = wkv_close(out32, _chunked_wkv(r, k, v, lw, u, chunk=chunk))
    flat16 = [x.bfloat16() for x in flat]
    want16 = wkv_plain(*flat16, uf, chunk=chunk).reshape(b, h, t, kk).transpose(1, 2)
    op_err16, op_used16 = wkv_close(out16, want16)
    print(f"phase 8 wkv op rwkv6-3b: f32 vs _chunked_wkv max|d|={op_err:.3e} tol used "
          f"{op_used:.3f}, bf16 vs plain max|d|={op_err16:.3e} tol used {op_used16:.3f}")
    print(f"phase 8 main path: 2 wkv calls in {wall:.3f} s, launches wkv {launches}")
    return dict(launches=launches, max_abs_err=max(err, op_err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None), (
                    max(err16, op_err16), max(used, op_used), max(used16, op_used16))


# Phase 9: the paper's three drivers (BF, IIB without the fused kernel,
# IIIB with its masked superset index) through SparseKNNIndex and knn_join
# at synthetic-10k, then at the yeast-worm config's widths
# (src/repro/configs/paper_knn.py:22: dim 20,000, 80 peaks a row) cut to
# n_s = 20,480 and n_r = 2,048
DRIVERS = ("bf", "iib", "iiib")
SPECTRA = (2048, 20_480, 20_000, 80)   # n_r, n_s, dim, peaks a row
QUERIES = 3


KERNEL_GROUPS = (  # (group, pattern in the CUDA kernel's name), first match wins
    ("topk_merge", r"topk_merge"),
    ("fp32 products (cuBLAS)", r"gemm|Gemm|cutlass"),
    ("index_add_", r"indexFunc|index_add"),
    ("scatter/gather (densify, masks)", r"scatter|gather|index_put|indexing|Index"),
    ("scans (cumsum)", r"scan|cumsum"),
    ("reductions", r"reduce"),
    ("elementwise (where, add, fill, copy)", r"elementwise|vectorized|fill|copy|Copy|where"),
)


def device_profile(fn, kernel_groups=KERNEL_GROUPS):
    """(device busy ms, {group: (ms, kernels)}) of one call of ``fn`` from
    torch.profiler: each CUDA kernel's time, grouped by name (``kernel_groups``,
    else "other").  One stream, so busy = the kernels' sum."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups, busy = {}, 0.0
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if not total:
            continue
        group = next((g for g, pat in kernel_groups if re.search(pat, evt.key)), "other")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + total / 1e3, n + evt.count)
        busy += total / 1e3
    return busy, groups


def print_profile(label, wall_s, busy, groups):
    parts = "; ".join(f"{g} {ms:.2f} ms ({n} kernels)"
                      for g, (ms, n) in sorted(groups.items(), key=lambda x: -x[1][0]))
    idle = 1.0 - busy / (wall_s * 1e3) if wall_s > 0 else float("nan")
    print(f"  {label} profile: device busy {busy:.2f} ms of the median query's "
          f"{wall_s * 1e3:.2f} ms (idle share {idle:.3f}): {parts}")


def kept_share(index, stats, r_blocks):
    """IIIB's kept list entries over the superset's, for one query."""
    return stats.list_entries / (r_blocks * sum(b.list_total for b in index._blocks))


def phase9_cached(dev, R, S, rows, o_s, o_i, fused, reset_counts):
    """Each driver cached: build, then QUERIES queries of all of R, every
    count read from 0 around each query.  Returns ({algorithm: (index,
    last result)}, topk_merge launches, {algorithm: median query s})."""
    from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.testing import assert_topk_close

    n_r = R.num_vectors
    r_blocks, s_blocks = -(-n_r // BLOCK), -(-S.num_vectors // BLOCK)
    out, launches, medians = {}, 0, {}
    for alg in DRIVERS:
        spec = JoinSpec(k=K, algorithm=alg, r_block=BLOCK, s_block=BLOCK, tile=TILE)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = SparseKNNIndex.build(S, spec)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() - before
        peak = torch.cuda.max_memory_allocated()
        results, times = [], []
        for _ in range(QUERIES):
            stats = JoinStats()
            reset_counts()
            t0 = time.perf_counter()
            res = index.query(R, stats=stats)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            merges = topk_merge_cuda.launches
            launches += merges
            assert merges == r_blocks * s_blocks, (alg, merges)
            assert stats.device_dispatches == stats.host_syncs == r_blocks, (alg, stats)
            results.append(res)
        assert index.stats.index_builds == (0 if alg == "bf" else s_blocks), index.stats
        profile = device_profile(lambda: index.query(R))
        last = results[-1]
        for res in results[:-1]:
            assert torch.equal(res.scores, last.scores) and torch.equal(res.ids, last.ids), alg
        assert last.scores.shape == (n_r, K) and bool(torch.isfinite(last.scores).all())
        o_err = assert_topk_close(last.scores.cpu().numpy()[rows], last.ids.cpu().numpy()[rows],
                                  o_s, o_i, RTOL, ATOL)
        line = (f"phase 9 {alg} cached: build {build_s:.3f} s (holds {held / 2**20:.1f} MiB, "
                f"peak allocated {peak / 2**20:.1f} MiB), queries "
                f"{'; '.join(f'{t:.4f}' for t in times)} s (median "
                f"{float(np.median(times)):.4f}), per query dispatches "
                f"{stats.device_dispatches} host syncs {stats.host_syncs} topk_merge launches "
                f"{merges}, tiles_scored {stats.tiles_scored}, list_entries "
                f"{stats.list_entries}, dense_pairs {stats.dense_pairs}; 256 rows vs float64 "
                f"scipy max|dscore|={o_err:.3e}")
        if fused is not None:
            f_err = assert_topk_close(last.scores.cpu(), last.ids.cpu(), fused.scores.cpu(),
                                      fused.ids.cpu(), RTOL, ATOL)
            line += f", all rows vs the fused path max|dscore|={f_err:.3e}"
        print(line)
        print_profile(alg, float(np.median(times)), *profile)
        if alg == "iiib":
            print(f"  iiib kept share {kept_share(index, stats, r_blocks):.4f} of the superset's "
                  f"{sum(b.list_total for b in index._blocks)} entries per R block")
            for i, trace in enumerate(stats.min_prune_trace):
                print(f"  iiib R block {i} threshold trace {np.round(trace, 6).tolist()}")
        out[alg] = (index, last)
        medians[alg] = float(np.median(times))
    return out, launches, medians


def phase9_drivers(dev, name, R, S, rows, o_s, o_i, fused, reset_counts):
    """Phase 9 (see the module docstring).  Returns (topk_merge launches on
    the counted runs, the drivers' merge case: max |Δ|, ms, plain ms,
    bound ms and what bounds it, {algorithm: its cached query of R},
    {algorithm: its median cached query s})."""
    from repro_torch.core import iiib as iiib_mod
    from repro_torch.core.blocknl import knn_join
    from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import topk_merge_plain
    from repro_torch.sparse.datagen import spectra_like
    from repro_torch.testing import assert_topk_close

    s_blocks = -(-S.num_vectors // BLOCK)
    cached, launches, medians = phase9_cached(dev, R, S, rows, o_s, o_i, fused, reset_counts)

    # streaming: knn_join of the first R block, per algorithm and by default
    head = R.rows(0, BLOCK)
    for alg in DRIVERS + (None,):
        kw = {} if alg is None else {"algorithm": alg}
        stats = JoinStats()
        reset_counts()
        t0 = time.perf_counter()
        out = knn_join(head, S, K, r_block=BLOCK, s_block=BLOCK, tile=TILE, stats=stats, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        merges = topk_merge_cuda.launches
        launches += merges
        want = cached[alg or "iiib"][1]
        assert merges == s_blocks, (alg, merges)
        assert stats.device_dispatches == s_blocks * (1 if alg == "bf" else 2), (alg, stats)
        assert stats.index_builds == (0 if alg == "bf" else s_blocks), (alg, stats)
        assert torch.equal(out.scores, want.scores[:BLOCK]), alg
        assert torch.equal(out.ids, want.ids[:BLOCK]), alg
        print(f"phase 9 {alg or 'default (iiib)'} streaming: knn_join of {BLOCK} rows in "
              f"{wall:.4f} s, dispatches {stats.device_dispatches} host syncs "
              f"{stats.host_syncs} index builds {stats.index_builds} topk_merge launches "
              f"{merges}; bit-identical to the cached rows")

    # warm start: a 5% sample of S seeds IIIB's threshold
    iiib_index, iiib_res = cached["iiib"]
    ws_spec = JoinSpec(k=K, algorithm="iiib", r_block=BLOCK, s_block=BLOCK, tile=TILE,
                       warm_start=0.05)
    ws_index = SparseKNNIndex.build(S, ws_spec)
    cold, warm = JoinStats(), JoinStats()
    iiib_index.query(R, stats=cold)
    reset_counts()
    t0 = time.perf_counter()
    ws_res = ws_index.query(R, stats=warm)
    torch.cuda.synchronize()
    ws_s = time.perf_counter() - t0
    r_blocks = -(-R.num_vectors // BLOCK)
    merges = topk_merge_cuda.launches
    launches += merges
    assert merges == r_blocks * (s_blocks + 1), merges
    ws_err = assert_topk_close(ws_res.scores.cpu(), ws_res.ids.cpu(), iiib_res.scores.cpu(),
                               iiib_res.ids.cpu(), RTOL, ATOL)
    assert warm.list_entries <= cold.list_entries, (warm.list_entries, cold.list_entries)
    print(f"phase 9 iiib warm_start 0.05: query {ws_s:.4f} s, topk_merge launches {merges}, "
          f"kept entries {warm.list_entries} (cold {cold.list_entries}; share "
          f"{kept_share(ws_index, warm, r_blocks):.4f}), vs cached iiib max|dscore|={ws_err:.3e}, "
          f"first trace {np.round(warm.min_prune_trace[0], 6).tolist()}")

    # spectra: the yeast-worm config's widths, cut in rows
    n_r, n_s, dim, peaks_mean = SPECTRA
    t0 = time.perf_counter()
    sR = spectra_like(n_r, dim=dim, peaks_mean=peaks_mean, seed=0)
    sS = spectra_like(n_s, dim=dim, peaks_mean=peaks_mean, seed=1)
    print(f"data: spectra R {n_r} x S {n_s} at dim {dim} (features a row: R "
          f"{float(sR.nnz.double().mean()):.1f}, S {float(sS.nnz.double().mean()):.1f}) "
          f"generated in {time.perf_counter() - t0:.2f} s")
    s_rows = np.sort(np.random.default_rng(1).choice(n_r, size=256, replace=False))
    so_s, so_i = scipy_topk(sR, sS, s_rows, K)
    spectra, spectra_launches, _ = phase9_cached(dev, sR, sS, s_rows, so_s, so_i, None,
                                              reset_counts)
    launches += spectra_launches
    for alg in DRIVERS[1:]:
        assert_topk_close(spectra[alg][1].scores.cpu(), spectra[alg][1].ids.cpu(),
                          spectra["bf"][1].scores.cpu(), spectra["bf"][1].ids.cpu(), RTOL, ATOL)
    del spectra, sR, sS

    # the kernel at the drivers' shapes: the offers of IIIB's last block
    # step for R block 0, mostly -inf, against the plain version
    captured = []
    real_step = iiib_mod.merge_step

    def capture(state, scores, ids):
        captured.append((state.scores.clone(), state.ids.clone(), scores.clone(), ids.clone()))
        return real_step(state, scores, ids)

    iiib_mod.merge_step = capture
    try:
        iiib_index.query(head)
    finally:
        iiib_mod.merge_step = real_step
    m_args = captured[-1]
    offered = float(torch.isfinite(m_args[2]).double().mean())
    got, want = topk_merge_cuda(*m_args), topk_merge_plain(*m_args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err = max_abs_err(got[0], want[0])
    turns = [cuda_ms(lambda: fn(*m_args), reps=20)
             for fn in (topk_merge_plain, topk_merge_cuda, topk_merge_cuda, topk_merge_plain)]
    m_bytes = nbytes(*m_args, *got)
    m_bound, m_by = bound(m_args[2].numel() * 1.0, m_bytes, name)
    print(f"phase 9 topk_merge at the drivers' shapes: N={m_args[2].shape[0]} "
          f"M={m_args[2].shape[1]} k={K}, {offered:.4f} of the offers finite, bit-identical to "
          f"the plain version; in turns (plain, kernel, kernel, plain) "
          f"{'; '.join(f'{x:.4f}' for x in turns)} ms, bound {m_bound:.4f} ms ({m_by})")
    return launches, (err, turns[1], turns[0], m_bound, m_by), {
        alg: res for alg, (_, res) in cached.items()}, medians


# phase 10: the datastore's lifecycle and the approx tier at synthetic-10k
# widths (src/repro/configs/paper_knn.py:21), through the entry points a
# user calls.  Lifecycle: built on S's first 8,000 rows, extended to all
# 10,000, then 500 seeded deletes, 256 rows with a TTL expired, compact and
# (IIIB) refreeze.  Approx: the planted workload of the recall contract
# (benchmarks/common.py gen_clustered) at synthetic-10k's widths, 1,250
# clusters x 8 rows; R blocks of 16 probes, so the candidate mask (a union
# over an R block's rows) filters (the reference's tests use 4).
PATHS = (("bf", False), ("iib", False), ("iib", True), ("iiib", False))
N_BUILT, N_DELETED, N_TTL = 8000, 500, 256
APPROX = (1250, 8, 0)          # clusters, rows a cluster, seed
APPROX_R_BLOCK = 16
# the bands are planned for the similarity of the neighbours to recall: at
# 120 features a row the planted neighbours' cosine is 0.69-0.91 (5th
# percentile 0.76), below the planner's default threshold of 0.9, with
# which the tier recalls 0.67 of them (printed as well, for BF)
APPROX_SIM = 0.75
APPROX_HEAD = 64               # R rows of the card's streaming check
APPROX_CPU_ROWS = 16           # R rows (one block) held against the CPU path


def path_name(alg, kernel):
    return "iib+kernel" if kernel else alg


def rows_of(batch, rows):
    """The batch's rows ``rows`` (host index array) as a new batch."""
    from repro_torch.sparse.format import from_arrays

    return from_arrays(batch.indices.numpy()[rows], batch.values.numpy()[rows],
                       batch.nnz.numpy()[rows], batch.dim)


def timed(fn):
    """(result, seconds) of ``fn()`` ending in torch.cuda.synchronize()."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def launches_of(counter, fn, reset_counts):
    """(result, seconds, launches of ``counter``): the counts set to 0 just
    before ``fn`` and read just after."""
    reset_counts()
    out, secs = timed(fn)
    return out, secs, counter.launches


def phase10_lifecycle_path(R, S, alg, kernel, fresh_full, dead, reset_counts):
    """One path's lifecycle at synthetic-10k, cached, then the same sequence
    streaming on the first R block.  Returns (the main path's launches of
    its kernel, the printed timings, the compacted index for the kernel
    checks)."""
    from repro_torch.core import iiib as iiib_mod
    from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.testing import assert_topk_close

    name = path_name(alg, kernel)
    counter = knn_topk_fused if kernel else topk_merge_cuda
    spec = JoinSpec(k=K, algorithm=alg, r_block=BLOCK, s_block=BLOCK, tile=TILE,
                    use_kernel=kernel)
    # IIIB keeps the rank it was built with: give the 8,000-row build the
    # full S's (as a sharded store passes the global one), so the extended
    # index is the 10,000-row build bit for bit
    rank = None
    if alg == "iiib":
        idx = S.indices.numpy()
        rank = iiib_mod.s_frequency_rank(np.bincount(idx[idx < DIM], minlength=DIM))
    keep = np.setdiff1d(np.arange(N_S), dead)
    n_r, r_blocks = R.num_vectors, -(-R.num_vectors // BLOCK)
    launches, times = 0, {}

    def queries(index, label, want_blocks):
        """Three queries of all of R, each counted; their median time.
        Returns the last result (its stats are the last query's)."""
        nonlocal launches
        secs, last = [], None
        for _ in range(QUERIES):
            res, t, n = launches_of(counter, lambda: index.query(R, stats=JoinStats()),
                                    reset_counts)
            per_query = r_blocks * (1 if kernel else want_blocks)
            assert n == per_query, (name, label, n, per_query)
            launches += n
            if last is not None:
                assert torch.equal(res.scores, last.scores) and torch.equal(res.ids, last.ids)
            last = res
            secs.append(t)
        times[label + " query"] = float(np.median(secs))
        return last

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    index, times["build"] = timed(lambda: SparseKNNIndex.build(S.rows(0, N_BUILT), spec,
                                                                     frozen_rank=rank))
    builds = index.stats.index_builds
    held_built = torch.cuda.memory_allocated() - mem0
    torch.cuda.reset_peak_memory_stats()
    _, times["extend"] = timed(lambda: index.extend(S.rows(N_BUILT, N_S)))
    extend_peak = torch.cuda.max_memory_allocated() - mem0
    tail = -(-N_S // BLOCK) - N_BUILT // BLOCK
    assert index.stats.index_builds - builds == (0 if alg == "bf" or kernel else tail), (
        name, builds, index.stats.index_builds)
    grown = queries(index, "extend", -(-N_S // BLOCK))
    assert torch.equal(grown.scores, fresh_full.scores), name
    assert torch.equal(grown.ids, fresh_full.ids), name

    builds = index.stats.index_builds
    n_dead, times["delete"] = timed(lambda: index.delete(dead))
    assert n_dead == N_DELETED and index.stats.index_builds == builds
    deleted = queries(index, "delete", -(-N_S // BLOCK))
    assert not np.isin(deleted.ids.cpu().numpy(), dead).any(), name
    survivors, times["full build"] = timed(lambda: SparseKNNIndex.build(
        rows_of(S, keep), spec, frozen_rank=rank))
    fresh = survivors.query(R)
    ok = fresh.scores.cpu().numpy() > -np.inf
    assert_topk_close(deleted.scores.cpu().numpy(), np.where(ok, deleted.ids.cpu().numpy(), -1),
                      fresh.scores.cpu().numpy(), np.where(ok, keep[fresh.ids.cpu().numpy()], -1),
                      RTOL, ATOL)
    del survivors

    ttl = synthetic_sparse(N_TTL, dim=DIM, nnz_mean=NNZ_MEAN, seed=3)
    _, times["extend 256 ttl"] = timed(lambda: index.extend(ttl, deadline=50.0))
    expired, times["expire"] = timed(lambda: index.expire(now=50.0))
    assert expired == N_TTL, expired
    n_blocks = index.num_blocks
    after_ttl = queries(index, "expire", n_blocks)
    assert_topk_close(after_ttl.scores.cpu().numpy(), after_ttl.ids.cpu().numpy(),
                      deleted.scores.cpu().numpy(), deleted.ids.cpu().numpy(), RTOL, ATOL)

    removed, times["compact"] = timed(index.compact)
    assert removed == N_DELETED + N_TTL and index.num_vectors == N_S - N_DELETED
    compacted = queries(index, "compact", index.num_blocks)
    assert torch.equal(compacted.scores, fresh.scores), name
    assert torch.equal(compacted.ids, fresh.ids), name
    line = (f"phase 10 lifecycle {name} cached: build of {N_BUILT} rows {times['build']:.3f} s, "
            f"extend by {N_S - N_BUILT} {times['extend']:.3f} s (full build of "
            f"{N_S - N_DELETED} {times['full build']:.3f} s), delete {N_DELETED} "
            f"{times['delete'] * 1e3:.3f} ms, extend {N_TTL} with a TTL "
            f"{times['extend 256 ttl']:.3f} s, expire {times['expire'] * 1e3:.3f} ms, compact "
            f"{times['compact']:.3f} s; median query after extend {times['extend query']:.4f} s, "
            f"delete {times['delete query']:.4f}, expire {times['expire query']:.4f}, compact "
            f"{times['compact query']:.4f}")
    if alg == "iiib":
        share_before = kept_share(index, compacted.stats, r_blocks)
        _, times["refreeze"] = timed(index.refreeze)
        refrozen = queries(index, "refreeze", index.num_blocks)
        assert_topk_close(refrozen.scores.cpu().numpy(), refrozen.ids.cpu().numpy(),
                          compacted.scores.cpu().numpy(), compacted.ids.cpu().numpy(), RTOL, ATOL)
        own_rank = SparseKNNIndex.build(rows_of(S, keep), spec).query(R)
        assert torch.equal(refrozen.scores, own_rank.scores), name
        assert torch.equal(refrozen.ids, own_rank.ids), name
        line += (f", refreeze {times['refreeze']:.3f} s (kept share {share_before:.4f} before, "
                 f"{kept_share(index, refrozen.stats, r_blocks):.4f} after), median query "
                 f"after refreeze {times['refreeze query']:.4f} s")
    torch.cuda.synchronize()
    line += (f"; the index holds {held_built / 2**20:.1f} MiB built, "
             f"{(torch.cuda.memory_allocated() - mem0) / 2**20:.1f} MiB at the end, peak during "
             f"extend {extend_peak / 2**20:.1f} MiB; bit for bit "
             f"the {N_S}-row build after extend and the survivors' build after compact")
    print(line)

    # the same sequence streaming, on the first R block
    head = R.rows(0, BLOCK)
    stream = SparseKNNIndex.build(S.rows(0, N_BUILT), spec, cache_device_blocks=False,
                                  frozen_rank=rank)
    stream.extend(S.rows(N_BUILT, N_S))
    stream.delete(dead)
    stream.extend(ttl, deadline=50.0)
    assert stream.expire(now=50.0) == N_TTL
    stream.compact()
    out, secs, n = launches_of(counter, lambda: stream.query(head), reset_counts)
    assert n == stream.num_blocks, (name, n)
    launches += n
    # the per-pair index has its block's own list width, the cached stack
    # the common one: cuBLAS may pick another product kernel for it
    err = assert_topk_close(out.scores.cpu(), out.ids.cpu(), compacted.scores[:BLOCK].cpu(),
                            compacted.ids[:BLOCK].cpu(), RTOL, ATOL)
    same = torch.equal(out.scores, compacted.scores[:BLOCK]) and torch.equal(
        out.ids, compacted.ids[:BLOCK])
    print(f"phase 10 lifecycle {name} streaming: the same sequence, then a query of {BLOCK} "
          f"rows in {secs:.4f} s ({n} launches); vs the cached rows max|dscore|={err:.3e}, "
          f"bit-identical {same}")
    return launches, index


def phase10_masked_kernels(dev, index, R, reset_counts):
    """The join kernels at the lifecycle's shapes, on the compacted fused
    index: knn_topk against its plain version with the stack's columns
    masked three ways (the tombstone holes of a fresh delete, whole dead
    256-column tiles, every column dead); then a k = 150 query on the same
    datastore with the deletes (the score kernel, the mask and the merge
    kernel) against its k = 5 answer, and the score kernel against its
    plain version on its inputs.  Returns (launches of knn_score and
    topk_merge on the k 150 main-path query, max |Δ| of knn_topk, of
    knn_score)."""
    from repro_torch.core.engine import JoinSpec, SparseKNNIndex
    from repro_torch.kernels.knn_score.kernel import knn_score_cuda
    from repro_torch.kernels.knn_score.ref import knn_score_plain
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.kernels.knn_topk.ref import knn_topk_plain
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.testing import assert_topk_close

    index.delete(np.random.default_rng(11).choice(index.num_vectors, N_DELETED, replace=False))
    br = R.rows(0, BLOCK).to(dev)
    args, kwargs, _ = index.kernel_inputs(br, R.indices[:BLOCK].numpy(), BLOCK)
    holes = args[3]
    tiles_dead = holes.clone()
    for lo in range(256, holes.shape[1] - 256, 1024):
        tiles_dead[0, lo:lo + 512] = 0
    topk_err = 0.0
    for label, valid in (("tombstone holes", holes), ("dead 256-column tiles", tiles_dead),
                         ("all columns dead", torch.zeros_like(holes))):
        a = args[:3] + (valid,) + args[4:]
        got, want = knn_topk_fused(*a, **kwargs), knn_topk_plain(*a, **kwargs)
        torch.cuda.synchronize()
        err = assert_topk_close(got[0].cpu(), got[1].cpu(), want[0].cpu(), want[1].cpu(),
                                RTOL, ATOL)
        np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(), rtol=RTOL,
                                   atol=ATOL)
        dead_ids = a[4][0][(valid[0] == 0) & (a[4][0] >= 0)].cpu().numpy()
        assert not np.isin(got[1].cpu().numpy(), dead_ids).any(), label
        if label == "all columns dead":
            assert torch.equal(got[0], a[5]) and torch.equal(got[1], a[6])
        topk_err = max(topk_err, err)
        print(f"phase 10 knn_topk at the engine's shapes, {label} "
              f"({int((valid[0] == 0).sum())} of {valid.shape[1]} columns masked): "
              f"max|dscore|={err:.3e} against the plain version")

    # k = 150 on the same datastore: the score and merge kernels' route
    dead = np.nonzero(~index._alive)[0]
    S_now = index_batch(index)
    spec = JoinSpec(k=150, algorithm="iib", r_block=BLOCK, s_block=BLOCK, tile=TILE,
                    use_kernel=True)
    big = SparseKNNIndex.build(S_now, spec)
    big.delete(dead)
    reset_counts()
    res, secs = timed(lambda: big.query(R))
    score_launches, merge_launches = knn_score_cuda.launches, topk_merge_cuda.launches
    assert knn_topk_fused.launches == 0 and score_launches > 0 and merge_launches > 0
    small = index.query(R)
    assert_topk_close(res.scores[:, :K].cpu(), res.ids[:, :K].cpu(), small.scores.cpu(),
                      small.ids.cpu(), RTOL, ATOL)
    assert not np.isin(res.ids.cpu().numpy(), dead).any()
    b_args, b_kwargs, _ = big.kernel_inputs(br, R.indices[:BLOCK].numpy(), BLOCK)
    width = b_args[1].shape[1] // 2 // b_kwargs["block_s"] * b_kwargs["block_s"]
    s_args = (b_args[0], b_args[1][:, :width].contiguous(),
              b_args[2][:, : width // b_kwargs["block_s"]].contiguous())
    blk = dict(block_r=b_kwargs["block_r"], block_s=b_kwargs["block_s"])
    sc, sc_plain = knn_score_cuda(*s_args, **blk), knn_score_plain(*s_args, **blk)
    torch.cuda.synchronize()
    torch.testing.assert_close(sc, sc_plain, rtol=RTOL, atol=ATOL)
    score_err = float((sc - sc_plain).abs().max())
    print(f"phase 10 k=150 on the datastore with {len(dead)} deletes: query of {N_R} rows in "
          f"{secs:.3f} s, launches knn_score {score_launches} topk_merge {merge_launches} "
          f"knn_topk 0; its first {K} columns equal the k={K} query; knn_score on its first "
          f"window of columns max|dscore|={score_err:.3e} against the plain version")
    return score_launches, merge_launches, topk_err, score_err


def index_batch(index):
    """An index's rows as a batch (its host mirrors)."""
    from repro_torch.sparse.format import from_arrays

    return from_arrays(index._idx, index._val, index._nnz, index.dim)


def phase10_approx(dev, reset_counts):
    """Each path's approx tier on the planted workload at synthetic-10k
    widths.  Returns (the main path's launches of knn_topk and of
    topk_merge, the topk_merge check on a masked block step: max |Δ|)."""
    from repro_torch.core import lsh
    from repro_torch.core.engine import JoinSpec, JoinStats, SparseKNNIndex
    from repro_torch.kernels.knn_topk.kernel import knn_topk_fused
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import topk_merge_plain
    from repro_torch.core import iib as iib_mod
    from repro_torch.sparse.datagen import gen_clustered
    from repro_torch.testing import assert_topk_close

    n_clusters, per_cluster, seed = APPROX
    (aR, aS), gen_s = timed(lambda: gen_clustered(n_clusters, per_cluster, dim=DIM,
                                                   nnz=NNZ_MEAN, seed=seed))
    r_val, s_val = aR.values.numpy(), aS.values.numpy()
    cos = np.concatenate([  # a probe against its cluster's rows (one support)
        s_val[c * per_cluster:(c + 1) * per_cluster] @ r_val[c]
        / np.linalg.norm(s_val[c * per_cluster:(c + 1) * per_cluster], axis=1)
        / np.linalg.norm(r_val[c]) for c in range(n_clusters)])
    print(f"data: planted workload R {aR.num_vectors} x S {aS.num_vectors} at dim {DIM}, "
          f"{NNZ_MEAN} features a row, generated in {gen_s:.2f} s; a probe's cosine to its "
          f"cluster's rows: min {cos.min():.3f}, 5th percentile {np.percentile(cos, 5):.3f}, "
          f"median {np.median(cos):.3f}")
    cfg = lsh.plan_lsh(0.95, seed=0, sim_threshold=APPROX_SIM)
    default_spec = JoinSpec(k=K, algorithm="bf", r_block=APPROX_R_BLOCK, s_block=BLOCK,
                            tile=TILE, target_recall=0.95)
    default = SparseKNNIndex.build(aS, default_spec)
    d_stats = JoinStats()
    d_res = default.query(aR, stats=d_stats)
    d_recall = lsh.measured_recall(d_res.ids.cpu().numpy(),
                                   default.query(aR, accuracy="exact").ids.cpu().numpy())
    d_cfg = default._lsh.cfg
    print(f"phase 10 approx bf with the default plan ({d_cfg.n_bands} bands x "
          f"{d_cfg.rows_per_band} rows, for cosine >= {d_cfg.sim_threshold}): recall "
          f"{d_recall:.4f}, candidate_fraction {d_stats.candidate_fraction:.5f}; the paths below "
          f"plan for cosine >= {APPROX_SIM}: {cfg.n_bands} bands x {cfg.rows_per_band} rows")
    del default
    n_r = aR.num_vectors
    r_blocks = -(-n_r // APPROX_R_BLOCK)
    s_blocks = -(-aS.num_vectors // BLOCK)
    dead = np.arange(0, aS.num_vectors, 13)
    topk_launches = merge_launches = 0
    merge_err = 0.0
    hashing = [0.0]
    real_keys = lsh.LSHBands.keys_host

    def timed_keys(self, idx, val):
        t0 = time.perf_counter()
        out = real_keys(self, idx, val)
        hashing[0] += time.perf_counter() - t0
        return out

    for alg, kernel in PATHS:
        pname = path_name(alg, kernel)
        spec = JoinSpec(k=K, algorithm=alg, r_block=APPROX_R_BLOCK, s_block=BLOCK, tile=TILE,
                        use_kernel=kernel, target_recall=0.95)
        hashing[0] = 0.0
        lsh.LSHBands.keys_host = timed_keys
        try:
            index, build_s = timed(lambda: SparseKNNIndex.build(aS, spec, lsh_cfg=cfg))
        finally:
            lsh.LSHBands.keys_host = real_keys
        counter = knn_topk_fused if kernel else topk_merge_cuda
        stats = JoinStats()
        res, approx_s, n = launches_of(counter, lambda: index.query(aR, stats=stats),
                                       reset_counts)
        assert n == r_blocks * (1 if kernel else s_blocks), (pname, n)
        if kernel:
            topk_launches += n
        else:
            merge_launches += n
        exact, exact_s = timed(lambda: index.query(aR, accuracy="exact"))
        recall = lsh.measured_recall(res.ids.cpu().numpy(), exact.ids.cpu().numpy())
        stats.recall = recall
        assert recall >= 0.95, (pname, recall)
        assert 0 < stats.candidate_rows and stats.candidate_fraction < 1.0, (pname, stats)

        # the band lookup of one R block (CUDA events)
        rk, rr = index._r_band_keys(aR.indices.numpy(), aR.values.numpy(), aR.nnz.numpy(), 0,
                                    APPROX_R_BLOCK, np.ones(APPROX_R_BLOCK, bool))
        rk, rr = torch.as_tensor(rk, device=dev), torch.as_tensor(rr, device=dev)
        if kernel:
            ks = index._kernel_stack
            s_keys, live = ks.col_keys[0], ks.col_valid[0] != 0
        else:
            s_keys = index._lsh_stack
            live = torch.as_tensor(index._sampled_valid(None), device=dev)
        lookup_ms = cuda_ms(lambda: lsh.candidate_mask(rk, rr, s_keys, live), reps=20)

        # the exact face: bit for bit an exact-built index's (first 256 rows)
        head = aR.rows(0, 256)
        exact_spec = JoinSpec(k=K, algorithm=alg, r_block=APPROX_R_BLOCK, s_block=BLOCK,
                              tile=TILE, use_kernel=kernel)
        plain_exact = SparseKNNIndex.build(aS, exact_spec).query(head)
        assert torch.equal(plain_exact.scores, exact.scores[:256]), pname
        assert torch.equal(plain_exact.ids, exact.ids[:256]), pname

        # streaming on the card, bit for bit the cached rows; the CPU path
        probe = aR.rows(0, APPROX_HEAD)
        streamed = SparseKNNIndex.build(aS, spec, cache_device_blocks=False,
                                        lsh_cfg=cfg).query(probe)
        stream_err = assert_topk_close(streamed.scores.cpu(), streamed.ids.cpu(),
                                       res.scores[:APPROX_HEAD].cpu(),
                                       res.ids[:APPROX_HEAD].cpu(), RTOL, ATOL)
        stream_same = torch.equal(streamed.scores, res.scores[:APPROX_HEAD]) and torch.equal(
            streamed.ids, res.ids[:APPROX_HEAD])
        cpu_stats = JoinStats()
        cpu = SparseKNNIndex.build(aS, spec, cache_device_blocks=False, device="cpu",
                                   lsh_cfg=cfg).query(aR.rows(0, APPROX_CPU_ROWS),
                                                      stats=cpu_stats)
        cpu_err = assert_topk_close(res.scores[:APPROX_CPU_ROWS].cpu(),
                                    res.ids[:APPROX_CPU_ROWS].cpu(), cpu.scores, cpu.ids,
                                    RTOL, ATOL)
        one = JoinStats()
        index.query(aR.rows(0, APPROX_CPU_ROWS), stats=one)
        assert one.candidate_rows == cpu_stats.candidate_rows, (pname, one, cpu_stats)

        # tombstones AND into the candidate mask
        index.delete(dead)
        after = index.query(aR.rows(0, 256))
        assert not np.isin(after.ids.cpu().numpy(), dead).any(), pname
        print(f"phase 10 approx {pname}: build "
              f"{build_s:.3f} s of which key hashing (host) {hashing[0]:.3f} s; band lookup "
              f"{lookup_ms:.4f} ms an R block of {APPROX_R_BLOCK}; approx query {approx_s:.3f} s "
              f"({n} launches), exact query {exact_s:.3f} s; recall {recall:.4f}, "
              f"candidate_fraction {stats.candidate_fraction:.5f} ({stats.candidate_rows} of "
              f"{stats.scanned_rows}); exact face bit for bit an exact build's; streaming "
              f"{APPROX_HEAD} rows max|dscore|={stream_err:.3e} (bit-identical {stream_same}); "
              f"{APPROX_CPU_ROWS} rows vs the CPU path max|dscore|={cpu_err:.3e}; no "
              f"deleted row after {len(dead)} deletes")

        if alg == "iib" and not kernel:
            # topk_merge on a masked block step's offers (tombstoned and
            # non-candidate columns at -inf), against its plain version
            captured = []
            real_step = iib_mod.merge_step

            def capture(state, scores, ids):
                captured.append((state.scores.clone(), state.ids.clone(), scores.clone(),
                                 ids.clone()))
                return real_step(state, scores, ids)

            iib_mod.merge_step = capture
            try:
                index.query(aR.rows(0, APPROX_R_BLOCK))
            finally:
                iib_mod.merge_step = real_step
            # the step with the most offers (the others are mostly -inf)
            m_args = max(captured, key=lambda a: int(torch.isfinite(a[2]).sum()))
            got, want = topk_merge_cuda(*m_args), topk_merge_plain(*m_args)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            merge_err = max_abs_err(got[0], want[0])
            print(f"phase 10 topk_merge on an approx block step's offers (N={m_args[2].shape[0]}"
                  f" M={m_args[2].shape[1]}, {float(torch.isfinite(m_args[2]).double().mean()):.5f}"
                  f" finite): bit-identical to the plain version")
        del index
    return topk_launches, merge_launches, merge_err


def phase10(dev, R, S, fresh, reset_counts):
    """Phase 10 (see the module docstring).  ``fresh``: {path name: the
    10,000-row cached query of phases 2 and 9}.  Returns the main path's
    launches {kernel: n} and the kernels' max |Δ| {kernel: x}."""
    t0 = time.perf_counter()
    dead = np.sort(np.random.default_rng(10).choice(N_S, N_DELETED, replace=False))
    launches = {"knn_topk": 0, "knn_score": 0, "topk_merge": 0}
    errs = {}
    fused_index = None
    for alg, kernel in PATHS:
        n, index = phase10_lifecycle_path(R, S, alg, kernel,
                                          fresh[path_name(alg, kernel)], dead, reset_counts)
        launches["knn_topk" if kernel else "topk_merge"] += n
        if kernel:
            fused_index = index
        del index
    s_n, m_n, errs["knn_topk"], errs["knn_score"] = phase10_masked_kernels(
        dev, fused_index, R, reset_counts)
    launches["knn_score"] += s_n
    launches["topk_merge"] += m_n
    del fused_index
    t_n, m_n, errs["topk_merge"] = phase10_approx(dev, reset_counts)
    launches["knn_topk"] += t_n
    launches["topk_merge"] += m_n
    print(f"phase 10: {time.perf_counter() - t0:.1f} s, main-path launches {launches}")
    return launches, errs


# phase 11: the sharded store on one card (src/repro_torch/store/sharded.py),
# through the entry points a user calls.  (a) synthetic-10k in 4 shards of
# 2,500: at s_block 500 each shard's blocks are the single index's, so the
# two agree bit for bit; at the config's s_block 2,048 each shard walks a
# block of 2,048 rows and one of 452 (8 blocks where one index walks 5).
# (b) 2 replicas x 4 shards through a replica kill, mutations while it is
# dead, resync and the half-open probe; the unreplicated loss semantics;
# every mutation against a fresh store over the same live rows.  (c) the
# yeast-worm config's S (src/repro/configs/paper_knn.py:22: 207,804 rows,
# dim 20,000, 80 peaks a row) in 4 shards, R cut from 35,236 rows to 4,096
# (2 R blocks); IIIB's superset stacks run at the full S only when the
# host can hold 3x them (the host mirror, its padded copy and the shard
# arrays), else at STORE_IIIB_CUT rows.  (d) topk_merge on one tree merge
# and one shard block step, beside its plain version and torch.topk.
STORE_SHARDS = 4
STORE_EQ_BLOCK = 500           # 2,500-row shards in blocks of the single index's
STORE_HEAD = 2048              # R rows of the mutation checks (one R block)
YEAST = (207_804, 20_000, 80)  # yeast-worm's S: rows, dim, peaks a row
YEAST_R = 4096                 # R rows, cut from 35,236
STORE_IIIB_CUT = 49_152        # IIIB's S rows when the host cannot hold the full S's stacks


def host_available_bytes():
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("MemAvailable not in /proc/meminfo")


def device_bytes():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def store_query_counted(store, R, reset_counts, **kw):
    """One store query of R (``kw`` to ``query``) with the counts from 0
    around it: (result, seconds, JoinStats, topk_merge launches), with the
    dispatch shape and the launch count asserted."""
    from repro_torch.core.engine import JoinStats
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda

    stats = JoinStats()
    res, secs, merges = launches_of(topk_merge_cuda, lambda: store.query(R, stats=stats, **kw),
                                    reset_counts)
    r_blocks = -(-R.num_vectors // (store.spec.r_block or BLOCK))
    assert stats.device_dispatches == stats.host_syncs == r_blocks, stats
    # a merge each block step of each shard, and n_shards - 1 in the tree
    want = r_blocks * (store.n_shards * store._num_blocks_stacked + store.n_shards - 1)
    assert merges == want, (merges, want)
    assert res.scores.shape == (R.num_vectors, K) and bool(torch.isfinite(res.scores[:, 0]).all())
    return res, secs, stats, merges


def store_counts(store):
    """The store's StoreStats counters, by name."""
    return {f: getattr(store.stats, f) for f in store.stats._COUNTERS
            if not f.endswith("wall_s")}


def phase11_equal_blocks(R, S, reset_counts):
    """(a) at s_block 500: the 4-shard store and one index, bit for bit.
    Returns the store queries' topk_merge launches."""
    from repro_torch.core.engine import JoinSpec, SparseKNNIndex
    from repro_torch.store import ShardedKNNStore

    launches = 0
    for alg in DRIVERS:
        spec = JoinSpec(k=K, algorithm=alg, r_block=BLOCK, s_block=STORE_EQ_BLOCK, tile=TILE)
        want, single_s = timed(lambda: SparseKNNIndex.build(S, spec).query(R))
        store = ShardedKNNStore.build(S, spec, num_shards=STORE_SHARDS)
        assert store.shard_rows == [N_S // STORE_SHARDS] * STORE_SHARDS
        got, secs, _, merges = store_query_counted(store, R, reset_counts)
        launches += merges
        same = torch.equal(got.scores, want.scores) and torch.equal(got.ids, want.ids)
        print(f"phase 11 {alg} s_block {STORE_EQ_BLOCK}: {STORE_SHARDS} shards x "
              f"{store._num_blocks_stacked} blocks, bit-identical to one index of "
              f"{-(-N_S // STORE_EQ_BLOCK)} blocks {same}; store query {secs:.4f} s, one index "
              f"{single_s:.4f} s (build included), topk_merge launches {merges}")
        assert same, alg
        del store, want, got
    return launches


def phase11_config_blocks(smi, R, S, rows, o_s, o_i, singles, single_s, reset_counts):
    """(a) at the config's s_block: build, QUERIES queries, the counts, the
    times beside phase 9's single index, and the checks.  Returns (topk_merge
    launches, the iib store, {algorithm: (its last query, that query's
    JoinStats, the store's StoreStats after its build)})."""
    from repro_torch.core.engine import JoinSpec
    from repro_torch.store import ShardedKNNStore
    from repro_torch.testing import assert_topk_close

    launches, keep, kept = 0, None, {}
    for alg in DRIVERS:
        spec = JoinSpec(k=K, algorithm=alg, r_block=BLOCK, s_block=BLOCK, tile=TILE)
        torch.cuda.empty_cache()
        before = device_bytes()
        torch.cuda.reset_peak_memory_stats()
        store, build_s = timed(lambda: ShardedKNNStore.build(S, spec, num_shards=STORE_SHARDS))
        held, peak = device_bytes() - before, torch.cuda.max_memory_allocated()
        builds = store.stats.index_builds
        built = store_counts(store)
        assert builds == (0 if alg == "bf" else store.num_blocks), builds
        results, times = [], []
        for _ in range(QUERIES):
            res, secs, stats, merges = store_query_counted(store, R, reset_counts)
            launches += merges
            results.append(res)
            times.append(secs)
        assert store.stats.index_builds == builds, "query-time index build"
        last = results[-1]
        for res in results[:-1]:
            assert torch.equal(res.scores, last.scores) and torch.equal(res.ids, last.ids), alg
        s_err = assert_topk_close(last.scores.cpu(), last.ids.cpu(), singles[alg].scores.cpu(),
                                  singles[alg].ids.cpu(), RTOL, ATOL)
        o_err = assert_topk_close(last.scores.cpu().numpy()[rows], last.ids.cpu().numpy()[rows],
                                  o_s, o_i, RTOL, ATOL)
        med = float(np.median(times))
        print(f"phase 11 {alg} s_block {BLOCK} on {smi}: {STORE_SHARDS} shards x "
              f"{store._num_blocks_stacked} blocks ({store.num_blocks} real), build "
              f"{build_s:.3f} s (holds {held / 2**20:.1f} MiB, peak allocated "
              f"{peak / 2**20:.1f} MiB), queries {'; '.join(f'{t:.4f}' for t in times)} s "
              f"(median {med:.4f}, {med / single_s[alg]:.2f}x phase 9's one index at "
              f"{single_s[alg]:.4f}), per query dispatches {stats.device_dispatches} host syncs "
              f"{stats.host_syncs} topk_merge launches {merges} (= {stats.device_dispatches} x "
              f"({STORE_SHARDS} x {store._num_blocks_stacked} block steps + "
              f"{STORE_SHARDS - 1} tree merges)), index builds {builds} frozen; vs "
              f"phase 9's one index max|dscore|={s_err:.3e}, 256 rows vs float64 scipy "
              f"max|dscore|={o_err:.3e}")
        if alg == "iiib":
            print(f"  iiib per-shard final thresholds, R block 0: "
                  f"{np.round(stats.min_prune_trace[0], 6).tolist()}")
        if alg == "iib":
            keep = store
        kept[alg] = (last, stats, built)
        del store, results
    return launches, keep, kept


def live_rows_batch(store):
    """(the store's live rows in shard order as a batch, their global ids)."""
    from repro_torch.core.engine import _pad_feature_axis
    from repro_torch.sparse.format import from_arrays

    f = max(s._idx.shape[1] for s in store.shards)
    parts = [_pad_feature_axis(s._idx[s._alive], s._val[s._alive], f, store.dim)
             + (s._nnz[s._alive], g[s._alive])
             for s, g in zip(store.shards, store._gids)]
    idx, val, nnz, gids = (np.concatenate(x) for x in zip(*parts))
    return from_arrays(idx, val, nnz, store.dim), gids


def against_fresh(store, R, reset_counts):
    """The store's query of R against a fresh store over its live rows (ids
    mapped back): (max |Δscore|, the mutated store's query seconds,
    topk_merge launches)."""
    from repro_torch.store import ShardedKNNStore
    from repro_torch.testing import assert_topk_close

    got, secs, _, merges = store_query_counted(store, R, reset_counts)
    S_live, gids = live_rows_batch(store)
    fresh = ShardedKNNStore.build(S_live, store.spec, num_shards=store.n_shards)
    want = fresh.query(R)
    w_ids = want.ids.cpu().numpy()
    mapped = np.where(w_ids >= 0, gids[np.maximum(w_ids, 0)], -1)
    err = assert_topk_close(got.scores.cpu().numpy(), got.ids.cpu().numpy(),
                            want.scores.cpu().numpy(), mapped, RTOL, ATOL)
    return err, secs, merges


def phase11_replicas(smi, R, S, reset_counts):
    """(b) replicas, losses and mutations.  Returns topk_merge launches."""
    from repro_torch.core.engine import JoinSpec, SparseKNNIndex
    from repro_torch.runtime.fault import FaultPlan, FaultSpec, ReplicaHealth, ShardLostError
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.store import ShardedKNNStore
    from repro_torch.testing import assert_topk_close

    launches = 0
    head = R.rows(0, STORE_HEAD)
    spec = JoinSpec(k=K, algorithm="iib", r_block=BLOCK, s_block=BLOCK, tile=TILE)
    torch.cuda.empty_cache()
    before = device_bytes()
    store, build_s = timed(lambda: ShardedKNNStore.build(S, spec, num_shards=STORE_SHARDS,
                                                         replicas=2))
    held = device_bytes() - before
    own = all(a.data_ptr() != b.data_ptr()
              for k in store._stacks[0] for a, b in zip(store._stacks[0][k], store._stacks[1][k]))
    assert own and store.verify_replicas()
    clean, _, _, n = store_query_counted(store, R, reset_counts)
    launches += n
    store.fault_plan = FaultPlan([FaultSpec("replica_error", replica=1, at_dispatch=1)])
    killed, kill_s, _, n = store_query_counted(store, R, reset_counts)
    store.fault_plan = None
    launches += n
    same = torch.equal(killed.scores, clean.scores) and torch.equal(killed.ids, clean.ids)
    assert same and store.stats.replica_failovers == 1 and store.dead_replicas == (1,)
    assert killed.missing_shards == () and store.lost_shards == ()
    extra = synthetic_sparse(512, dim=DIM, nnz_mean=NNZ_MEAN, seed=21)
    dead = np.sort(np.random.default_rng(11).choice(N_S, 300, replace=False))
    store.add(extra)
    store.delete(dead)
    dirty = sorted(store._replica_dirty[1])
    assert dirty and store.needs_resync
    while_dead, _, _, n = store_query_counted(store, head, reset_counts)
    launches += n
    (resynced, resync_s) = timed(store.resync_replicas)
    assert resynced == (1,) and store.health.state(1) == ReplicaHealth.HALF_OPEN
    assert store.verify_replicas()
    d1 = store.stats.replica_dispatches.get(1, 0)
    probe, _, _, n = store_query_counted(store, head, reset_counts)
    launches += n
    assert store.stats.replica_dispatches[1] == d1 + 1
    assert store.health.state(1) == ReplicaHealth.LIVE and not store.needs_resync
    assert torch.equal(probe.scores, while_dead.scores) and torch.equal(probe.ids, while_dead.ids)
    assert not np.isin(probe.ids.cpu().numpy(), dead).any()
    print(f"phase 11 replicas (2 x {STORE_SHARDS} shards, iib) on {smi}: build {build_s:.3f} s "
          f"(holds {held / 2**20:.1f} MiB, two tensor sets of their own), a replica_error "
          f"mid-query: bit-identical to the clean query {same}, {kill_s:.4f} s, failovers "
          f"{store.stats.replica_failovers}; add 512 + delete 300 while dead queued shards "
          f"{dirty}; resync {resync_s:.4f} s, verify_replicas True, the half-open probe served "
          f"by replica 1 and bit-identical to replica 0's answer, replica 1 live again; "
          f"replica_dispatches {store.stats.replica_dispatches}")
    del store, clean, killed, while_dead, probe

    # unreplicated: the loss raises, allow_partial serves the survivors
    bf_spec = JoinSpec(k=K, algorithm="bf", r_block=BLOCK, s_block=BLOCK, tile=TILE)
    flat = ShardedKNNStore.build(S, bf_spec, num_shards=STORE_SHARDS)
    flat.fault_plan = FaultPlan([FaultSpec("shard_error", shard=1, at_dispatch=0)])
    try:
        flat.query(head)
        raise AssertionError("an unreplicated shard loss must raise")
    except ShardLostError as e:
        assert e.shard == 1 and flat.lost_shards == (1,)
    partial, _, _, n = store_query_counted(flat, head, reset_counts, allow_partial=True)
    launches += n
    lo, hi = N_S // STORE_SHARDS, 2 * N_S // STORE_SHARDS
    ref = SparseKNNIndex.build(S, bf_spec)
    ref.delete(np.arange(lo, hi))
    want = ref.query(head)
    p_err = assert_topk_close(partial.scores.cpu(), partial.ids.cpu(), want.scores.cpu(),
                              want.ids.cpu(), RTOL, ATOL)
    ids = partial.ids.cpu().numpy()
    assert partial.missing_shards == (1,) and not ((ids >= lo) & (ids < hi)).any()
    print(f"phase 11 unreplicated shard_error: ShardLostError(1) raised; allow_partial "
          f"missing_shards {partial.missing_shards}, no id of shard 1, vs one index with "
          f"shard 1's rows deleted max|dscore|={p_err:.3e}")
    del flat, ref, partial

    # mutations, each against a fresh store over the same live rows
    mspec = JoinSpec(k=K, algorithm="iiib", r_block=BLOCK, s_block=BLOCK, tile=TILE)
    store = ShardedKNNStore.build(S, mspec, num_shards=STORE_SHARDS)
    ttl_rows = synthetic_sparse(256, dim=DIM, nnz_mean=NNZ_MEAN, seed=23)
    steps = (("add 1,000", lambda: store.add(synthetic_sparse(1000, dim=DIM,
                                                              nnz_mean=NNZ_MEAN, seed=22))),
             ("delete 500", lambda: store.delete(np.sort(np.random.default_rng(12).choice(
                 N_S, 500, replace=False)))),
             ("expire 256", lambda: (store.add(ttl_rows, ttl=10.0, now=100.0),
                                     store.expire(now=120.0))),
             ("compact", lambda: store.compact()),
             ("refreeze", lambda: store.refreeze()))
    parts = []
    for label, step in steps:
        _, step_s = timed(step)
        err, q_s, n = against_fresh(store, head, reset_counts)
        launches += n
        parts.append(f"{label} {step_s:.3f} s (query {q_s:.4f} s, vs fresh "
                     f"max|dscore|={err:.3e})")
    assert store.stats.expired == 256 and all(sh.dead_rows == 0 for sh in store.shards)
    print(f"phase 11 iiib mutations on {STORE_SHARDS} shards, each vs a fresh store over the "
          f"live rows: {'; '.join(parts)}; shard_rows {store.shard_rows}")
    del store
    return launches


def phase11_yeast(smi, reset_counts):
    """(c) the store at yeast-worm's S.  Returns (topk_merge launches, the
    BF store and R, which phase 12 saves and recovers)."""
    import gc

    from repro_torch.core import iiib as iiib_mod
    from repro_torch.core.engine import JoinSpec
    from repro_torch.core.index import max_rows_bound
    from repro_torch.sparse.datagen import spectra_like
    from repro_torch.sparse.format import num_tiles
    from repro_torch.store import ShardedKNNStore
    from repro_torch.testing import assert_topk_close

    n_s, dim, peaks_mean = YEAST
    t0 = time.perf_counter()
    S = spectra_like(n_s, dim=dim, peaks_mean=peaks_mean, seed=1)
    R = spectra_like(YEAST_R, dim=dim, peaks_mean=peaks_mean, seed=0)
    rows = np.sort(np.random.default_rng(2).choice(YEAST_R, size=256, replace=False))
    oracle = {n_s: scipy_topk(R, S, rows, K)}
    print(f"data: yeast-worm S {n_s} x dim {dim} (features a row "
          f"{float(S.nnz.double().mean()):.1f}), R {YEAST_R}, and the float64 top-k of 256 rows, "
          f"in {time.perf_counter() - t0:.2f} s")
    # IIIB's host need: 3x its stacks, from the superset width of the first block
    freq = np.bincount(S.indices.numpy()[S.indices.numpy() < dim], minlength=dim)
    rank = iiib_mod.s_frequency_rank(freq)
    width = max_rows_bound(S.rows(0, BLOCK), TILE, rank=rank)
    t1 = num_tiles(dim, TILE) + 1
    shard_blocks = -(-(-(-n_s // STORE_SHARDS)) // BLOCK)
    block_bytes = t1 * width * (TILE + 1) * 4 + BLOCK * (t1 - 1) * 4
    need = 3 * STORE_SHARDS * shard_blocks * block_bytes
    avail = host_available_bytes()
    iiib_rows = n_s if avail >= need else STORE_IIIB_CUT
    print(f"phase 11 yeast-worm host: {avail / 2**30:.1f} GiB available; IIIB's stacks at the "
          f"full S, superset width {width}: {need / 3 / 2**30:.1f} GiB, 3x {need / 2**30:.1f} "
          f"GiB -> IIIB at {iiib_rows} S rows")
    launches, keep = 0, None
    for alg in DRIVERS:
        s_rows = n_s if alg != "iiib" else iiib_rows
        S_alg = S if s_rows == n_s else S.rows(0, s_rows)
        if s_rows not in oracle:
            oracle[s_rows] = scipy_topk(R, S_alg, rows, K)
        spec = JoinSpec(k=K, algorithm=alg, r_block=BLOCK, s_block=BLOCK, tile=TILE)
        gc.collect()
        torch.cuda.empty_cache()
        before = device_bytes()
        torch.cuda.reset_peak_memory_stats()
        store, build_s = timed(lambda: ShardedKNNStore.build(S_alg, spec,
                                                             num_shards=STORE_SHARDS))
        held, peak = device_bytes() - before, torch.cuda.max_memory_allocated()
        res, secs, stats, merges = store_query_counted(store, R, reset_counts)
        launches += merges
        o_err = assert_topk_close(res.scores.cpu().numpy()[rows], res.ids.cpu().numpy()[rows],
                                  *oracle[s_rows], RTOL, ATOL)
        r_blocks = stats.device_dispatches
        print(f"phase 11 yeast-worm {alg} on {smi}: S {s_rows} rows in {STORE_SHARDS} shards x "
              f"{store._num_blocks_stacked} blocks of {BLOCK}, build {build_s:.2f} s (holds "
              f"{held / 2**30:.2f} GiB on the card, peak allocated {peak / 2**30:.2f} GiB), "
              f"query of {YEAST_R} rows {secs:.3f} s ({secs / r_blocks:.3f} s per R block), "
              f"dispatches {stats.device_dispatches} host syncs {stats.host_syncs} topk_merge "
              f"launches {merges}, list_entries {stats.list_entries}; 256 rows vs float64 "
              f"scipy max|dscore|={o_err:.3e}")
        if alg == "bf":
            keep = store
        del store, res
    del S
    gc.collect()
    torch.cuda.empty_cache()
    return launches, (keep, R)


def phase11_merge_timing(name, store, R):
    """(d) topk_merge on one tree merge and on one shard block step of the
    iib store's first R block, bit for bit its plain version, timed in
    turns beside it and beside torch.topk of the concatenation.  Returns
    the largest |Δ|."""
    from repro_torch.core import iib as iib_mod
    from repro_torch.core import topk as topk_mod
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.kernels.topk_merge.ref import topk_merge_plain

    captured = {"tree merge": [], "shard block step": []}
    real_step, real_merge = iib_mod.merge_step, topk_mod.merge_topk_states

    def step(state, scores, ids):
        captured["shard block step"].append((state.scores.clone(), state.ids.clone(),
                                             scores.clone(), ids.clone()))
        return real_step(state, scores, ids)

    def merge(a, b):
        captured["tree merge"].append((a.scores.clone(), a.ids.clone(), b.scores.clone(),
                                       b.ids.clone()))
        return real_merge(a, b)

    iib_mod.merge_step, topk_mod.merge_topk_states = step, merge
    try:
        store.query(R.rows(0, BLOCK))
    finally:
        iib_mod.merge_step, topk_mod.merge_topk_states = real_step, real_merge
    assert len(captured["tree merge"]) == store.n_shards - 1
    worst = 0.0
    for label, calls in captured.items():
        args = calls[0]
        got, want = topk_merge_cuda(*args), topk_merge_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), label
        worst = max(worst, max_abs_err(got[0], want[0]))
        turns = [cuda_ms(lambda: fn(*args), reps=20)
                 for fn in (topk_merge_plain, topk_merge_cuda, topk_merge_cuda, topk_merge_plain)]
        lib_ms = cuda_ms(lambda: torch.topk(torch.cat([args[0], args[2]], 1), K, dim=1), reps=20)
        m_bound, m_by = bound(args[2].numel() * 1.0, nbytes(*args, *got), name)
        print(f"phase 11 topk_merge on a {label}: N={args[2].shape[0]} M={args[2].shape[1]} "
              f"k={K}, {float(torch.isfinite(args[2]).double().mean()):.4f} of the offers "
              f"finite, bit-identical to the plain version; in turns (plain, kernel, kernel, "
              f"plain) {'; '.join(f'{x:.4f}' for x in turns)} ms, cat+topk {lib_ms:.4f} ms, "
              f"bound {m_bound:.4f} ms ({m_by})")
    return worst


def phase11(smi, name, R, S, rows, o_s, o_i, singles, single_s, reset_counts):
    """Phase 11 (see the module docstring).  Returns (topk_merge launches
    of the main-path runs, the largest topk_merge |Δ|, the 4-shard IIB
    store at synthetic-10k, (the yeast-worm BF store, its R), each
    algorithm's 4-shard query at synthetic-10k): phase 12 saves, serves
    and recovers the stores; phase 13 holds its mesh stores to them."""
    t0 = time.perf_counter()
    launches = phase11_equal_blocks(R, S, reset_counts)
    n, iib_store, queries = phase11_config_blocks(smi, R, S, rows, o_s, o_i, singles, single_s,
                                                  reset_counts)
    launches += n
    err = phase11_merge_timing(name, iib_store, R)
    launches += phase11_replicas(smi, R, S, reset_counts)
    n, yeast = phase11_yeast(smi, reset_counts)
    launches += n
    print(f"phase 11: {time.perf_counter() - t0:.1f} s, topk_merge launches on its main-path "
          f"runs {launches}")
    return launches, err, iib_store, yeast, queries


# phase 12: the store's checkpoints and the serving front-end.  (a) durability
# at synthetic-10k (not cut) for IIB (phase 11's store) and IIIB; (b) at
# yeast-worm's S (phase 11's BF store, R one block); (c) a KNNScheduler over
# the 4-shard IIB store serving all 10,000 R rows as seeded requests of 1–64
# rows with k drawn from 1–5, submitted at once; (d) the same stream through
# a shard loss, under both policies.  Checkpoints go to a temporary
# directory on the machine's disk, removed at the end.
CKPT_ADD = 2000                # rows added before the save, CKPT_TTL of them with a TTL
CKPT_TTL = 256
CKPT_DELETE = 500
CKPT_DIRTY_ADD = 64            # the add that lands on one shard before save_dirty
SERVE_ROWS = (1, 64)           # request sizes, inclusive
SERVE_WINDOW_S = 0.002


def step_bytes(step_dir, prev_dir=None):
    """(bytes written, bytes hard-linked from ``prev_dir``, the linked
    leaves' paths) of one committed checkpoint step, counted by inode."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    prev = set()
    if prev_dir is not None:
        prev = {os.stat(os.path.join(prev_dir, n)).st_ino for n in os.listdir(prev_dir)}
    written = os.path.getsize(os.path.join(step_dir, "manifest.json"))
    linked, paths = 0, set()
    for e in leaves:
        st = os.stat(os.path.join(step_dir, e["file"]))
        if st.st_ino in prev:
            linked += st.st_size
            paths.add(e["path"])
        else:
            written += st.st_size
    return written, linked, paths


def same_bits(a, b):
    return torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)


def serve_waves(store, waves, cfg, profile=None, between=None):
    """Serve each wave of (requests, ks), all submitted at once, through one
    KNNScheduler; ``between`` is awaited after each wave but the last.
    Returns ([(answers, seconds)] a wave, [(request ids, assembled batch)],
    the scheduler's own _assemble, its metrics)."""
    import asyncio

    from repro_torch.serve import KNNScheduler

    seen, out = [], []

    async def main():
        async with KNNScheduler(store, cfg, profile=profile) as sched:
            real = sched._assemble

            def assemble(pending):
                batch = real(pending)
                seen.append(([p.rid for p in pending], batch))
                return batch

            sched._assemble = assemble
            for w, (reqs, ks) in enumerate(waves):
                t0 = time.perf_counter()
                answers = await asyncio.gather(*[sched.submit(q, k=k) for q, k in zip(reqs, ks)])
                out.append((answers, time.perf_counter() - t0))
                if between is not None and w + 1 < len(waves):
                    await between()
            return real, sched.metrics

    assemble, metrics = asyncio.run(main())
    return out, seen, assemble, metrics


def check_batch_bits(store, reqs, answers, seen, assemble, rid0):
    """One served batch (the first whose requests all come from the wave at
    ``rid0``), rebuilt with the scheduler's _assemble on the same requests
    and queried directly: bit for bit the de-interleaved answers.  Returns
    the batch's request count."""
    import types

    n_req = len(reqs)
    rids, batch = next((r, b) for r, b in seen if r and rid0 <= r[0] and r[-1] < rid0 + n_req)
    pending = [types.SimpleNamespace(idx=reqs[r - rid0].indices.numpy(),
                                     val=reqs[r - rid0].values.numpy(),
                                     nnz=reqs[r - rid0].nnz.numpy()) for r in rids]
    rebuilt = assemble(pending)
    assert all(torch.equal(getattr(rebuilt, f), getattr(batch, f))
               for f in ("indices", "values", "nnz"))
    direct = store.query(rebuilt)
    off = 0
    for r in rids:
        ids, scores = answers[r - rid0]
        n, k = ids.shape
        assert np.array_equal(ids, direct.ids[off:off + n, :k].cpu().numpy()), r
        assert np.array_equal(scores, direct.scores[off:off + n, :k].cpu().numpy()), r
        off += n
    return len(rids)


def check_against_direct(reqs, answers, direct):
    """Each answer within tolerance of its rows of a direct query of all R
    (ids equal outside tie groups).  Returns the largest |Δscore|."""
    from repro_torch.testing import assert_topk_close

    d_s, d_i = direct.scores.cpu().numpy(), direct.ids.cpu().numpy()
    worst, off = 0.0, 0
    for q, (ids, scores) in zip(reqs, answers):
        n, k = ids.shape
        worst = max(worst, assert_topk_close(scores, ids, d_s[off:off + n, :k],
                                             d_i[off:off + n, :k], RTOL, ATOL))
        off += q.num_vectors
    return worst


def serve_summary(m, wall):
    s = m.summary()
    return (f"{s['requests']['completed']} requests in {wall} s, latency p50 "
            f"{s['latency']['p50_ms']:.2f} ms p99 {s['latency']['p99_ms']:.2f} ms, "
            f"{s['throughput']['rows_per_s']:.0f} rows/s, batches {s['batches']['count']} "
            f"(mean fill {s['batches']['mean_occupancy']:.3f}, mean wall "
            f"{s['batches']['mean_wall_ms']:.2f} ms), failed {s['requests']['failed']}")


def phase12_durability(smi, R, store, root, reset_counts):
    """(a) one algorithm's durability at synthetic-10k.  Returns topk_merge
    launches."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.runtime.fault import corrupt_checkpoint_leaf
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.store import ShardedKNNStore
    from repro_torch.testing import assert_topk_close

    alg = store.algorithm
    d = os.path.join(root, f"synthetic_{alg}")
    launches = 0

    def query(st, rows=R, **kw):
        nonlocal launches
        res, secs, n = launches_of(topk_merge_cuda, lambda: st.query(rows, **kw), reset_counts)
        launches += n
        return res, secs

    t0 = time.perf_counter()
    store.add(synthetic_sparse(CKPT_ADD - CKPT_TTL, dim=DIM, nnz_mean=NNZ_MEAN, seed=31))
    store.add(synthetic_sparse(CKPT_TTL, dim=DIM, nnz_mean=NNZ_MEAN, seed=32), ttl=10.0,
              now=100.0)
    store.delete(np.sort(np.random.default_rng(33).choice(N_S, CKPT_DELETE, replace=False)))
    assert store.expire(now=120.0) == CKPT_TTL
    torch.cuda.synchronize()
    mut_s = time.perf_counter() - t0
    path0, save_s = timed(lambda: store.save(d))
    w0, _, _ = step_bytes(path0)
    ref, ref_s = query(store)

    loaded, load_s = timed(lambda: ShardedKNNStore.load(d))
    builds = loaded.stats.index_builds
    got, got_s = query(loaded)
    assert same_bits(got, ref) and loaded.stats.index_builds == builds, alg
    elastic, el_load_s = timed(lambda: ShardedKNNStore.load(d, num_shards=2))
    el, _ = query(elastic)
    el_err = assert_topk_close(el.scores.cpu(), el.ids.cpu(), ref.scores.cpu(), ref.ids.cpu(),
                               RTOL, ATOL)
    del loaded, elastic, el, got

    target = int(np.argmin(store.shard_rows))
    store.add(synthetic_sparse(CKPT_DIRTY_ADD, dim=DIM, nnz_mean=NNZ_MEAN, seed=34))
    path1, dirty_s = timed(lambda: store.save_dirty(d))
    w1, l1, linked = step_bytes(path1, path0)
    clean = {f"['shard_{i:05d}']['{leaf}']" for i in range(store.n_shards) if i != target
             for leaf in store._LEAVES} | ({"['rank']"} if alg == "iiib" else set())
    assert linked == clean, sorted(linked ^ clean)
    pre, _ = query(store)

    lost_gids = store._gids[1].copy()
    store.mark_lost(1)
    partial, _ = query(store, allow_partial=True)
    assert partial.missing_shards == (1,)
    assert not np.isin(partial.ids.cpu().numpy(), lost_gids).any()
    rec, rec_s = timed(lambda: store.recover(d))
    assert rec == (1,) and store.lost_shards == ()
    back, _ = query(store)
    assert same_bits(back, pre), alg

    with open(os.path.join(path1, "manifest.json")) as f:
        leaves = [e["path"] for e in json.load(f)["leaves"]]
    corrupt_checkpoint_leaf(d, leaf=leaves.index(f"['shard_{target:05d}']['idx']"))
    assert ckpt.latest_step(d) == 0
    store.mark_lost(target)
    fb, fb_s = timed(lambda: store.recover(d))
    assert fb == (target,)
    rolled, _ = query(store)
    assert same_bits(rolled, ref), alg          # the target shard's add rolled back
    mb = 2.0 ** 20
    print(f"phase 12 (a) {alg} synthetic-10k on {smi}: add {CKPT_ADD} ({CKPT_TTL} with a TTL), "
          f"delete {CKPT_DELETE}, expire: {mut_s:.3f} s; save {save_s:.3f} s ({w0 / mb:.1f} MiB "
          f"written, {w0 / mb / save_s:.0f} MiB/s); load at 4 shards {load_s:.3f} s "
          f"({w0 / mb / load_s:.0f} MiB/s), query of {N_R} rows {got_s:.4f} s bit-identical "
          f"to the saved store's ({ref_s:.4f} s), index builds frozen; elastic load at 2 shards "
          f"{el_load_s:.3f} s, max|dscore|={el_err:.3e}; save_dirty after an add of "
          f"{CKPT_DIRTY_ADD} rows to shard {target} {dirty_s:.3f} s ({w1 / mb:.2f} MiB written, "
          f"{l1 / mb:.1f} MiB in {len(linked)} leaves hard-linked); mark_lost(1): allow_partial "
          f"missing_shards {partial.missing_shards}, no id of shard 1; recover {rec_s:.3f} s "
          f"bit-identical to the pre-loss query; leaf ['shard_{target:05d}']['idx'] of step 1 "
          f"corrupted: latest_step 0, recover {fb_s:.3f} s, bit-identical to the step-0 query; "
          f"topk_merge launches {launches}")
    return launches


def phase12_yeast(smi, store, R, root, reset_counts):
    """(b) save, load, mark_lost and recover of the yeast-worm BF store
    (S not cut), each queried with one R block.  Returns topk_merge
    launches."""
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.store import ShardedKNNStore

    d = os.path.join(root, "yeast_bf")
    head = R.rows(0, BLOCK)
    launches = 0

    def query(st):
        nonlocal launches
        res, secs, n = launches_of(topk_merge_cuda, lambda: st.query(head), reset_counts)
        launches += n
        return res, secs

    ref, ref_s = query(store)
    path, save_s = timed(lambda: store.save(d))
    written, _, _ = step_bytes(path)
    loaded, load_s = timed(lambda: ShardedKNNStore.load(d))
    got, got_s = query(loaded)
    assert same_bits(got, ref)
    del loaded, got
    store.mark_lost(2)
    rec, rec_s = timed(lambda: store.recover(d))
    assert rec == (2,)
    back, _ = query(store)
    assert same_bits(back, ref)
    shard_bytes = sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path)) / 4
    mb = 2.0 ** 20
    print(f"phase 12 (b) yeast-worm bf on {smi}: S {store.num_vectors} rows in "
          f"{store.n_shards} shards; save {save_s:.3f} s ({written / mb:.1f} MiB written, "
          f"{written / mb / save_s:.0f} MiB/s); load {load_s:.3f} s ({written / mb / load_s:.0f} "
          f"MiB/s), query of {BLOCK} rows {got_s:.4f} s bit-identical to the saved store's "
          f"({ref_s:.4f} s); mark_lost(2) + recover {rec_s:.3f} s (a shard's ~"
          f"{shard_bytes / mb:.1f} MiB read), bit-identical; topk_merge launches {launches}")
    return launches


def serve_stream(R, seed):
    """All of R as requests of SERVE_ROWS rows in order, each with a k from
    1 to K."""
    rng = np.random.default_rng(seed)
    reqs, ks, r0 = [], [], 0
    while r0 < R.num_vectors:
        n = int(rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1))
        reqs.append(R.rows(r0, min(r0 + n, R.num_vectors)))
        ks.append(int(rng.integers(1, K + 1)))
        r0 += n
    return reqs, ks


def phase12_serving(smi, R, store, root, reset_counts):
    """(c) serving, then (d) shard loss under traffic.  Returns topk_merge
    launches."""
    import asyncio

    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.obs.profile import ProfileCapture
    from repro_torch.runtime.fault import FaultPlan, FaultSpec
    from repro_torch.serve import ServeConfig

    reqs, ks = serve_stream(R, seed=35)
    direct = store.query(R)
    cfg = ServeConfig(r_block=BLOCK, window_s=SERVE_WINDOW_S)
    launches = 0

    # a warm run under ProfileCapture over its first 2 batches
    cap = ProfileCapture(os.path.join(root, "profile"), n_batches=2)
    serve_waves(store, [(reqs, ks)], cfg, profile=cap)
    s = cap.summary()
    assert s["error"] is None and s["done"] and s["batches"] == 2, s
    with open(s["trace"]) as f:
        kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    n_merge = sum("topk_merge" in k for k in kernels)
    assert n_merge > 0, sorted(set(kernels))[:20]

    reset_counts()
    builds = store.stats.index_builds
    out, seen, assemble, m = serve_waves(store, [(reqs, ks)], cfg)
    torch.cuda.synchronize()
    launches += topk_merge_cuda.launches
    (answers, wall), = out
    assert m.failed == 0 and m.completed == len(reqs) and m.query_index_builds == 0
    assert store.stats.index_builds == builds
    err = check_against_direct(reqs, answers, direct)
    n_batch = check_batch_bits(store, reqs, answers, seen, assemble, 0)
    print(f"phase 12 (c) serving on {smi}: KNNScheduler over the {store.n_shards}-shard iib "
          f"store, r_block {BLOCK}, window {SERVE_WINDOW_S * 1e3:.0f} ms, {N_R} R rows as "
          f"{len(reqs)} requests of {SERVE_ROWS[0]}-{SERVE_ROWS[1]} rows, k 1-{K}, submitted at "
          f"once: {serve_summary(m, f'{wall:.3f}')}, query_index_builds {m.query_index_builds}, "
          f"topk_merge launches {topk_merge_cuda.launches}; vs the direct {N_R}-row query "
          f"max|dscore|={err:.3e}; a batch of {n_batch} requests rebuilt with _assemble and "
          f"queried directly: bit-identical; ProfileCapture over 2 batches: "
          f"{len(kernels)} kernels in the trace, {n_merge} topk_merge")

    # (d) shard loss under traffic, on a checkpoint saved first
    d = os.path.join(root, "serve_iib")
    store.save(d)
    lost_gids = store._gids[1].copy()

    async def recovered():
        for _ in range(60_000):
            if not store.lost_shards:
                return
            await asyncio.sleep(0.001)
        raise AssertionError("recovery never completed")

    for partial in (True, False):
        pcfg = ServeConfig(r_block=BLOCK, window_s=SERVE_WINDOW_S, allow_partial=partial,
                           recover=lambda: store.recover(d))
        store.fault_plan = FaultPlan([FaultSpec("shard_error", shard=1, at_dispatch=0)])
        reset_counts()
        waves = [(reqs, ks)] * (2 if partial else 1)
        out, seen, assemble, m = serve_waves(store, waves, pcfg, between=recovered)
        torch.cuda.synchronize()
        store.fault_plan = None
        launches += topk_merge_cuda.launches
        s = m.summary()
        assert m.failed == 0 and m.recoveries == 1 and store.lost_shards == (), s["faults"]
        first, _ = out[0]
        if partial:
            assert first[0].missing_shards == (1,)
            degraded = [a for a in first if a.degraded]
            assert all(a.missing_shards == (1,) for a in degraded)
            assert not any(np.isin(a[0], lost_gids).any() for a in degraded)
            full, full_wall = out[1]
            assert not any(a.degraded for a in full)
            err = check_against_direct(reqs, full, direct)
            n_batch = check_batch_bits(store, reqs, full, seen, assemble, len(reqs))
            what = (f"allow_partial: {len(degraded)} of {len(reqs)} answers of the first wave "
                    f"degraded (missing_shards (1,), no id of shard 1), recovery in the "
                    f"background; the second wave ({full_wall:.3f} s) all full, vs direct "
                    f"max|dscore|={err:.3e}, a batch of {n_batch} requests bit-identical to "
                    f"its assembled batch queried directly")
        else:
            assert not any(a.degraded for a in first)
            err = check_against_direct(reqs, first, direct)
            n_batch = check_batch_bits(store, reqs, first, seen, assemble, 0)
            what = (f"queued behind recovery: every answer full, vs direct "
                    f"max|dscore|={err:.3e}, a batch of {n_batch} requests bit-identical")
        walls = " + ".join(f"{w:.3f}" for _, w in out)
        print(f"phase 12 (d) shard_error on shard 1 at dispatch 0 on {smi}, {what}; "
              f"recoveries {m.recoveries} in {s['faults']['recovery_s']:.3f} s, shard losses "
              f"{m.shard_losses}, degraded {m.degraded}; over {len(out)} wave(s): "
              f"{serve_summary(m, walls)}; topk_merge launches {topk_merge_cuda.launches}")
    return launches


def phase12(smi, R, S, iib_store, yeast, reset_counts):
    """Phase 12 (see the module docstring).  Returns topk_merge launches of
    its main-path runs."""
    import tempfile

    from repro_torch.core.engine import JoinSpec
    from repro_torch.store import ShardedKNNStore

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        launches = phase12_serving(smi, R, iib_store, root, reset_counts)
        launches += phase12_durability(smi, R, iib_store, root, reset_counts)
        spec = JoinSpec(k=K, algorithm="iiib", r_block=BLOCK, s_block=BLOCK, tile=TILE)
        iiib_store = ShardedKNNStore.build(S, spec, num_shards=STORE_SHARDS)
        launches += phase12_durability(smi, R, iiib_store, root, reset_counts)
        del iiib_store
        launches += phase12_yeast(smi, *yeast, root, reset_counts)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s, topk_merge launches on its main-path "
          f"runs {launches}")
    return launches


# phase 13: the multi-device join and the job launcher, through the entry
# points a user calls.  (a) the CLI (launch/join_job.py) at synthetic-10k
# for each driver (--repeat 3) and at yeast-worm widths (--spectra; R and S
# cut to 2,048 x 20,480 as in phase 9), each summary bit for bit a direct
# SparseKNNIndex query of the same data; ``python -m
# repro_torch.launch.join_job`` and examples/torch_quickstart.py as
# subprocesses.  (b) ShardedKNNStore over a mesh of RING entries of one card,
# bit for bit phase 11's num_shards=4 store (synthetic-10k: bf, iib, iiib;
# yeast-worm's full S: bf, one R block of 2,048), and a (2, 2) replica mesh
# through a failover.  (c) the ring join at synthetic-10k on a (RING, 2)
# ('data', 'model') mesh: the ring driver for each driver, dim_axis='model'
# for bf and iib, distributed_join's store route; each against phase 9's
# single index, and against its CPU path at RING_SMALL.  (d) (b) and (c)
# again over distinct cards where the machine has more than one.
RING = 4                                  # ring positions and mesh store shards
RING_SMALL = (300, 600, 2000, 40)         # n_r, n_s, dim, nnz of the CPU-path check
JOIN_FIELDS = ("blocks", "tiles_scored", "list_entries", "dense_pairs", "index_builds",
               "device_dispatches", "host_syncs", "candidate_rows", "scanned_rows")


def run_cli(argv):
    """``join_job.main(argv)`` in this process: its JSON summary."""
    import contextlib
    import io

    from repro_torch.launch import join_job

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert join_job.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def join_counts(stats):
    """A JoinStats' counters and IIIB threshold trace, comparable with ==."""
    return ({f: getattr(stats, f) for f in JOIN_FIELDS},
            [np.asarray(t).tolist() for t in stats.min_prune_trace])


def phase13_cli(smi, root, dev, R, S, singles, reset_counts):
    """(a) Returns topk_merge launches of the CLI's in-process runs."""
    from repro_torch.core.engine import JoinSpec, SparseKNNIndex
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.sparse.datagen import spectra_like

    n_r, n_s, dim, peaks_mean = SPECTRA
    sR = spectra_like(n_r, dim=dim, peaks_mean=peaks_mean, seed=0)
    sS = spectra_like(n_s, dim=dim, peaks_mean=peaks_mean, seed=1)
    blocks = ["--r-block", str(BLOCK), "--s-block", str(BLOCK), "--k", str(K)]
    base = ["--nr", str(N_R), "--ns", str(N_S), "--dim", str(DIM), "--nnz", str(NNZ_MEAN),
            "--repeat", "3"] + blocks
    spectra = ["--spectra", "--nr", str(n_r), "--ns", str(n_s), "--dim", str(dim)] + blocks
    cases = ([(alg, "synthetic-10k", base, 3, R, S) for alg in DRIVERS]
             + [(alg, f"spectra {n_r} x {n_s}", spectra, 1, sR, sS) for alg in DRIVERS])
    launches = 0
    for alg, data, argv, repeat, R_, S_ in cases:
        out, secs, merges = launches_of(topk_merge_cuda,
                                        lambda: run_cli(argv + ["--algorithm", alg]), reset_counts)
        launches += merges
        index = SparseKNNIndex.build(S_, JoinSpec(k=K, algorithm=alg, r_block=BLOCK,
                                                  s_block=BLOCK, tile=TILE))
        direct = index.query(R_)
        mean = float(direct.scores[:, 0].cpu().numpy().mean())
        r_blocks, s_blocks = -(-R_.num_vectors // BLOCK), -(-S_.num_vectors // BLOCK)
        assert out["mean_top1"] == mean, (alg, data, out["mean_top1"], mean)
        assert out["s_blocks"] == index.num_blocks == s_blocks, (out, index.num_blocks)
        assert out["index_builds"] == index.stats.index_builds, (out, index.stats.index_builds)
        assert merges == repeat * r_blocks * s_blocks, (alg, data, merges)
        if data == "synthetic-10k":
            assert torch.equal(direct.scores, singles[alg].scores), alg
            assert torch.equal(direct.ids, singles[alg].ids), alg
        print(f"phase 13 (a) join_job {alg} {data} on {smi}: build {out['build_s']} s, queries "
              f"{out['query_s']} s, wall {out['wall_s']} s (data generation included: "
              f"{secs:.2f} s in all), s_blocks {out['s_blocks']} index_builds "
              f"{out['index_builds']}, mean_top1 {out['mean_top1']!r} bit for bit a direct "
              f"SparseKNNIndex query's, topk_merge launches {merges}")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    for label, cmd in (
            ("python -m repro_torch.launch.join_job --ring",
             [sys.executable, "-m", "repro_torch.launch.join_job", "--nr", str(BLOCK), "--ns",
              str(N_S), "--dim", str(DIM), "--algorithm", "iib", "--ring", "--data-par",
              str(torch.cuda.device_count()), "--device", dev.type]),
            ("examples/torch_quickstart.py",
             [sys.executable, os.path.join(root, "examples", "torch_quickstart.py"), "--device",
              dev.type])):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=root)
        assert proc.returncode == 0, (label, proc.stdout[-2000:], proc.stderr[-4000:])
        last = proc.stdout.strip().splitlines()[-1]
        if label.startswith("python -m"):
            assert set(json.loads(last)) >= {"mean_top1", "shards", "index_builds"}, last
        else:
            assert last == "matches dense oracle: True", last
        print(f"phase 13 (a) {label}: exit 0 in {time.perf_counter() - t0:.1f} s (a process "
              f"of its own), last line {last}")
    del sR, sS
    return launches


def phase13_store(smi, label, devs, R, S, store_queries, yeast, reset_counts):
    """(b) the store over a mesh of ``devs`` (RING entries).  Returns
    topk_merge launches."""
    from repro_torch.core.engine import JoinSpec
    from repro_torch.launch.mesh import make_store_mesh
    from repro_torch.runtime.fault import FaultPlan, FaultSpec
    from repro_torch.store import ShardedKNNStore

    launches = 0
    mesh = make_store_mesh(RING, devices=devs)
    for alg in DRIVERS:
        spec = JoinSpec(k=K, algorithm=alg, r_block=BLOCK, s_block=BLOCK, tile=TILE)
        store, build_s = timed(lambda: ShardedKNNStore.build(S, spec, mesh=mesh))
        want, want_stats, want_built = store_queries[alg]
        assert store_counts(store) == want_built, (store_counts(store), want_built)
        res, secs, stats, merges = store_query_counted(store, R, reset_counts)
        launches += merges
        assert join_counts(stats) == join_counts(want_stats), alg
        same = torch.equal(res.scores, want.scores) and torch.equal(res.ids, want.ids)
        assert same, alg
        print(f"phase 13 (b) {alg} store over the mesh {label} on {smi}: build {build_s:.3f} s, "
              f"query {secs:.4f} s, bit for bit phase 11's num_shards={RING} store with every "
              f"JoinStats and StoreStats counter equal, topk_merge launches {merges}")
        del store, res
    ystore, yR = yeast
    head = yR.rows(0, BLOCK)
    want = ystore.query(head)
    S_y, _ = live_rows_batch(ystore)
    store, build_s = timed(lambda: ShardedKNNStore.build(S_y, ystore.spec, mesh=mesh))
    res, secs, _, merges = store_query_counted(store, head, reset_counts)
    launches += merges
    assert torch.equal(res.scores, want.scores) and torch.equal(res.ids, want.ids)
    print(f"phase 13 (b) bf yeast-worm S ({S_y.num_vectors} rows) over the mesh {label}: build "
          f"{build_s:.3f} s, query of one R block of {BLOCK} {secs:.4f} s, bit for bit phase "
          f"11's store, topk_merge launches {merges}")
    del store, res, S_y

    spec = JoinSpec(k=K, algorithm="iib", r_block=BLOCK, s_block=BLOCK, tile=TILE)
    flat = ShardedKNNStore.build(S, spec, num_shards=2, replicas=2,
                                 device=devs[0]).query(R)
    store = ShardedKNNStore.build(S, spec, mesh=make_store_mesh(2, replicas=2, devices=devs))
    store.fault_plan = FaultPlan([FaultSpec("replica_error", replica=1, at_dispatch=1)])
    killed, kill_s, _, merges = store_query_counted(store, R, reset_counts)
    store.fault_plan = None
    launches += merges
    assert torch.equal(killed.scores, flat.scores) and torch.equal(killed.ids, flat.ids)
    assert store.stats.replica_failovers == 1 and store.dead_replicas == (1,)
    assert store.resync_replicas() == (1,) and store.verify_replicas()
    probe, _, _, merges = store_query_counted(store, R, reset_counts)
    launches += merges
    assert torch.equal(probe.scores, flat.scores) and store.dead_replicas == ()
    print(f"phase 13 (b) iib over the (2, 2) replica mesh {label}: a replica_error mid-query "
          f"failed over ({kill_s:.4f} s) bit for bit the num_shards=2 x replicas=2 store's "
          f"query, resync and verify_replicas, the half-open probe bit for bit; replica "
          f"dispatches {store.stats.replica_dispatches}")
    del store, flat, killed, probe
    return launches


def ring_runs(mesh, R, S):
    """(R's real rows, [(label, algorithm, fn)]): the runs of (c) on ``mesh``."""
    from repro_torch.core.engine import JoinSpec, distributed_join
    from repro_torch.core.ring import _ring_join_impl, pad_to_ring, ring_knn_join

    Rp, nr = pad_to_ring(R, RING)
    Sp, ns = pad_to_ring(S, RING)
    kw = dict(n_r_valid=nr, n_s_valid=ns)
    runs = [(f"_ring_join_impl {alg}", alg,
             lambda alg=alg: _ring_join_impl(Rp, Sp, K, mesh, algorithm=alg, **kw))
            for alg in DRIVERS]
    runs += [(f"ring_knn_join {alg} dim_axis=model", alg,
              lambda alg=alg: ring_knn_join(Rp, Sp, K, mesh, algorithm=alg, dim_axis="model",
                                            **kw))
             for alg in ("bf", "iib")]
    spec = JoinSpec(k=K, algorithm="iiib", r_block=BLOCK, s_block=BLOCK, tile=TILE)
    runs.append(("distributed_join iiib (the store route)", "iiib",
                 lambda: distributed_join(Rp, Sp, spec, mesh, **kw)))
    return nr, runs


def phase13_ring(smi, label, devs, R, S, singles, reset_counts):
    """(c) the ring join over a (RING, 2) mesh of ``devs``.  Returns
    topk_merge launches."""
    from repro_torch.kernels.topk_merge.kernel import topk_merge_cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sparse.datagen import synthetic_sparse
    from repro_torch.testing import assert_topk_close

    mesh = make_host_mesh(RING, 2, devices=devs)
    shard = -(-N_S // RING)
    store_merges = -(-N_R // BLOCK) * (RING * -(-shard // BLOCK) + RING - 1)
    launches = 0
    nr, runs = ring_runs(mesh, R, S)
    for run_label, alg, fn in runs:
        st, secs, merges = launches_of(topk_merge_cuda, fn, reset_counts)
        launches += merges
        assert merges == (store_merges if "store" in run_label else RING * RING), merges
        err = assert_topk_close(st.scores[:nr].cpu(), st.ids[:nr].cpu(), singles[alg].scores.cpu(),
                                singles[alg].ids.cpu(), RTOL, ATOL)
        print(f"phase 13 (c) {run_label} over the ({RING}, 2) mesh {label} on {smi}: "
              f"{secs:.4f} s, topk_merge launches {merges}, vs phase 9's single {alg} index "
              f"max|dscore|={err:.3e}")
    # each against its own CPU path, at a small size
    n_r, n_s, dim, nnz = RING_SMALL
    sR = synthetic_sparse(n_r, dim=dim, nnz_mean=nnz, seed=5)
    sS = synthetic_sparse(n_s, dim=dim, nnz_mean=nnz, seed=6)
    cpu = make_host_mesh(RING, 2, devices="cpu")
    worst = 0.0
    nr, runs = ring_runs(mesh, sR, sS)
    for (_, _, fn), (_, _, cpu_fn) in zip(runs, ring_runs(cpu, sR, sS)[1]):
        got, want = fn(), cpu_fn()
        assert got.scores.device.type == devs[0].type and want.scores.device.type == "cpu"
        worst = max(worst, assert_topk_close(got.scores[:nr].cpu(), got.ids[:nr].cpu(),
                                             want.scores[:nr], want.ids[:nr], RTOL, ATOL))
    print(f"phase 13 (c) every run above at R {n_r} x S {n_s}, dim {dim}, against its CPU path "
          f"(a mesh of CPU entries): max|dscore|={worst:.3e}")
    return launches


def phase13(smi, root, dev, R, S, singles, store_queries, yeast, reset_counts):
    """Phase 13 (see the module docstring) on ``dev`` (cuda:0) and, where
    there are more cards, over distinct ones.  Returns topk_merge launches
    of its main-path runs."""
    t0 = time.perf_counter()
    launches = phase13_cli(smi, root, dev, R, S, singles, reset_counts)
    one = [dev] * (2 * RING)
    launches += phase13_store(smi, f"[{dev}] x {RING}", one[:RING], R, S, store_queries,
                              yeast, reset_counts)
    launches += phase13_ring(smi, f"[{dev}] x {2 * RING}", one, R, S, singles, reset_counts)
    n = torch.cuda.device_count()
    if n >= 2:
        many = [torch.device("cuda", i % n) for i in range(2 * RING)]
        label = "[" + ", ".join(str(d) for d in many) + "]"
        launches += phase13_store(smi, label, many[:RING], R, S, store_queries, yeast,
                                  reset_counts)
        launches += phase13_ring(smi, label, many, R, S, singles, reset_counts)
    else:
        print("phase 13 (d): this machine has one card (torch.cuda.device_count() == 1), so "
              "(b) and (c) ran over meshes that repeat cuda:0 only")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s, topk_merge launches on its main-path "
          f"runs {launches}")
    return launches


# phase 14: the LM serving path at full published width and depth, through
# the entry points a user calls (src/repro_torch/launch/serve.py::Server;
# src/repro/configs/qwen3_06b.py: 28 layers, d 1,024, H 16, KVH 8, hd 128,
# ff 3,072, vocab 151,936, bf16; rwkv6_3b.py: 32 layers, d 2,560, 40 heads
# of 64, ff 8,960, vocab 65,536, chunk 128, bf16), random weights from
# LM_SEED, seeded prompts of LM_PROMPT tokens, a cache of LM_MAX_SEQ.
LM_RUNS = (   # label, arch, dtype, batch (slots), requests, max_new
    ("a", "qwen3-0.6b", "bfloat16", 4, 8, 32),
    ("b", "qwen3-0.6b", "float32", 2, 2, 32),
    ("c", "rwkv6-3b", "bfloat16", 2, 4, 16),
)
LM_PROMPT = 1024
LM_MAX_SEQ = 2048
LM_SEED = 0
# The kernel path's logits against the replay's (the same prefill and
# decode_step calls on the same tokens and weights with kernels=False, on
# the card): |d| <= LM_TOL_FACTOR * sqrt(L) * unit * RMS(the replay's logits
# of that call).  Inside each of the L layers' cores the two routes differ
# by about one rounding of the core's output a step (bf16: unit 2^-8; the
# plain route rounds _sdpa's scores, its probabilities and its output, or
# _chunked_wkv's r e^L and k e^-L, the bf16 kernel its P; f32: unit 1e-5,
# the rtol the f32 kernels are held to), four such steps a core; the
# layers' differences are independent, so about sqrt(L) of them reach the
# final hidden state and, through the unembedding, its logits; a margin of
# 4 over that estimate gives the factor 16.
LM_TOL_FACTOR = 16.0
# the JAX package's serve CLI prints these keys (src/repro/launch/serve.py:463-471)
LM_GROUPS = (  # (group, pattern in the CUDA kernel's name), first match wins
    ("flash_attn", r"flash_attn"),
    ("wkv", r"wkv_"),
    ("products (cuBLAS)", r"gemm|Gemm|cutlass|gemv"),
    ("reductions, norms, softmax", r"reduce|softmax|norm"),
    ("elementwise (casts, adds, rope, activations)", r"elementwise|vectorized|fill|copy|Copy"),
)
SERVE_KEYS = {"arch", "requests", "completed", "decode_steps", "wall_s", "tok_per_s",
              "total_tokens", "tokens_per_request", "latency_ms", "faults"}


def lm_tolerance(cfg, want):
    unit = 2.0 ** -8 if cfg.dtype == "bfloat16" else 1e-5
    rms = float(want.float().pow(2).mean().sqrt())
    return LM_TOL_FACTOR * lm_depth(cfg) ** 0.5 * unit * rms


def lm_depth(cfg):
    """The layers a token's hidden state passes (audio: the encoder's too)."""
    return cfg.num_layers + cfg.num_encoder_layers


class RouteLog:
    """Wraps the port's MoE routing (repro_torch.models.moe.route, which
    moe_ffn calls by name) while it lives.  While ``sink`` is a list, each
    routed layer appends (the experts it chose, sorted, and the router's
    probabilities); while ``forced`` holds one expert choice a layer, each
    layer routes to those experts instead, gated by its own probabilities
    of them (renormalised, as route does).  Test code of this script, not a
    knob of the package."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.sink, self.forced = moe, moe.route, None, None

        def route(p, cfg, xf):
            probs, top_p, top_e = self.orig(p, cfg, xf)
            if self.sink is not None:
                self.sink.append((top_e.sort(-1).values, probs.clone()))
            if self.forced is not None:
                top_e = self.forced.pop(0)
                top_p = probs.gather(-1, top_e)
                top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
            return probs, top_p, top_e

        moe.route = route

    def close(self):
        self.moe.route = self.orig


class F32AttentionCore:
    """While entered, the plain route's attention core
    (repro_torch.models.attention._sdpa, called by name) computes in f32 and
    rounds its output once: another rounding of the same function, the
    measure of how far the model carries one rounding of its attention."""

    def __enter__(self):
        from repro_torch.models import attention

        self.mod, self.orig = attention, attention._sdpa
        attention._sdpa = lambda q, k, v, mask: self.orig(q.float(), k.float(), v.float(),
                                                          mask).to(q.dtype)

    def __exit__(self, *exc):
        self.mod._sdpa = self.orig


# a MoE call's logits are held to MOE_SPREAD_MARGIN x the spread between the
# plain route and the plain route with an f32 attention core (where that is
# above lm_tolerance): at the reference's init (moe_init draws the experts
# at 1/sqrt(E)) each MoE layer's output is ~10^2 the residual's scale and
# nearly quadratic in its input, so a rounding of the first layers' attention
# reaches the logits multiplied layer by layer, which the sqrt(L) of
# lm_tolerance does not count.  The kernel rounds less than the plain route
# (f32 scores), more than the f32 core (bf16 P): its distance from the plain
# route is at most about that spread; 4 is phase 14's margin.
MOE_SPREAD_MARGIN = 4.0


def route_flip(cfg, kernel, plain, alt):
    """None if every layer's plain route chose the experts the kernel route
    chose, for every token; else (layer, the router's logit gap between its
    k-th and (k+1)-th expert at a flipped token, that gap's tolerance) for
    the flip nearest its tolerance.  The tolerance is lm_tolerance's at the
    layer's depth in units of the router logits' spread, or MOE_SPREAD_MARGIN
    x the largest change of a router logit of that layer between the plain
    route and the f32 attention core, if larger: a flip is a near tie the
    routes' rounding may break either way only within it."""
    unit = 2.0 ** -8 if cfg.dtype == "bfloat16" else 1e-5
    k = cfg.num_experts_per_tok
    worst = None
    for layer, ((e_ker, _), (e_pl, p_pl), (_, p_alt)) in enumerate(zip(kernel, plain, alt)):
        differ = (e_ker != e_pl).any(-1)
        if not bool(differ.any()):
            continue
        logp = p_pl.clamp_min(1e-30).log()
        shift = logp - p_alt.clamp_min(1e-30).log()
        spread = float((shift - shift.mean(-1, keepdim=True)).abs().max())
        logp = logp[differ]
        top = logp.sort(-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        tol = torch.clamp(LM_TOL_FACTOR * (layer + 1) ** 0.5 * unit * logp.std(-1),
                          min=MOE_SPREAD_MARGIN * spread)
        i = int(torch.argmax(gap / tol))
        if worst is None or float(gap[i] / tol[i]) > worst[1] / worst[2]:
            worst = (layer, float(gap[i]), float(tol[i]))
    return worst


def lm_serve(smi, dev, phase, label, cfg, batch, prompts, max_new, max_seq, reset_counts,
             counters, profile=True, routes=None):
    """One run of Server on the card (``prompts``: each request's prompt
    length, seeded tokens; vlm and audio on the Server's stub patches and
    frames) and its replay with kernels=False on the same weights, each call
    from the replay's own caches.  With a RouteLog (MoE) the replay runs each
    call from one state three times: with the kernels, then on copies of the
    cache with kernels=False and with kernels=False and an f32 attention
    core, both routed to the experts the kernel route chose, and carries the
    kernel route's caches on.  A layer whose own plain routing differs is a
    flip: counted, its gap held to route_flip's tolerance; the logits are
    held to lm_tolerance or MOE_SPREAD_MARGIN x the two plain routes'
    distance, the larger.  Returns ({counter: launches}, max |d| of the
    logits, the model, each request's tokens)."""
    import collections

    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.wkv.kernel import wkv_cuda
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import model as M
    from repro_torch.testing import attention_calls

    dtype = cfg.dtype
    n_req = len(prompts)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Server(cfg, batch, max_seq, device=dev, seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = nbytes(*srv.params.parameters())
    rng = np.random.default_rng(LM_SEED)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), max_new)
            for i, n in enumerate(prompts)]

    calls = []   # (kind, slot, rid, batch or token, pos, logits of the last position, ms)
    prefill, decode = srv.prefill, srv.decode

    def slot_of(cache):
        return next(i for i, c in enumerate(srv.slot_cache) if c is cache)

    def rec_prefill(params, batch_, cache):
        t = time.perf_counter()
        logits, out = prefill(params, batch_, cache)
        torch.cuda.synchronize()
        rid = sum(c[0] == "prefill" for c in calls)   # admitted in request order
        calls.append(("prefill", slot_of(cache), rid, {k: v.clone() for k, v in batch_.items()},
                      None, logits[0, -1].clone(), (time.perf_counter() - t) * 1e3))
        return logits, out

    def rec_decode(params, token, cache, pos):
        t = time.perf_counter()
        logits, out = decode(params, token, cache, pos)
        torch.cuda.synchronize()
        s = slot_of(cache)
        calls.append(("decode", s, srv.slot_req[s].rid, token.clone(), pos, logits[0, -1].clone(),
                      (time.perf_counter() - t) * 1e3))
        return logits, out

    srv.prefill, srv.decode = rec_prefill, rec_decode
    pending = collections.deque(reqs)
    reset_counts()
    t0 = time.perf_counter()
    while pending or srv.occupancy():
        while pending and srv.admit(pending[0]):
            pending.popleft()
        srv.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn: fn.launches for fn in counters}
    bf16_launches = flash_attention_cuda.bf16_launches
    f32_launches = flash_attention_cuda.f32_mma_launches
    held, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    if cfg.family == "ssm":
        counter, expected = wkv_cuda, n_req * L   # the chunked prefill; decode is exact
        assert launches[wkv_cuda] == expected, (label, launches, expected)
    else:   # a launch an attention core a prefill and a decode step
        counter = flash_attention_cuda
        expected = n_req * (attention_calls(cfg, prefill=True)
                            + (max_new - 1) * attention_calls(cfg, prefill=False))
        got = bf16_launches if dtype == "bfloat16" else f32_launches
        assert launches[flash_attention_cuda] == got == expected, (label, launches, expected)
        assert bf16_launches + f32_launches == expected
    assert all(n == 0 for fn, n in launches.items() if fn is not counter), launches
    assert sorted(r.rid for r in srv.finished) == list(range(n_req))
    assert all(len(r.out) == max_new for r in reqs)
    total = sum(len(r.out) for r in reqs)
    shown = str(prompts[0]) if len(set(prompts)) == 1 else "/".join(map(str, prompts))
    print(f"phase {phase} ({label}) {cfg.name} {dtype} on {smi}: Server(batch={batch}, "
          f"max_seq={max_seq}) built in {init_s:.2f} s ({weights / 2**30:.3f} GiB of "
          f"weights); {n_req} requests of {shown} prompt tokens x max_new {max_new} in "
          f"{wall:.3f} s, {total / wall:.1f} tokens/s, latency {srv.latency_summary()}; device "
          f"memory held {held / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB")
    for r in reqs:
        pre = [c[6] for c in calls if c[0] == "prefill" and c[2] == r.rid]
        dec = [c[6] for c in calls if c[0] == "decode" and c[2] == r.rid]
        print(f"  request {r.rid}: prefill {pre[0]:.2f} ms, decode {np.mean(dec):.2f} ms a token "
              f"({len(dec)} steps), admit->finish {(r.t_finish - r.t_admit) * 1e3:.1f} ms")
    dec_all = [c[6] for c in calls if c[0] == "decode"]
    print(f"  decode steps: median {np.median(dec_all):.2f} ms, mean {np.mean(dec_all):.2f} ms; "
          f"launches flash_attn {launches[flash_attention_cuda]} (bf16 {bf16_launches}, f32 "
          f"3xTF32 {f32_launches}), wkv {launches[wkv_cuda]}")

    # the replay: the same calls, the same weights (shared), kernels=False
    plain = M.LM(cfg, device="meta", kernels=False)
    plain.load_state_dict(srv.params.state_dict(), assign=True)
    caches = [M.make_serve_cache(cfg, 1, max_seq, device=dev) for _ in range(batch)]
    reset_counts()
    t0 = time.perf_counter()
    worst, used, checked, ties, same, rerun = 0.0, 0.0, 0, 0, 0, 0.0
    flips = []

    def call(model, kind, inp, pos, cache):
        if kind == "prefill":
            return M.prefill(model, cfg, inp, cache)
        return M.decode_step(model, cfg, inp, cache, pos)

    def copy(cache):
        return {k: (v.clone() if torch.is_tensor(v) else {n: x.clone() for n, x in v.items()})
                for k, v in cache.items()}

    spread_tols = 0
    for kind, s, rid, inp, pos, got, _ in calls:
        spread = 0.0
        if routes is None:
            want, caches[s] = call(plain, kind, inp, pos, caches[s])
        else:
            snaps = (copy(caches[s]), copy(caches[s]))
            routes.sink = []
            again, caches[s] = call(srv.params, kind, inp, pos, caches[s])
            rerun = max(rerun, float((again[0, -1] - got).abs().max()))
            got, kernel_routes = again[0, -1], routes.sink
            sinks = []
            for snap, core in zip(snaps, (contextlib.nullcontext(), F32AttentionCore())):
                routes.sink, routes.forced = [], [e for e, _ in kernel_routes]
                with core:
                    out, _ = call(plain, kind, inp, pos, snap)
                sinks.append(routes.sink)
                if not sinks[1:]:
                    want = out
                else:
                    spread = float((out[0, -1] - want[0, -1]).abs().max())
            routes.sink = routes.forced = None
            del snaps
            flip = route_flip(cfg, kernel_routes, *sinks)
            if flip is not None:
                layer, gap, gap_tol = flip
                flips.append((kind, rid, pos, layer, gap, gap_tol))
                assert gap <= gap_tol, ("a flip past the rounding", label, kind, rid, pos, flip)
        want = want[0, -1]
        tol = lm_tolerance(cfg, want)
        if MOE_SPREAD_MARGIN * spread > tol:
            tol, spread_tols = MOE_SPREAD_MARGIN * spread, spread_tols + 1
        err = float((got - want).abs().max())
        assert err <= tol, (label, kind, rid, pos, err, tol)
        worst, used = max(worst, err), max(used, err / tol)
        same += int(torch.argmax(got)) == int(torch.argmax(want))
        top2 = torch.topk(want, 2).values
        if float(top2[0] - top2[1]) > 2 * tol:     # no flip within the tolerance
            checked += 1
            assert int(torch.argmax(got)) == int(torch.argmax(want)), (label, rid, pos)
        else:
            ties += 1
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    # the replay launches nothing of its own (MoE: the kernel route's rerun, as the run)
    assert all(fn.launches == (launches[fn] if routes is not None else 0)
               for fn in counters), "the replay's launches"
    # one prefill and one decode step under torch.profiler: the device's busy
    # time beside the call's wall (host clock through a synchronize)
    for what, fn in (("prefill", lambda: prefill(srv.params, calls[0][3], srv.slot_cache[0])),
                     ("decode step", lambda: decode(srv.params, calls[-1][3], srv.slot_cache[0],
                                                    prompts[0] + max_new))) if profile else ():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        busy, groups = device_profile(fn, LM_GROUPS)
        parts = "; ".join(f"{g} {ms:.3f} ms ({n})" for g, (ms, n) in
                          sorted(groups.items(), key=lambda x: -x[1][0]))
        print(f"  {what} profile: device busy {busy:.3f} ms of {step_ms:.3f} ms (idle share "
              f"{1 - busy / step_ms:.3f}): {parts}")
    print(f"  replay with kernels=False ({len(calls)} calls, {replay_s:.2f} s): logits max|d| "
          f"{worst:.3e}, tol used {used:.3f} (tol {LM_TOL_FACTOR} x sqrt({lm_depth(cfg)}) x "
          f"{'2^-8' if dtype == 'bfloat16' else '1e-5'} x RMS"
          + (f", or {MOE_SPREAD_MARGIN} x the plain routes' spread, larger at {spread_tols} "
             "calls" if routes is not None else "")
          + f"); greedy token equal at {checked} calls whose top-two gap exceeds 2 x tol, "
          f"{ties} near ties skipped; equal at {same} of the {len(calls)} calls in all")
    if routes is not None:
        print(f"  MoE routing (each call run again with the kernels, the plain routes routed to "
              f"its experts; the rerun's logits max|d| from the run's {rerun:.3e}): "
              f"{len(flips)} of {len(calls)} calls where the plain route's own choice differs "
              f"in some layer"
              + "".join(f"; {kind} of request {rid}{'' if pos is None else f' at {pos}'}: "
                        f"layer {layer}, router logit gap {gap:.3e} <= tol {gap_tol:.3e}"
                        for kind, rid, pos, layer, gap, gap_tol in flips[:8]))
    params = srv.params
    tokens = [list(r.out) for r in reqs]
    del srv, plain, caches, calls
    torch.cuda.empty_cache()
    return launches, worst, params, tokens


def phase14_kernels(dev, name):
    """The wrappers at the shapes the main path gives them (qwen3-0.6b's
    prefill and one decode step at position 1,055; rwkv6-3b's prefill),
    against their plain versions, timed beside SDPA."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda, visible_pairs
    from repro_torch.kernels.flash_attn.ops import heads_first
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.kernels.wkv.kernel import wkv_cuda, wkv_flops
    from repro_torch.kernels.wkv.ref import wkv_plain
    from repro_torch.testing import flash_close, wkv_close

    errs = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.bfloat16, torch.float32):
        for case, sq, skv, causal in (("prefill", LM_PROMPT, LM_PROMPT, True),
                                      ("decode", 1, LM_PROMPT + 31, False)):
            q, _, _ = flash_qkv(dev, 1, sq, 16, 8, 128, seed=sq)
            _, k, v = flash_qkv(dev, 1, skv, 16, 8, 128, seed=skv + 1)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
            kw = dict(causal=causal, sm_scale=128 ** -0.5)
            got = flash_attention_cuda(qf, kf, vf, **kw)
            err, used = flash_close(got, flash_attention_plain(qf, kf, vf, **kw))
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            ms = cuda_ms(lambda: flash_attention_cuda(qf, kf, vf, **kw), reps=20)
            plain_ms = cuda_ms(lambda: flash_attention_plain(qf, kf, vf, **kw), reps=5)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True),
                                 reps=20)
            flops = 4.0 * 128 * visible_pairs(sq, skv, causal, 0) * 16
            if dtype == torch.bfloat16:
                b_ms, b_by = bound(flops, nbytes(qf, kf, vf, got), name, dtype)
            else:
                b_ms, b_by = bound(3 * flops, nbytes(qf, kf, vf, got), name, "tf32")
            print(f"phase 14 (f) flash_attn {str(dtype)[6:]} qwen3-0.6b {case} (Sq {sq}, Skv "
                  f"{skv}, H 16, KVH 8, hd 128, causal {causal}): max|d| {err:.3e} tol used "
                  f"{used:.3f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                  f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    r, k, v, lw, u = wkv_inputs(dev, (1, LM_PROMPT, 40, 64), (40, 64), -6.0, seed=14)
    flat = [x.transpose(1, 2).reshape(40, LM_PROMPT, 64).contiguous() for x in (r, k, v, lw)]
    got = wkv_cuda(*flat, u.contiguous(), chunk=128)
    err, used = wkv_close(got, wkv_plain(*flat, u, chunk=128))
    errs["wkv"] = err
    ms = cuda_ms(lambda: wkv_cuda(*flat, u.contiguous(), chunk=128), reps=20)
    plain_ms = cuda_ms(lambda: wkv_plain(*flat, u, chunk=128), reps=5)
    b_ms, b_by = bound(wkv_flops(40, LM_PROMPT, 64, 128), nbytes(*flat, u, got), name)
    print(f"phase 14 (f) wkv f32 rwkv6-3b prefill (B·H 40, T {LM_PROMPT}, K 64, chunk 128): "
          f"max|d| {err:.3e} tol used {used:.3f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return errs


def phase14(smi, name, root, dev, reset_counts, counters):
    """Returns ({counter: main-path launches}, {bf16 | f32 | wkv: worst |d| of
    the kernels at the main path's shapes}, {run label: each request's
    tokens})."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.wkv.kernel import wkv_cuda

    t_phase = time.perf_counter()
    launches = {"flash_f32": 0, "flash_bf16": 0, "wkv": 0}
    tokens = {}
    for label, arch, dtype, batch, n_req, max_new in LM_RUNS:
        cfg = dataclasses.replace(get_config(arch), dtype=dtype)
        got, _, params, tokens[label] = lm_serve(smi, dev, 14, label, cfg, batch,
                                                 [LM_PROMPT] * n_req, max_new, LM_MAX_SEQ,
                                                 reset_counts, counters)
        del params
        if arch == "rwkv6-3b":
            launches["wkv"] += got[wkv_cuda]
        else:
            launches["flash_bf16" if dtype == "bfloat16" else "flash_f32"] += \
                got[flash_attention_cuda]
    assert launches == {"flash_f32": 1792, "flash_bf16": 7168, "wkv": 128}, launches
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    for label, cmd in (
            ("(d) python -m repro_torch.launch.serve --arch qwen3-0.6b",
             [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-0.6b"]),
            ("(e) examples/torch_knnlm_serve.py",
             [sys.executable, os.path.join(root, "examples", "torch_knnlm_serve.py")])):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=root)
        assert proc.returncode == 0, (label, proc.stdout[-2000:], proc.stderr[-4000:])
        lines = proc.stdout.strip().splitlines()
        if label.startswith("(d)"):
            out = json.loads(lines[-1])
            assert set(out) == SERVE_KEYS, sorted(out)
            assert out["completed"] == out["requests"] == 8, out
            shown = lines[-1]
        else:
            shown = next(line for line in lines if line.startswith("summary:"))
            assert json.loads(shown[len("summary:"):])["query_index_builds"] == 0, shown
        print(f"phase 14 {label}: exit 0 in {time.perf_counter() - t0:.1f} s (a process of "
              f"its own), {shown}")
    errs = phase14_kernels(dev, name)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s; main-path launches flash_attn f32 "
          f"{launches['flash_f32']}, bf16 {launches['flash_bf16']}, wkv {launches['wkv']}")
    return launches, errs, tokens


# phase 15: the remaining serving families at full published width, through
# the entry points a user calls (src/repro_torch/launch/serve.py::Server),
# random weights from LM_SEED, seeded prompts; every attention (self,
# local, cross, encoder) in flash_attn.  src/repro/configs/: olmoe_1b_7b.py
# (16 layers, d 2,048, H = KVH 16, hd 128, 64 experts of ff 1,024, top 8,
# vocab 50,304); phi35_moe.py (d 4,096, H 32, KVH 8, 16 experts of ff
# 6,400, top 2, vocab 32,064; 32 layers, cut to 4: 84 GB of bf16 weights do
# not fit one 80 GB card); recurrentgemma_2b.py (26 layers: 8 units of
# (rglru, rglru, local attn) and a tail of 2 rglru; d 2,560, H 10, KVH 1,
# hd 256, window 2,048, ff 7,680, vocab 256,000); llama32_vision_11b.py (40
# layers: 8 units of 4 self layers and a gated cross layer onto 1,601 patch
# keys; d 4,096, H 32, KVH 8, ff 14,336, vocab 128,256); whisper_medium.py
# (24 encoder layers over 1,500 frames, 24 decoder layers with self and
# cross attention; d 1,024, H = KVH 16, hd 64, vocab 51,865; 448 = its
# published decoder context).  Cut: request counts and max_new, and
# phi3.5-moe's depth; never a width.
LM15_RUNS = (  # label, arch, dtype, slots, prompt lengths, max_new, max_seq, layers, profile
    ("a", "olmoe-1b-7b", "bfloat16", 4, (1024,) * 4, 16, 2048, None, True),
    ("a'", "olmoe-1b-7b", "float32", 2, (1024,) * 2, 16, 2048, None, False),
    ("b", "phi3.5-moe-42b-a6.6b", "bfloat16", 2, (1024,) * 2, 8, 2048, 4, False),
    # the 3,000-token prefill passes the 2,048 window; its decode wraps the slots
    ("c", "recurrentgemma-2b", "bfloat16", 2, (1024, 3000, 1024), 32, 4096, None, True),
    ("d", "llama-3.2-vision-11b", "bfloat16", 2, (1024,) * 2, 16, 2048, None, False),
    ("e", "whisper-medium", "bfloat16", 4, (256,) * 4, 32, 448, None, False),
)
# flash_attn launches of each run: an attention core a prefill and a decode
# step (testing.attention_calls), requests x (prefill + max_new - 1 steps)
LM15_LAUNCHES = {"a": 4 * 16 * 16, "a'": 2 * 16 * 16, "b": 2 * 8 * 4, "c": 3 * 32 * 8,
                 "d": 2 * 16 * 40, "e": 4 * (72 + 31 * 48)}
# after (d) and (e): one request through prefill and decode_step on seeded
# N(0, 1) stub inputs (vlm: patches, the cross gates at 0.5), replayed the same
# way: (decode steps, flash_attn launches)
LM15_DIRECT = {"d": (15, 16 * 40), "e": (31, 72 + 31 * 48)}
LM15_GATE = 0.5


def phase15_direct(smi, dev, label, cfg, params, prompt, n_steps, max_seq, reset_counts):
    """One request with seeded stub inputs through M.prefill and
    M.decode_step (greedy) on the card, then the same calls on the same
    tokens with kernels=False; (flash_attn launches, max |d| of the logits)."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.models import model as M
    from repro_torch.testing import attention_calls

    g = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    stub = ("patches", cfg.num_patches) if cfg.family == "vlm" else ("frames", cfg.encoder_seq)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(LM_SEED + 1).integers(
                 0, cfg.vocab_size, (1, prompt)).astype(np.int32), device=dev),
             stub[0]: torch.randn((1, stub[1], cfg.d_model), generator=g, device=dev)}
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith(".gate"):
                p.fill_(LM15_GATE)
    plain = M.LM(cfg, device="meta", kernels=False)
    plain.load_state_dict(params.state_dict(), assign=True)
    runs = {}
    for route, model in (("kernels", params), ("plain", plain)):
        reset_counts()
        cache = M.make_serve_cache(cfg, 1, max_seq, device=dev)
        t0 = time.perf_counter()
        logits, cache = M.prefill(model, cfg, batch, cache)
        out, tokens = [logits[0, -1]], runs.get("kernels", (None, []))[1]
        for t in range(n_steps):
            tok = tokens[t] if route == "plain" else int(torch.argmax(out[-1]))
            if route == "kernels":
                tokens.append(tok)
            logits, cache = M.decode_step(model, cfg, torch.tensor([[tok]], device=dev), cache,
                                          prompt + t)
            out.append(logits[0, -1])
        torch.cuda.synchronize()
        runs[route] = (out, tokens, time.perf_counter() - t0, flash_attention_cuda.launches)
    launches = runs["kernels"][3]
    assert launches == attention_calls(cfg, True) + n_steps * attention_calls(cfg, False), launches
    assert runs["plain"][3] == 0
    worst, used = 0.0, 0.0
    for step, (got, want) in enumerate(zip(runs["kernels"][0], runs["plain"][0])):
        tol = lm_tolerance(cfg, want)
        err = float((got - want).abs().max())
        assert err <= tol, (label, "direct", step, err, tol)
        worst, used = max(worst, err), max(used, err / tol)
    print(f"phase 15 ({label}) direct on {smi}: prefill of {prompt} tokens with seeded N(0, 1) "
          f"{stub[0]} ({stub[1]} x {cfg.d_model})"
          + (f", the cross gates at {LM15_GATE}" if cfg.family == "vlm" else "")
          + f", then {n_steps} decode steps: {runs['kernels'][2]:.3f} s, flash_attn launches "
          f"{launches}; replay with kernels=False {runs['plain'][2]:.3f} s: logits max|d| "
          f"{worst:.3e}, tol used {used:.3f}")
    return launches, worst


# flash_attn at the shapes phase 15's main path gives it (B 1): name, Sq, Skv,
# H, KVH, hd, causal, window, dtypes
LM15_FLASH = (
    ("olmoe-1b-7b prefill", 1024, 1024, 16, 16, 128, True, 0, (torch.bfloat16, torch.float32)),
    ("olmoe-1b-7b decode", 1, 1040, 16, 16, 128, False, 0, (torch.bfloat16, torch.float32)),
    ("phi3.5-moe prefill (GQA 32/8)", 1024, 1024, 32, 8, 128, True, 0, (torch.bfloat16,)),
    ("recurrentgemma-2b local prefill", 3000, 3000, 10, 1, 256, True, 2048, (torch.bfloat16,)),
    ("recurrentgemma-2b decode (visible slots)", 1, 2048, 10, 1, 256, False, 0,
     (torch.bfloat16,)),
    ("llama-3.2-vision cross prefill", 1024, 1601, 32, 8, 128, False, 0, (torch.bfloat16,)),
    ("llama-3.2-vision cross decode", 1, 1601, 32, 8, 128, False, 0, (torch.bfloat16,)),
    ("whisper-medium encoder", 1500, 1500, 16, 16, 64, False, 0, (torch.bfloat16,)),
    ("whisper-medium cross decode", 1, 1500, 16, 16, 64, False, 0, (torch.bfloat16,)),
)


def phase15_kernels(dev, name):
    """flash_attention_cuda at phase 15's shapes against its plain version,
    timed beside SDPA and its bound; {dtype: worst |d|}."""
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda, visible_pairs
    from repro_torch.kernels.flash_attn.ops import heads_first
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain
    from repro_torch.testing import flash_close

    errs = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case, sq, skv, h, kvh, hd, causal, window, dtypes in LM15_FLASH:
        for dtype in dtypes:
            q, _, _ = flash_qkv(dev, 1, sq, h, kvh, hd, seed=sq + hd)
            _, k, v = flash_qkv(dev, 1, skv, h, kvh, hd, seed=skv + hd + 1)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
            kw = dict(causal=causal, sm_scale=hd ** -0.5, window=window)
            got = flash_attention_cuda(qf, kf, vf, **kw)
            err, used = flash_close(got, flash_attention_plain(qf, kf, vf, **kw))
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            ms = cuda_ms(lambda: flash_attention_cuda(qf, kf, vf, **kw), reps=20)
            plain_ms = cuda_ms(lambda: flash_attention_plain(qf, kf, vf, **kw), reps=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if window:
                qpos, kpos = torch.arange(sq, device=dev)[:, None], torch.arange(skv, device=dev)
                mask = (kpos <= qpos) & (kpos > qpos - window)
                lib = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
            else:
                lib = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
            library_ms = cuda_ms(lib, reps=10)
            flops = 4.0 * hd * visible_pairs(sq, skv, causal, window) * h
            if dtype == torch.bfloat16:
                b_ms, b_by = bound(flops, nbytes(qf, kf, vf, got), name, dtype)
            else:
                b_ms, b_by = bound(3 * flops, nbytes(qf, kf, vf, got), name, "tf32")
            print(f"phase 15 (g) flash_attn {str(dtype)[6:]} {case} (Sq {sq}, Skv {skv}, H {h}, "
                  f"KVH {kvh}, hd {hd}, causal {causal}, window {window}): max|d| {err:.3e} tol "
                  f"used {used:.3f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                  f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return errs


def phase15(smi, name, root, dev, reset_counts, counters):
    """Returns ({"flash_f32" | "flash_bf16": main-path launches}, {dtype:
    worst |d| of flash_attn at the main path's shapes})."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda

    t_phase = time.perf_counter()
    launches = {"flash_f32": 0, "flash_bf16": 0}
    for label, arch, dtype, batch, prompts, max_new, max_seq, layers, profile in LM15_RUNS:
        cfg = dataclasses.replace(get_config(arch), dtype=dtype)
        if layers is not None:
            print(f"phase 15 ({label}) {arch}: depth cut {cfg.num_layers} -> {layers} layers")
            cfg = dataclasses.replace(cfg, num_layers=layers)
        routes = RouteLog() if cfg.family == "moe" else None
        try:
            got, _, params, _ = lm_serve(smi, dev, 15, label, cfg, batch, list(prompts), max_new,
                                      max_seq, reset_counts, counters, profile=profile,
                                      routes=routes)
        finally:
            if routes is not None:
                routes.close()
        assert got[flash_attention_cuda] == LM15_LAUNCHES[label], (label, got)
        key = "flash_bf16" if dtype == "bfloat16" else "flash_f32"
        launches[key] += got[flash_attention_cuda]
        if label in LM15_DIRECT:
            n_steps, want = LM15_DIRECT[label]
            n, _ = phase15_direct(smi, dev, label, cfg, params, prompts[0], n_steps, max_seq,
                                  reset_counts)
            assert n == want, (label, n, want)
            launches[key] += n
        del params
        torch.cuda.empty_cache()
    assert launches == {"flash_f32": 512, "flash_bf16": 11576}, launches
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "recurrentgemma-2b"], capture_output=True, text=True, timeout=600,
                          env=env, cwd=root)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == SERVE_KEYS, sorted(out)
    assert out["completed"] == out["requests"] == 8, out
    print(f"phase 15 (f) python -m repro_torch.launch.serve --arch recurrentgemma-2b: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s (a process of its own), {proc.stdout.strip()}")
    errs = phase15_kernels(dev, name)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s; main-path launches flash_attn f32 "
          f"{launches['flash_f32']}, bf16 {launches['flash_bf16']}")
    return launches, errs


# phase 16: training on one card
TRAIN_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "rwkv6-3b", "recurrentgemma-2b",
               "llama-3.2-vision-11b", "whisper-medium")
TRAIN_DEPTH = {"vlm": 10, "hybrid": 8}   # two units each, as the parity tests deepen them
TRAIN_SMALL = (3, 2, 32, 16)             # (a): steps, batch, seq, ce_chunk
TRAIN_FULL = ("qwen3-0.6b", 8, 1024, 512, 2, 8)   # (b): arch, batch, seq, ce_chunk, warm-up, timed
TRAIN_GROUPS = (  # (group, pattern in the CUDA kernel's name), first match wins
    ("products (cuBLAS)", r"gemm|Gemm|cutlass|gemv|nvjet|xmma"),
    ("softmax, logsumexp", r"softmax|logsumexp"),
    ("reductions, norms", r"reduce|norm"),
    ("elementwise (casts, adds, AdamW, rope, activations)",
     r"elementwise|vectorized|fill|copy|Copy"),
)


def train_model_flops(cfg, params, batch, seq):
    """Model FLOPs of one train step (forward and backward, 3x the
    forward; remat's recompute not counted): 2 per weight a token for every
    matmul weight (the tied unembedding once more), and the causal
    attention's two products, 2 H hd S a token a layer on average."""
    n = sum(p.numel() for name, p in params.named_parameters()
            if p.dim() >= 2 and name != "embed")
    n += cfg.vocab_size * cfg.d_model                      # the unembedding
    tokens = batch * seq
    attn = 2.0 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim * seq * tokens
    return 3.0 * (2.0 * n * tokens + attn)


def step_profile(fn, n_top=10):
    """(device busy ms, {group: (ms, kernels)} by TRAIN_GROUPS, the n_top
    kernels by device time as (ms, count, name)) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if total:
            rows.append((total / 1e3, evt.count, evt.key))
    groups = {}
    for ms, n, key in rows:
        group = next((g for g, pat in TRAIN_GROUPS if re.search(pat, key)), "other")
        t, c = groups.get(group, (0.0, 0))
        groups[group] = (t + ms, c + n)
    return sum(r[0] for r in rows), groups, sorted(rows, reverse=True)[:n_top]


def phase16_card_vs_cpu(smi, dev, reset_counts, counters):
    """(a) 3 train steps of each family's reduced model (f32, TF32 off) on
    the card and on the CPU from the same weights and batches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import StepOptions, init_train_state
    from repro_torch.testing import train_batches, train_close, train_run

    assert not torch.backends.cuda.matmul.allow_tf32
    steps, b, seq, chunk = TRAIN_SMALL
    worst = {"metrics": 0.0, "params": 0.0}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_DEPTH.get(cfg.family, cfg.num_layers))
        weights = init_train_state(cfg, torch.Generator().manual_seed(5))[0].state_dict()
        batches = train_batches(cfg, steps, b, seq)
        opts = StepOptions(ce_chunk=chunk)
        want = train_run(cfg, weights, "cpu", batches, opts)
        reset_counts()
        t0 = time.perf_counter()
        got = train_run(cfg, weights, dev, batches, opts)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        assert all(fn.launches == 0 for fn in counters), [fn.launches for fn in counters]
        used = train_close(*got, *want)
        worst = {k: max(worst[k], used[k]) for k in worst}
        card_loss = ", ".join("%.6f" % m["loss"] for m in got[1])
        cpu_loss = ", ".join("%.6f" % m["loss"] for m in want[1])
        print(f"phase 16 (a) {arch} reduced ({cfg.num_layers} layers, f32) on {smi}: {steps} "
              f"steps on the card in {card_s:.3f} s, losses {card_loss} (CPU {cpu_loss}), "
              f"grad_norm {got[1][-1]['grad_norm']:.6f} (CPU {want[1][-1]['grad_norm']:.6f}); "
              f"tol used: "
              f"metrics {used['metrics']:.3f}, parameters {used['params']:.3f}; kernel launches 0")
    return worst


def phase16_full_width(smi, name, dev):
    """(b) qwen3-0.6b at full width through launch/train.py::build and its
    step: bf16 compute, f32 masters, remat, batch 8 x 1,024, CE chunks of
    512."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepOptions
    from repro_torch.launch.train import build

    arch, b, seq, chunk, warm, timed = TRAIN_FULL
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16" and cfg.remat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, step, _ = build(cfg, make_host_mesh(1, 1, devices=[dev]),
                                 StepOptions(ce_chunk=chunk), warm + timed + 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert all(p.dtype == torch.float32 and p.requires_grad for p in params.parameters())
    n_params = sum(p.numel() for p in params.parameters())
    state_bytes = torch.cuda.memory_allocated()
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                make_lm_batch(0, i, b, seq, cfg.vocab_size).items()}
               for i in range(warm + timed + 1)]
    ms, losses = [], []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batches[i])
        loss = float(m["loss"])                         # waits for the step
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        assert np.isfinite(loss) and np.isfinite(float(m["grad_norm"])), (i, loss)
    held, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    median = float(np.median(ms[warm:]))
    tokens = b * seq
    flops = train_model_flops(cfg, params, b, seq)
    peak_flops = peaks(name, torch.bfloat16)[0]
    box = {}

    def one_step():
        box["out"] = step(params, opt, batches[-1])

    busy, groups, top = step_profile(one_step)
    assert busy > 0, "the profiler saw no device time"
    assert np.isfinite(float(box["out"][2]["loss"]))
    print(f"phase 16 (b) {arch} full width ({cfg.num_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, bf16 compute, f32 masters, remat) on {smi}: {n_params / 1e9:.3f} B "
          f"parameters, state (masters + AdamW) {state_bytes / 2**30:.2f} GiB built in "
          f"{init_s:.2f} s; batch {b} x {seq}, ce_chunk {chunk}: step ms "
          f"{', '.join(f'{x:.1f}' for x in ms)}; median after {warm} warm-up steps "
          f"{median:.1f} ms, {tokens / median * 1e3:.0f} tokens/s; device memory held "
          f"{held / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; model FLOPs "
          f"{flops:.3e} a step, {flops / median / 1e9:.1f} TFLOP/s, "
          f"{flops / median * 1e3 / peak_flops:.3f} of the bf16 dense peak "
          f"({peak_flops / 1e12:.0f} TFLOP/s); losses {', '.join(f'{x:.4f}' for x in losses)}")
    parts = "; ".join(f"{g} {t:.1f} ms ({n} kernels)"
                      for g, (t, n) in sorted(groups.items(), key=lambda x: -x[1][0]))
    print(f"  phase 16 (b) one step under torch.profiler: device busy {busy:.1f} ms of the "
          f"median step's {median:.1f} ms (idle share {1.0 - busy / median:.3f}): {parts}")
    for t, n, key in top:
        print(f"    {t:8.1f} ms {n:6d} x {key[:110]}")
    del params, opt, step, batches, box
    torch.cuda.empty_cache()
    return median


def phase16_trainer(smi, root):
    """(c) launch/train.py::main on the card with an injected failure, then
    a new process resuming from its last checkpoint."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as ckpt:
        base = ["--arch", "qwen3-0.6b", "--smoke", "--global-batch", "4", "--seq-len", "32",
                "--ckpt-dir", ckpt, "--resume", "auto"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            assert train.main(base + ["--steps", "12", "--ckpt-every", "4", "--fail-at-step",
                                      "6", "--log-every", "4"]) == 0
        out = buf.getvalue()
        assert "RESTORE after: RuntimeError: injected node failure" in out, out
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["failures"] == 1 and np.isfinite(rec["final_loss"]), rec
        print(f"phase 16 (c) launch/train.py::main on {smi}, --fail-at-step 6 --ckpt-every 4: "
              f"RESTORE after the injected failure, in {time.perf_counter() - t0:.1f} s, "
              f"{out.strip().splitlines()[-1]}")
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *base,
                               "--steps", "14", "--log-every", "2"], capture_output=True,
                              text=True, timeout=300, env=env, cwd=root)
        assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
        assert "resumed from step 12" in proc.stdout, proc.stdout
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        assert rec["steps"] == 14 and rec["failures"] == 0, rec
        print(f"phase 16 (c) python -m repro_torch.launch.train --resume auto --steps 14: exit 0 "
              f"in {time.perf_counter() - t0:.1f} s (a process of its own), resumed from step "
              f"12, {proc.stdout.strip().splitlines()[-1]}")


def phase16_autograd(dev, reset_counts, counters):
    """(d) the kernels refuse inputs that require grad; a model built to
    train with kernels=True still serves through them (inference mode),
    with every launch asserted.  Returns (flash f32 launches, wkv
    launches) of its serving runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.wkv.kernel import wkv_cuda
    from repro_torch.models import model as M
    from repro_torch.testing import attention_calls

    q = torch.randn(4, 64, 64, device=dev)
    lw, u = -torch.rand(4, 64, 64, device=dev), torch.randn(4, 64, device=dev)
    reset_counts()
    for fn, args, kw in ((flash_attention_cuda, (q, q, q), dict(sm_scale=0.125)),
                         (wkv_cuda, (q, q, q, lw, u), dict(chunk=16))):
        for i in range(len(args)):
            a = list(args)
            a[i] = a[i].clone().requires_grad_(True)
            try:
                fn(*a, **kw)
            except RuntimeError as e:
                assert "no backward" in str(e) and "kernels=False" in str(e), e
            else:
                raise AssertionError(f"{fn.__name__} took an input that requires grad")
    assert all(c.launches == 0 for c in counters)
    launches = {}
    for arch in ("qwen3-0.6b", "rwkv6-3b"):
        cfg = get_config(arch).reduced()
        lm = M.init_params(torch.Generator(dev).manual_seed(0), cfg, kernels=True, master=True)
        tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
        reset_counts()
        cache = M.make_serve_cache(cfg, 2, 32, device=dev)
        logits, cache = M.prefill(lm, cfg, {"tokens": tokens[:, :16]}, cache)
        for t in range(16, 24):
            logits, cache = M.decode_step(lm, cfg, tokens[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits).all())
        if cfg.family == "ssm":
            want = {wkv_cuda: cfg.num_layers}
        else:
            want = {flash_attention_cuda: attention_calls(cfg, True) + 8 * attention_calls(cfg,
                                                                                         False)}
        got = {c: c.launches for c in counters if c.launches}
        assert got == want, (arch, got, want)
        launches[arch] = sum(want.values())
        print(f"phase 16 (d) {arch} reduced, built to train (f32 masters) with kernels=True: "
              f"prefill + 8 decode steps in inference mode launch "
              f"{', '.join(f'{c.__name__} {n}' for c, n in got.items())} (asserted)")
    print("phase 16 (d) flash_attention_cuda and wkv_cuda raise on an input that requires grad "
          "(each input in turn) and launch nothing")
    return launches["qwen3-0.6b"], launches["rwkv6-3b"]


def phase16(smi, name, root, dev, reset_counts, counters):
    """Training on one card: (a) card against CPU, (b) full width, (c) the
    trainer's failure and resume, (d) the kernels under autograd.  Returns
    (flash f32 launches, wkv launches) of (d)'s serving runs."""
    t_phase = time.perf_counter()
    used = phase16_card_vs_cpu(smi, dev, reset_counts, counters)
    print(f"phase 16 (a) worst tol used: metrics {used['metrics']:.3f}, parameters "
          f"{used['params']:.3f}")
    phase16_full_width(smi, name, dev)
    phase16_trainer(smi, root)
    out = phase16_autograd(dev, reset_counts, counters)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 17: training and serving over a mesh whose positions all sit on the
# one card (launch/placement.py, the mesh train step, the compressed
# trainer, Server over a mesh)
MESH_TRAIN = ("qwen3-0.6b", 8, 1024, 512, 3)   # (a): arch, batch, seq, ce_chunk, steps
MESH_COMP = ("qwen3-0.6b", 4, 1024, 512, 4)    # (b): the compressed trainer
# (a)'s tolerance.  The compute is bf16 with f32 masters: each bf16 product
# rounds its output once (unit 2^-9), and the two meshes round at other
# partial sums (a weight gradient over a slice of 4 rows against all 8;
# cuBLAS may pick another kernel for the other shape), so a gradient
# element differs by up to two such roundings, 2 x 2^-9 relative.  The
# loss and the global grad norm are averages over such elements and over
# tokens: rtol MESH_RTOL = 2^-7, twice that per-element bound (the
# reference holds its f32 (2, 2) and (1, 1) losses to 2e-3,
# tests/test_distributed.py).  The parameters: within two Adam steps a
# step (twice the sum of the steps' lr), as a gradient element below the
# rounding may take the other sign at every step and Adam moves it by up to
# lr either way.
MESH_RTOL = 2.0 ** -7
COMP_GAP = 0.05          # tests/test_compressed_train.py's bound


def mesh_train_run(cfg, dev, shape, batches, chunk, profile=False):
    """(whole parameters on the host, [metrics], [step ms], stats) of the
    train step on a mesh of ``shape`` positions all on ``dev``, from
    init_train_state's weights; with ``profile``, one more step under
    torch.profiler (step_profile) in stats["profile"]."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.placement import MeshParams, place_train_state
    from repro_torch.launch.steps import StepOptions, init_train_state, make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n = shape[0] * shape[1]
    mesh = make_host_mesh(*shape, devices=[dev] * n)
    params, opt = init_train_state(cfg, device=dev)
    if n > 1:
        params, opt = place_train_state(params, opt, mesh)
    step = make_train_step(cfg, mesh, StepOptions(ce_chunk=chunk), total_steps=len(batches))
    state = torch.cuda.memory_allocated() - base
    metrics, ms, moved = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        got = {k: float(v) for k, v in m.items()}             # waits for the step
        ms.append((time.perf_counter() - t) * 1e3)
        metrics.append(got)
        moved.append(dict(getattr(step, "stats", {"gathered": 0, "reduced": 0})))
        assert all(np.isfinite(v) for v in got.values()), got
    stats = {"state": state, "held": torch.cuda.memory_allocated() - base,
             "peak": torch.cuda.max_memory_allocated() - base, "moved": moved}
    if isinstance(params, MeshParams):
        stats["blocks"] = params.block_bytes()
        whole = {k: v.cpu() for k, v in params.state_dict().items()}
    else:
        whole = {k: v.detach().cpu() for k, v in params.named_parameters()}
    if profile:     # after the state is read: this step is not compared
        box = {}

        def one_step():
            box["out"] = step(params, opt, batches[-1])

        torch.cuda.synchronize()
        t = time.perf_counter()
        stats["profile"] = step_profile(one_step, n_top=6)
        stats["profile_wall"] = (time.perf_counter() - t) * 1e3
        params, opt = box["out"][:2]
    del params, opt, step
    torch.cuda.empty_cache()
    return whole, metrics, ms, stats


def phase17_sharded(smi, dev):
    """(a) qwen3-0.6b at full width: 3 steps on a (2, 2) mesh in "2d" and 3
    on (1, 1) from the same init, held to each other."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch

    arch, b, seq, chunk, steps = MESH_TRAIN
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16" and cfg.remat
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                make_lm_batch(0, i, b, seq, cfg.vocab_size).items()} for i in range(steps)]
    one, m1, ms1, st1 = mesh_train_run(cfg, dev, (1, 1), batches, chunk)
    four, m4, ms4, st4 = mesh_train_run(cfg, dev, (2, 2), batches, chunk, profile=True)
    used = 0.0
    for i, (g, w) in enumerate(zip(m4, m1)):
        for key in ("loss", "grad_norm"):
            tol = MESH_RTOL * abs(w[key])
            assert abs(g[key] - w[key]) <= tol, (i, key, g[key], w[key])
            used = max(used, abs(g[key] - w[key]) / tol)
        assert g["lr"] == w["lr"], (i, g["lr"], w["lr"])
    bound = 2.0 * sum(m["lr"] for m in m1)
    p_used = 0.0
    for k, w in one.items():
        err = float((four[k] - w).abs().max())
        assert err <= bound, (k, err, bound)
        p_used = max(p_used, err / bound)
    gib = 2.0 ** 30
    fmt = lambda xs: ", ".join(f"{x:.1f}" for x in xs)   # noqa: E731
    print(f"phase 17 (a) {arch} full width (bf16 compute, f32 masters, remat) on {smi}: batch {b} "
          f"x {seq}, {steps} steps from one init; (2, 2) \"2d\" losses "
          f"{', '.join('%.5f' % m['loss'] for m in m4)}, grad_norm "
          f"{', '.join('%.5f' % m['grad_norm'] for m in m4)}; (1, 1) losses "
          f"{', '.join('%.5f' % m['loss'] for m in m1)}, grad_norm "
          f"{', '.join('%.5f' % m['grad_norm'] for m in m1)}; tol used: loss and grad_norm "
          f"{used:.3f} of rtol {MESH_RTOL:.5f}, parameters {p_used:.3f} of two Adam steps a "
          f"step ({bound:.3e})")
    print(f"  phase 17 (a) step ms: (2, 2) {fmt(ms4)} (median {np.median(ms4):.1f}), (1, 1) "
          f"{fmt(ms1)} (median {np.median(ms1):.1f}); state (masters + AdamW) (2, 2) "
          f"{st4['state'] / gib:.2f} GiB, (1, 1) {st1['state'] / gib:.2f} GiB; held after the "
          f"steps {st4['held'] / gib:.2f} / {st1['held'] / gib:.2f} GiB, peak "
          f"{st4['peak'] / gib:.2f} / {st1['peak'] / gib:.2f} GiB")
    last = st4["moved"][-1]
    print(f"  phase 17 (a) (2, 2) a step: gathered into the compute model "
          f"{last['gathered'] / gib:.3f} GiB, gradients reduced onto the blocks' owners "
          f"{last['reduced'] / gib:.3f} GiB; parameter blocks a position "
          f"{', '.join(f'{x / gib:.3f}' for x in st4['blocks'])} GiB (x3 with m and v)")
    busy, groups, top = st4["profile"]
    parts = "; ".join(f"{g} {t:.1f} ms ({n} kernels)"
                      for g, (t, n) in sorted(groups.items(), key=lambda x: -x[1][0]))
    print(f"  phase 17 (a) one more (2, 2) step under torch.profiler: device busy {busy:.1f} ms "
          f"of the median step's {np.median(ms4):.1f} ms (idle share "
          f"{1.0 - busy / np.median(ms4):.3f}; this step's wall with the profiler "
          f"{st4['profile_wall']:.1f} ms): {parts}")
    for t, n, key in top:
        print(f"    {t:8.1f} ms {n:6d} x {key[:110]}")
    return used, p_used


def phase17_compressed(smi, dev):
    """(b) the compressed trainer at full width on a (2, 1) mesh of the card,
    exact sync then int8, 4 steps of batch 4 x 1,024 each."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch.compressed_train import init_error, make_compressed_train_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepOptions, init_train_state
    from repro_torch.optim.compress import compressed_bytes

    arch, b, seq, chunk, steps = MESH_COMP
    cfg = get_config(arch)
    mesh = make_host_mesh(2, 1, devices=[dev] * 2)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                make_lm_batch(1, i, b, seq, cfg.vocab_size).items()} for i in range(steps)]
    traj, times = {}, {}
    for compress in (False, True):
        torch.cuda.empty_cache()
        params, opt = init_train_state(cfg, device=dev)
        err = init_error(params, mesh)
        step = make_compressed_train_step(cfg, mesh, "data", StepOptions(ce_chunk=chunk),
                                          total_steps=steps, compress=compress)
        losses, ms = [], []
        for bt in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, err, m = step(params, opt, err, bt)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t) * 1e3)
            assert np.isfinite(losses[-1]), losses
        assert losses[-1] < losses[0], (compress, losses)
        traj[compress], times[compress] = losses, ms
        payload = compressed_bytes(dict(params.named_parameters()))
        del params, opt, err, step
    gap = max(abs(a - c) for a, c in zip(traj[False], traj[True]))
    assert gap < COMP_GAP, (traj, gap)
    torch.cuda.empty_cache()
    print(f"phase 17 (b) {arch} full width, make_compressed_train_step on a (2, 1) mesh of "
          f"{smi}, batch {b} x {seq}: exact sync losses "
          f"{', '.join('%.5f' % x for x in traj[False])}, int8 + error feedback "
          f"{', '.join('%.5f' % x for x in traj[True])}; largest gap {gap:.5f} (bound "
          f"{COMP_GAP}); int8 payload {payload / 2**20:.1f} MiB a step (compressed_bytes; f32 "
          f"{4 * payload / 2**20:.1f} MiB); step ms exact "
          f"{', '.join(f'{x:.1f}' for x in times[False])}, int8 "
          f"{', '.join(f'{x:.1f}' for x in times[True])}")
    return gap


def phase17_serve(smi, dev, reset_counts, counters, want_tokens):
    """(c) Server over a (2, 1) mesh of the card: phase 14 (a)'s and (c)'s
    runs, the same tokens, the same launches."""
    import collections
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.wkv.kernel import wkv_cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import Request, Server

    launches = {}
    for label, arch, dtype, batch, n_req, max_new in LM_RUNS:
        if label == "b":
            continue
        cfg = dataclasses.replace(get_config(arch), dtype=dtype)
        torch.cuda.empty_cache()
        mesh = make_host_mesh(2, 1, devices=[dev] * 2)
        srv = Server(cfg, batch, LM_MAX_SEQ, mesh=mesh, seed=LM_SEED)
        assert len(srv.row_params) == 1, "a device that holds the model took a second copy"
        rng = np.random.default_rng(LM_SEED)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, LM_PROMPT).astype(np.int32), max_new)
                for i in range(n_req)]
        pending = collections.deque(reqs)
        reset_counts()
        t0 = time.perf_counter()
        while pending or srv.occupancy():
            while pending and srv.admit(pending[0]):
                pending.popleft()
            srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {fn: fn.launches for fn in counters}
        if arch == "rwkv6-3b":
            want = {wkv_cuda: n_req * cfg.num_layers}
        else:
            want = {flash_attention_cuda: 7168}
            assert flash_attention_cuda.bf16_launches == 7168
        assert {fn: n for fn, n in got.items() if n} == want, (label, got, want)
        launches[label] = sum(want.values())
        tokens = [list(r.out) for r in reqs]
        assert tokens == want_tokens[label], (label, tokens, want_tokens[label])
        total = sum(len(t) for t in tokens)
        print(f"phase 17 (c) Server over a (2, 1) mesh of {smi}, {cfg.name} {dtype}: slots "
              f"{batch} ({batch // 2} a data row), {n_req} requests x {LM_PROMPT} prompt tokens "
              f"x max_new {max_new} in {wall:.2f} s ({total / wall:.1f} tokens/s); tokens equal "
              f"to phase 14 ({label})'s; launches "
              f"{', '.join(f'{fn.__name__} {n}' for fn, n in want.items())} (asserted)")
        del srv
        torch.cuda.empty_cache()
    return launches


def phase17_trainer(smi, root):
    """(d) launch/train.py on the reduced config: a checkpoint saved on
    --data-par 4 --model-par 2 and one saved on one device (main, in this
    process), each resumed on 2 x 2 by a process of its own (the two at a
    time)."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train

    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    base = ["--arch", "qwen3-0.6b", "--smoke", "--global-batch", "4", "--seq-len", "32",
            "--log-every", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, "from_4x2"), os.path.join(tmp, "from_1x1")]
        t0 = time.perf_counter()
        for d, mesh in zip(dirs, (["--data-par", "4", "--model-par", "2"], [])):
            with contextlib.redirect_stdout(io.StringIO()):
                assert train.main(base + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "4"]
                                  + mesh) == 0
        saved_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *base,
                                   "--steps", "6", "--data-par", "2", "--model-par", "2",
                                   "--ckpt-dir", d, "--resume", "auto"],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=env, cwd=root) for d in dirs]
        outs = []
        try:
            for p in procs:
                out, errs = p.communicate(timeout=300)
                assert p.returncode == 0, (out[-2000:], errs[-4000:])
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for label, out in zip(("4 x 2", "1 x 1"), outs):
            assert "resumed from step 4" in out, out
            rec = json.loads(out.strip().splitlines()[-1])
            assert rec["steps"] == 6 and rec["failures"] == 0 and np.isfinite(rec["final_loss"])
            print(f"phase 17 (d) launch/train.py on {smi}: saved on {label} (main, 4 steps), "
                  f"resumed on 2 x 2 by python -m repro_torch.launch.train: resumed from step 4, "
                  f"{out.strip().splitlines()[-1]}")
        print(f"phase 17 (d) the two saves {saved_s:.1f} s, the two resuming processes (at a "
              f"time) {time.perf_counter() - t0:.1f} s")


def phase17(smi, name, root, dev, reset_counts, counters, lm_tokens):
    """Training and serving over a mesh of the one card: (a) the sharded
    step against one device, (b) the compressed trainer, (c) Server over a
    mesh, (d) the trainer's elastic restore.  Returns (flash_attn bf16
    launches, wkv launches) of (c)."""
    t_phase = time.perf_counter()
    used, p_used = phase17_sharded(smi, dev)
    phase17_compressed(smi, dev)
    launches = phase17_serve(smi, dev, reset_counts, counters, lm_tokens)
    phase17_trainer(smi, root)
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s; (a) tol used {used:.3f} (metrics), "
          f"{p_used:.3f} (parameters)")
    return launches["a"], launches["c"]


# Phase 18: the dry run.  (a) every cell on the 16 x 16 meta mesh; (b) and
# (c) its predictions held against real runs of cuts that one card holds
DRY_BUDGET_S = 300.0      # (a): past this, the remaining train_4k cells are cut
DRY_FAMILY = {"dense": "qwen3-0.6b", "moe": "olmoe-1b-7b", "ssm": "rwkv6-3b",
              "hybrid": "recurrentgemma-2b", "vlm": "llama-3.2-vision-11b",
              "audio": "whisper-medium"}   # (a)'s train_4k cell kept a family if cut
DRY_SERVE = (("qwen3-0.6b", 1024), ("rwkv6-3b", 1024))   # (c): arch, prompt tokens


def dry_cells():
    """(a)'s cells in the order they run: the serving cells and one
    train_4k cell a family first, then the other train_4k cells."""
    from repro_torch.configs.base import all_arch_names
    from repro_torch.launch.shapes import SHAPES

    first = [(a, s) for a in all_arch_names() for s in SHAPES if s != "train_4k"]
    first += [(a, "train_4k") for a in DRY_FAMILY.values()]
    rest = [(a, "train_4k") for a in all_arch_names() if a not in DRY_FAMILY.values()]
    return first, rest


def phase18_dryrun(smi):
    """(a) launch/dryrun.py's 40 cells on the 16 x 16 meta mesh, in this
    process; one line a cell, and whether its largest position fits this
    card.  The skips must be the port's cell_supported's, and no cell may
    fail (trace_cell raises)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.shapes import SHAPES, cell_supported
    from repro_torch.launch.steps import StepOptions

    opts = StepOptions(sharding_mode="auto")    # the dry run CLI's defaults
    card = torch.cuda.get_device_properties(0).total_memory
    gib = 2.0 ** 30
    first, rest = dry_cells()
    t0 = time.perf_counter()
    recs, cut = [], []
    for arch, shape in first + rest:
        if (arch, shape) in rest and time.perf_counter() - t0 > DRY_BUDGET_S:
            cut.append(f"{arch} {shape}")
            continue
        rec = trace_cell(arch, shape, opts=opts)
        recs.append(rec)
        assert ("skipped" in rec) == (cell_supported(get_config(arch), SHAPES[shape]) is not None)
        if "skipped" in rec or "refused" in rec:
            print(f"phase 18 (a) {arch} {shape} 16x16: "
                  f"{'SKIP' if 'skipped' in rec else 'REFUSED'} "
                  f"({rec.get('skipped') or rec.get('refused')})")
            continue
        ma, st = rec["memory_analysis"], rec["stats"]
        fits = rec["largest_position_bytes"] <= card
        print(f"phase 18 (a) {arch} {shape} 16x16 {rec['sharding_mode']}: largest position "
              f"{rec['largest_position_bytes'] / gib:.2f} GiB = arguments "
              f"{ma['argument_size_in_bytes'] / gib:.3f} + temp (estimate) "
              f"{ma['temp_size_in_bytes'] / gib:.2f} + gathered model "
              f"{rec['gathered_model_bytes'] / gib:.2f}; fits this card ({card / gib:.1f} GiB): "
              f"{fits}; FLOPs a position {rec['cost_analysis']['flops']:.4e}; a step gathered "
              f"{st['gathered'] / gib:.2f} GiB, reduced {st['reduced'] / gib:.2f} GiB; kernels "
              f"{rec['kernel_launches']}; trace {rec['trace_s']} s")
    wall = time.perf_counter() - t0
    traced = [r for r in recs if "skipped" not in r and "refused" not in r]
    over = [f"{r['arch']} {r['shape']}" for r in traced if r["largest_position_bytes"] > card]
    print(f"phase 18 (a): {len(recs)} cells in {wall:.1f} s ({len(traced)} traced, "
          f"{sum('skipped' in r for r in recs)} skipped, {sum('refused' in r for r in recs)} "
          f"refused), cut for time: {cut or 'none'}; not fitting one card: {over}")
    return recs


def state_nbytes(params, opt, devices):
    """Bytes of a real train state: the masters (each device's compute
    model once), and on a mesh the blocks of parameters, m and v, and the
    step counts."""
    from repro_torch.launch.placement import MeshParams

    def nb(xs):
        return sum(x.numel() * x.element_size() for x in xs if x is not None)

    if not isinstance(params, MeshParams):
        return nb(params.parameters()) + nb(opt["m"].values()) + nb(opt["v"].values()) \
            + nb([opt["step"]])
    total = sum(nb(params.compute_model(d).parameters()) for d in set(devices))
    for blocks in (params.blocks, opt["m"], opt["v"]):
        total += sum(nb(bs) for bs in blocks.values())
    return total + nb(opt["step"])


def phase18_train(smi, dev):
    """(b) qwen3-0.6b at phase 16 (b)'s shape traced on meta for (1, 1) and
    (2, 2), then one real step through launch/train.py::build on the card
    and on phase 17's (2, 2) mesh of it: state bytes, gathered/reduced and
    FLOPs predicted against measured, exactly."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.steps import StepOptions
    from repro_torch.launch.train import build

    arch, b, seq, chunk = TRAIN_FULL[:4]
    cfg = get_config(arch)
    opts = StepOptions(ce_chunk=chunk)
    cell = ShapeCell("train_8x1k", seq, b, "train")
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in make_lm_batch(0, 0, b, seq, cfg.vocab_size).items()}
    gib = 2.0 ** 30
    for shape in ((1, 1), (2, 2)):
        n = shape[0] * shape[1]
        rec = trace_cell(arch, cell, opts=opts, mesh_shape=shape, devices=[dev] * n)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params, opt, step, _ = build(cfg, make_host_mesh(*shape, devices=[dev] * n), opts, 2)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with OpAnalysis() as mode:
            params, opt, metrics = step(params, opt, batch)
            loss = float(metrics["loss"])
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        real = mode.result
        state = state_nbytes(params, opt, [dev] * n)
        stats = dict(getattr(step, "stats", {"gathered": 0, "reduced": 0}))
        model = params if n == 1 else params.compute_model(dev)
        model_flops = train_model_flops(cfg, model, b, seq)
        assert np.isfinite(loss), loss
        assert rec["state_bytes"] == state, (shape, rec["state_bytes"], state)
        assert rec["stats"] == stats, (shape, rec["stats"], stats)
        assert rec["step_flops"] == real.flops, (shape, rec["step_flops"], real.flops)
        temp = rec["memory_analysis"]["temp_size_in_bytes"]
        print(f"phase 18 (b) {arch} {b} x {seq} (CE chunk {chunk}) on a {shape} mesh of {smi}: "
              f"state predicted {rec['state_bytes']:,} B = measured {state:,} B "
              f"(held {(held - base) / gib:.2f} GiB); gathered/reduced predicted "
              f"{rec['stats']} = step.stats; FLOPs traced {rec['step_flops']:.6e} = the card's "
              f"step under the op analysis {real.flops:.6e} ({real.ops} ATen ops), "
              f"{rec['step_flops'] / model_flops:.4f}x train_model_flops ({model_flops:.4e}); "
              f"loss {loss:.5f}; step {step_s:.2f} s with the analysis on")
        print(f"  phase 18 (b) {shape}: peak_live_bytes a position (trace) {temp / gib:.3f} GiB, "
              f"{rec['slices']} slice(s); the card's max_memory_allocated() - held "
              f"{peak / gib:.3f} GiB; ratio {peak / temp:.3f} (not gated)")
        del params, opt, step, model, mode
        torch.cuda.empty_cache()


def phase18_serve(smi, dev, reset_counts):
    """(c) qwen3-0.6b's prefill of 1,024 tokens and one decode at the full
    cache, rwkv6-3b's prefill of 1,024 (phase 14's request shapes), with the
    kernels: the launches the trace predicts against the wrappers'
    counters, the kernel and ATen FLOPs against the op analysis of the real
    calls.  Returns (flash_attn bf16 launches, wkv launches) of the real
    calls, each counted from 0 just before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
    from repro_torch.kernels.wkv.kernel import wkv_cuda
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import model as M

    counters = {"flash_attn": flash_attention_cuda, "wkv": wkv_cuda}
    flash = wkv_n = 0
    for arch, prompt in DRY_SERVE:
        cfg = get_config(arch)
        params = M.init_params(torch.Generator(dev).manual_seed(LM_SEED), cfg)
        tok = torch.as_tensor(np.random.default_rng(LM_SEED).integers(
            0, cfg.vocab_size, (1, prompt)), dtype=torch.int32, device=dev)
        cache = M.make_serve_cache(cfg, 1, prompt + 1, device=dev)
        calls = [("prefill", prompt, lambda: M.prefill(params, cfg, {"tokens": tok}, cache))]
        if cfg.family != "ssm":
            calls.append(("decode", prompt + 1,
                          lambda: M.decode_step(params, cfg, tok[:, -1:], cache, prompt)))
        for kind, seq, call in calls:
            rec = trace_cell(arch, ShapeCell(f"{kind}_1k", seq, 1, kind), mesh_shape=(1, 1))
            reset_counts()
            with OpAnalysis() as mode:
                logits, _ = call()
            torch.cuda.synchronize()
            real = mode.result
            launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
            flash += flash_attention_cuda.bf16_launches
            wkv_n += wkv_cuda.launches
            assert bool(torch.isfinite(logits).all()), (arch, kind)
            assert rec["kernel_launches"] == launched == real.kernel_launches, \
                (arch, kind, rec["kernel_launches"], launched, real.kernel_launches)
            assert rec["kernel_flops"] == real.kernel_flops, (arch, kind)
            assert rec["aten_flops"] == real.aten_flops, (arch, kind)
            print(f"phase 18 (c) {arch} {kind} ({prompt} tokens, {cfg.dtype}) on {smi}: launches "
                  f"predicted {rec['kernel_launches']} = counted on the card {launched}; kernel "
                  f"FLOPs {rec['kernel_flops']} and ATen FLOPs {rec['aten_flops']:.6e} = the "
                  f"card's calls'")
        del params, cache
        torch.cuda.empty_cache()
    return flash, wkv_n


def phase18(smi, dev, reset_counts):
    """The dry run (a) and its predictions against the card (b), (c).
    Returns (c)'s (flash_attn bf16 launches, wkv launches)."""
    t_phase = time.perf_counter()
    phase18_dryrun(smi)
    phase18_train(smi, dev)
    launches = phase18_serve(smi, dev, reset_counts)
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return launches


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
    from repro_torch.kernels.flash_attn.kernel import KERNEL_WIDTHS, flash_attention_cuda
    from repro_torch.kernels.wkv.kernel import wkv_cuda
    from repro_torch.kernels.knn_score.kernel import knn_score_cuda
    from repro_torch.kernels.knn_score.ops import knn_score
    from repro_torch.kernels.knn_score.ref import knn_score_plain
    from repro_torch.kernels.knn_topk.kernel import TILE_ROWS, knn_topk_fused, split_ranges
    from repro_torch.kernels.knn_topk.ref import knn_topk_plain
    from repro_torch.kernels.legacy import knn_score_v1, knn_topk_v1, topk_merge_v1
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
    usage = {}
    for kname, (lib, log) in sorted(built.items()):
        print(f"  {kname} -> {os.path.relpath(lib, root)}")
        for fn, (regs, st, ld) in sorted(ptxas_usage(log).items()):
            print(f"    ptxas: {fn}: {regs} registers, spill stores {st} B, loads {ld} B")
        usage.update(ptxas_usage(log))
    counters = (knn_topk_fused, knn_score_cuda, topk_merge_cuda, flash_attention_cuda,
                wkv_cuda)

    def reset_counts():
        for fn in counters:
            fn.launches = 0
        flash_attention_cuda.bf16_launches = 0
        flash_attention_cuda.f32_mma_launches = 0

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
    route_err = phase2_large_k_and_odd_tile(dev)

    # phase 1 at the engine's own shapes: one 2048-row R block, all of S
    br = R.rows(0, BLOCK).to(dev)
    args, kwargs, n_active = index.kernel_inputs(br, R.indices[:BLOCK].numpy(), BLOCK)
    got = knn_topk_fused(*args, **kwargs)
    ref = knn_topk_plain(*args, **kwargs)
    torch.cuda.synchronize()
    engine_err = assert_topk_close(got[0].cpu(), got[1].cpu(), ref[0].cpu(), ref[1].cpu(),
                                   RTOL, ATOL)
    np.testing.assert_allclose(got[2].cpu().numpy(), ref[2].cpu().numpy(), rtol=RTOL, atol=ATOL)
    kernel_ms = cuda_ms(lambda: knn_topk_fused(*args, **kwargs), reps=10)
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
    n_rb, n_sb = args[0].shape[1] // block_r, args[1].shape[1] // block_s
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_ranges, range_len = split_ranges(n_rb, n_sb, block_r, block_s, n_sm)
    n_ctas = n_rb * -(-block_r // TILE_ROWS) * n_ranges
    print(f"phase 1 engine shapes: NR={args[0].shape[1]} NS={args[1].shape[1]} T+1="
          f"{args[0].shape[0]} A={args[2].shape[2]} active entries {n_active} "
          f"max|dscore|={engine_err:.3e}")
    print(f"  knn_topk pass 1: {n_ctas} CTAs ({n_ctas // n_ranges} R tiles x P={n_ranges} "
          f"ranges of {range_len} 128-column tile(s)) on {n_sm} SMs, "
          f"{usage_of(usage, 'knn_topk_selectILi1E')}; pass 2: {n_rb} CTAs, "
          f"{usage_of(usage, 'knn_topk_mergeILi1E')}")
    print(f"  knn_topk kernel {kernel_ms:.3f} ms/launch ({flops / kernel_ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.3f} ms, dense matmul+topk {library_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}: {flops:.3e} flop, {topk_bytes:.3e} B)")

    # the first (sequential) design on the same inputs: bit for bit, and its time
    old = knn_topk_v1(*args, **kwargs)
    torch.cuda.synchronize()
    v1_same = all(torch.equal(a, b) for a, b in zip(got, old))
    v1_err = max(max_abs_err(got[0], old[0]), max_abs_err(got[2], old[2]))
    v1_ms = cuda_ms(lambda: knn_topk_v1(*args, **kwargs), reps=1)
    print(f"  knn_topk vs the first design: bit-identical {v1_same}, max|d| {v1_err:.3e}; "
          f"first design {v1_ms:.3f} ms/launch")
    assert v1_same, "knn_topk differs from its first design"
    del old

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
                                              block_s=block_s), reps=10)
    score_plain_ms = cuda_ms(lambda: knn_score_plain(r_tiles, s_tiles, active,
                                                     block_r=block_r, block_s=block_s), reps=2)
    score_bound_ms, score_bound_by = bound(flops, nbytes(r_tiles, s_tiles, active, sc), name)
    score_ctas = n_rb * -(-block_r // TILE_ROWS) * n_sb * -(-block_s // TILE_ROWS)
    print(f"phase 4 knn_score engine shapes: NR={sc.shape[0]} NS={sc.shape[1]} CTAs "
          f"{score_ctas}, {usage_of(usage, '_knn_score_cu_')}, max|dscore|={score_err:.3e}")
    print(f"  knn_score kernel {score_ms:.3f} ms/launch ({flops / score_ms / 1e9:.1f} TFLOP/s), "
          f"plain {score_plain_ms:.3f} ms, dense matmul {score_library_ms:.3f} ms, bound "
          f"{score_bound_ms:.3f} ms ({score_bound_by})")
    old = knn_score_v1(r_tiles, s_tiles, active, block_r, block_s)
    torch.cuda.synchronize()
    v1_score_same = torch.equal(sc, old)
    v1_score_err = max_abs_err(sc, old)
    v1_score_ms = cuda_ms(lambda: knn_score_v1(r_tiles, s_tiles, active, block_r, block_s),
                          reps=5)
    print(f"  knn_score vs the first design: bit-identical {v1_score_same}, max|d| "
          f"{v1_score_err:.3e}; first design {v1_score_ms:.3f} ms/launch")
    assert v1_score_same, "knn_score differs from its first design"
    del old
    fresh = init_topk(sc.shape[0], K)
    cand = torch.where(sc > 0, sc, float("-inf"))
    cand_ids = torch.arange(sc.shape[1], dtype=torch.int32, device=dev)
    m_args = (fresh.scores, fresh.ids, cand, cand_ids)
    got_m, want_m = topk_merge_cuda(*m_args), topk_merge_plain(*m_args)
    assert torch.equal(got_m[0], want_m[0]) and torch.equal(got_m[1], want_m[1])
    merge_err = max_abs_err(got_m[0], want_m[0])
    old_m = topk_merge_v1(*m_args)
    v1_merge_same = torch.equal(got_m[0], old_m[0]) and torch.equal(got_m[1], old_m[1])
    assert v1_merge_same, "topk_merge differs from its first design"
    del old_m
    # the split kernel and the first design in turns
    merge_turns = [cuda_ms(lambda: fn(*m_args), reps=20)
                   for fn in (topk_merge_cuda, topk_merge_v1, topk_merge_v1, topk_merge_cuda)]
    merge_ms, v1_merge_ms = merge_turns[0], merge_turns[1]
    merge_plain_ms = cuda_ms(lambda: topk_merge_plain(*m_args), reps=5)
    merge_library_ms = cuda_ms(lambda: torch.topk(torch.cat([fresh.scores, cand], 1), K, dim=1),
                               reps=20)
    merge_bytes = nbytes(*m_args, *got_m)
    merge_bound_ms, merge_bound_by = bound(cand.numel() * 1.0, merge_bytes, name)
    print(f"phase 4 topk_merge engine shapes: N={cand.shape[0]} M={cand.shape[1]} k={K} "
          f"bit-identical to the plain version and to the first design; split kernel "
          f"{cand.shape[0]} CTAs of 8 warps, {usage_of(usage, 'topk_merge_split_kernelILi1E')}")
    print(f"  topk_merge kernel {merge_ms:.4f} ms/launch, plain {merge_plain_ms:.3f} ms, "
          f"cat+topk {merge_library_ms:.3f} ms, bound {merge_bound_ms:.4f} ms "
          f"({merge_bound_by}: {merge_bytes:.3e} B)")
    print(f"  topk_merge in turns (split, first design, first design, split): "
          f"{'; '.join(f'{x:.4f}' for x in merge_turns)} ms/launch; first design "
          f"{v1_merge_ms / merge_ms:.2f}x the split kernel's time")
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
    # merge_topk_states at k = 200: the large-k kernel (a CTA a row), bit for bit
    a_big = TopKState(*merge_inputs(dev, 11, N_R, 200, 1, False, "mixed")[:2])
    b_big = TopKState(*merge_inputs(dev, 12, N_R, 200, 1, False, "mixed")[:2])
    big = merge_topk_states(a_big, b_big)
    torch.cuda.synchronize()
    plain_big = insert_candidates(a_big.scores, a_big.ids, b_big.scores, b_big.ids)
    assert torch.equal(big.scores, plain_big[0]) and torch.equal(big.ids, plain_big[1])
    big_args = (a_big.scores, a_big.ids, b_big.scores, b_big.ids)
    big_ms = cuda_ms(lambda: topk_merge_cuda(*big_args), reps=20)
    big_plain_ms = cuda_ms(lambda: topk_merge_plain(*big_args), reps=5)
    big_library_ms = cuda_ms(lambda: torch.topk(torch.cat([a_big.scores, b_big.scores], 1), 200,
                                                dim=1), reps=20)
    big_bytes = nbytes(*big_args, big.scores, big.ids)
    big_bound_ms, big_bound_by = bound(N_R * 400.0, big_bytes, name)
    print(f"phase 6 merge_topk_states k=200: N={N_R} M=200, kernel merge bit-identical to the "
          f"plain body; topk_merge large-k kernel {big_ms:.4f} ms/launch, plain "
          f"{big_plain_ms:.3f} ms, cat+topk {big_library_ms:.3f} ms, bound {big_bound_ms:.4f} ms "
          f"({big_bound_by}: {big_bytes:.3e} B), {usage_of(usage, 'topk_merge_large_kernel')}")
    del a_big, b_big, big, plain_big, big_args

    # phase 7: flash attention at qwen3-0.6b and recurrentgemma-2b widths; both
    # kernels' tensor-core instructions and registers per head width first
    for kind, part in (("f32 3xTF32", "flash_attn_tf32_kernel"), ("bf16", "flash_attn_mma_kernel")):
        mma_counts = sass_mma_counts(built["flash_attn"][0], part)
        for hd in KERNEL_WIDTHS:
            hits = [c for f, c in mma_counts.items() if f"ILi{hd}E" in f]
            print(f"phase 7 flash {kind} kernel hd {hd}: {sum(hits)} HMMA/HGMMA instructions "
                  f"(cuobjdump -sass), {usage_of(usage, f'{part}ILi{hd}E')}")
            assert len(hits) == 1 and hits[0] > 0, (hd, mma_counts)
    flash_worst = phase7_edge_cases(dev)   # {dtype: (max |Δ|, tolerance used)}
    flash_full = {}
    for m in FLASH_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            flash_full[m, dtype] = phase7_full_width(dev, name, m, dtype)
            case = (flash_full[m, dtype]["max_abs_err"], flash_full[m, dtype]["used"])
            flash_worst[dtype] = tuple(map(max, flash_worst[dtype], case))
    flash_f32_launches, flash_bf16_launches, flash_op_err = phase7_main_path(dev, reset_counts,
                                                                             counters)
    f32_err = max(flash_worst[torch.float32][0], flash_op_err)
    print(f"phase 7 worst: f32 max|d| {f32_err:.3e} (tol used "
          f"{flash_worst[torch.float32][1]:.3f}), bf16 max|d| "
          f"{flash_worst[torch.bfloat16][0]:.3e} (tol used {flash_worst[torch.bfloat16][1]:.3f})")
    for m in FLASH_WIDTHS:
        f32, bf16 = flash_full[m, torch.float32], flash_full[m, torch.bfloat16]
        print(f"phase 7 {m}: f32 3xTF32 {f32['ms']:.3f} ms, first f32 design "
              f"{f32['first_ms']:.3f} ms ({f32['first_ms'] / f32['ms']:.2f}x), SDPA f32 "
              f"{f32['library_ms']:.3f} ms, bounds 3xTF32 {f32['bound_ms']:.4f} ms, fp32 FMAs "
              f"{f32['fma_bound_ms']:.4f} ms; bf16 {bf16['ms']:.3f} ms, first bf16 design "
              f"{bf16['first_ms']:.3f} ms ({bf16['first_ms'] / bf16['ms']:.1f}x), SDPA bf16 "
              f"{bf16['library_ms']:.3f} ms ({bf16['ms'] / bf16['library_ms']:.2f}x its time), "
              f"bound {bf16['bound_ms']:.4f} ms")
    # the kernels line carries the qwen3-0.6b cases: f32 with the worst f32 error,
    # bf16 with the worst bf16 error
    flash_line = dict(flash_full[("qwen3-0.6b", torch.float32)], max_abs_err=f32_err)
    flash_bf16_line = dict(flash_full[("qwen3-0.6b", torch.bfloat16)],
                           max_abs_err=flash_worst[torch.bfloat16][0])

    # phase 8: wkv at rwkv6-3b's width
    wkv_edge = phase8_edge_cases(dev)
    wkv_line, (wkv_err16, wkv_used, wkv_used16) = phase8_full_width(dev, name, usage,
                                                                      reset_counts, counters)
    wkv_line["max_abs_err"] = max(wkv_line["max_abs_err"], wkv_edge[torch.float32][0])
    print(f"phase 8 worst: f32 max|d| {wkv_line['max_abs_err']:.3e} (tol used "
          f"{max(wkv_used, wkv_edge[torch.float32][1]):.3f}), bf16 max|d| "
          f"{max(wkv_err16, wkv_edge[torch.bfloat16][0]):.3e} (tol used "
          f"{max(wkv_used16, wkv_edge[torch.bfloat16][1]):.3f})")

    # phase 9: the paper's three drivers (counts from 0 around each main-path run)
    t0 = time.perf_counter()
    driver_merges, driver_merge_case, driver_results, driver_medians = phase9_drivers(
        dev, name, R, S, rows, o_s, o_i, q2, reset_counts)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s, topk_merge launches on its main-path "
          f"runs {driver_merges}")

    # phase 10: the datastore's lifecycle and the approx tier (counts from 0
    # around each main-path run)
    life_launches, life_errs = phase10(dev, R, S, dict(driver_results, **{"iib+kernel": q2}),
                                       reset_counts)

    # phase 11: the sharded store on one card (counts from 0 around each
    # main-path run)
    store_merges, store_merge_err, iib_store, yeast, store_queries = phase11(
        smi, name, R, S, rows, o_s, o_i, driver_results, driver_medians, reset_counts)

    # phase 12: the store's checkpoints and the serving front-end (counts
    # from 0 around each main-path run)
    store_merges += phase12(smi, R, S, iib_store, yeast, reset_counts)
    del iib_store

    # phase 13: the multi-device join and the job launcher (counts from 0
    # around each main-path run)
    store_merges += phase13(smi, root, torch.device("cuda", 0), R, S, driver_results,
                            store_queries, yeast, reset_counts)
    del yeast, store_queries

    # phase 14: the LM serving path at full width (counts from 0 around each
    # main-path run)
    lm_launches, lm_errs, lm_tokens = phase14(smi, name, root, torch.device("cuda", 0),
                                              reset_counts, counters)
    flash_line["max_abs_err"] = max(flash_line["max_abs_err"], lm_errs[torch.float32])
    flash_bf16_line["max_abs_err"] = max(flash_bf16_line["max_abs_err"], lm_errs[torch.bfloat16])

    # phase 15: the moe, hybrid, vlm and audio families at full width (counts
    # from 0 around each main-path run)
    fam_launches, fam_errs = phase15(smi, name, root, torch.device("cuda", 0), reset_counts,
                                     counters)
    flash_line["max_abs_err"] = max(flash_line["max_abs_err"], fam_errs[torch.float32])
    flash_bf16_line["max_abs_err"] = max(flash_bf16_line["max_abs_err"], fam_errs[torch.bfloat16])

    # phase 16: training on one card (the train step runs no kernel; (d)'s
    # serving runs count from 0 around each)
    train_flash, train_wkv = phase16(smi, name, root, torch.device("cuda", 0), reset_counts,
                                     counters)

    # phase 17: training and serving over a mesh of the one card (counts
    # from 0 around each of (c)'s serving runs)
    mesh_flash, mesh_wkv = phase17(smi, name, root, torch.device("cuda", 0), reset_counts,
                                   counters, lm_tokens)

    # phase 18: the dry run and its predictions against the card (counts
    # from 0 around each of (c)'s serving calls)
    dry_flash, dry_wkv = phase18(smi, torch.device("cuda", 0), reset_counts)

    print(json.dumps({"kernels": [
        {
            "name": "knn_topk",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knn_topk.cu",
            "replaces": "src/repro/kernels/knn_topk/kernel.py:63",
            "launches": cached_launches + stream_launches + split_counts[0]
            + life_launches["knn_topk"],
            "max_abs_err": max(edge_err, engine_err, route_err, life_errs["knn_topk"]),
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
            "launches": unfused_counts[0] + life_launches["knn_score"],
            "max_abs_err": max(score_err, life_errs["knn_score"]),
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
            "launches": unfused_counts[1] + split_counts[1] + driver_merges
            + life_launches["topk_merge"] + store_merges,   # phases 11 to 13
            "max_abs_err": max(merge_err, driver_merge_case[0], life_errs["topk_merge"],
                               store_merge_err),
            "ms": merge_ms,
            "plain_ms": merge_plain_ms,
            "bound_ms": merge_bound_ms,
            "bound_by": merge_bound_by,
            "library_ms": merge_library_ms,
        },
        {
            "name": "flash_attn",   # the f32 path: 3xTF32 mma.sync on the tensor cores
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn/kernel.py:36",
            "launches": flash_f32_launches + lm_launches["flash_f32"]   # phases 7, 14-16
            + fam_launches["flash_f32"] + train_flash,
            **{key: flash_line[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
        },
        {
            "name": "flash_attn_bf16",   # the bf16 path: bf16 mma.sync on the tensor cores
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn/kernel.py:36",
            "launches": flash_bf16_launches + lm_launches["flash_bf16"]   # phases 7, 14, 15, 17, 18
            + fam_launches["flash_bf16"] + mesh_flash + dry_flash,
            **{key: flash_bf16_line[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                     "bound_by", "library_ms")},
        },
        {
            "name": "wkv",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv.cu",
            "replaces": "src/repro/kernels/wkv/kernel.py:37",
            # phases 8, 14, 16-18
            **dict(wkv_line, launches=wkv_line["launches"] + lm_launches["wkv"]
                   + train_wkv + mesh_wkv + dry_wkv,
                   max_abs_err=max(wkv_line["max_abs_err"], lm_errs["wkv"])),
            # library_ms null: no single PyTorch call computes WKV
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
