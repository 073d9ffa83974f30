// Fused tile-skipping score -> streaming top-k for Hopper (sm_90a).
//
// Replaces repro/kernels/knn_topk/kernel.py::_knn_topk_kernel (the Pallas
// TPU kernel behind knn_topk_pallas) and computes exactly what it does:
//
//   * Rows are grouped by block_r; each group walks the S blocks (block_s
//     columns each) in order, and within a block its active dim-tiles in
//     list order.  Lists are ascending and padded with the sentinel tile T,
//     which is all zeros, so the walk stops at the first sentinel.
//   * scores = sum over the block's active tiles of R_tile . S_tile^T, in
//     fp32 FMA (no TF32: fp32 parity is the bar).
//   * A column is offered when score > 0, s_valid and score > thr, where
//     thr is frozen for the whole S block.
//   * Offered candidates are inserted column by column, in order, into the
//     row's descending k-state: pos = #{state >= cand}, shift right;
//     incumbents win ties (the topk_merge insertion body).
//   * At the end of an S block in which some candidate was offered, thr
//     becomes the min of the k-th score over the rows < nr_valid.
//     thr_out[i] is its final value.
//
// The TPU grid walks the S blocks in order on one core.  Here the walk is
// split across CTAs and merged in S order, in two kernels of one launch:
//
//   Pass 1 (select), grid (R tiles of 128 rows) x (P S ranges, each a run
//   of 128-column tiles; kernel.py's split_ranges picks P from the SM count).
//   A CTA walks its range's tiles in order: the score tile comes from the
//   shared mainloop of score_tile.cuh, is staged in shared memory, masked
//   (score > 0, s_valid, score > thr) and inserted per row by a warp
//   (topk_insert.cuh, with a ballot pre-filter against the row's k-th).  The
//   CTA's rows start from an empty state; their states for the range go to
//   a partial buffer (NR, P, k), in device memory (L2-resident).  thr starts
//   at thr_in and, after a tile in which the CTA offered something, rises to
//   the max of itself and the min k-th over the CTA's rows < nr_valid.  One
//   offered flag per CTA, no atomics.
//
//   Pass 2 (merge), one CTA per block_r group, one warp a row: seed from
//   init, insert the P partial states in range order with the topk_merge
//   walk (topk::merge_row), so incumbents, and so earlier S, win ties.
//   thr_out = min over rows < nr_valid of the final k-th if any CTA of the
//   group offered, else thr_in.
//
// Why this is the sequential walk's result, for rows < nr_valid, when
// thr_in <= every such row's initial k-th (the callers pass the initial
// state's MinPruneScore): a local state is the top-k of a subset of the
// row's candidates, so its k-th, and the CTA's threshold, never exceed the
// row's final k-th; a candidate at or under that cannot enter the final
// state (ties go to incumbents).  A group offered something in the
// sequential walk exactly when some positive valid candidate beats thr_in,
// which is when some CTA of the group offered.  Rows >= nr_valid are outside
// this argument: every caller pads R with empty rows, which are never
// offered and stay (-inf, -1).
//
// Scores are one fmaf chain per output, tile by tile in list order, as in
// the first (sequential) design of this kernel, so the outputs are bit for
// bit that design's; nothing is summed across CTAs and runs repeat bit for
// bit.
//
// Bound: operations, 2 * block_r * block_s * tile flop for every active
// (R block, S block, tile) triple: 4.24e11 flop for one 2048-row R block
// against synthetic-10k's S (25,280 triples), 6.33 ms at the H100 SXM's
// 67 TFLOP/s fp32.  Selection and merge move ~1% of those bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "score_tile.cuh"
#include "topk_insert.cuh"

namespace {

using score_tile::kThreads;
using score_tile::kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeWarps = 32;          // pass 2: warps of a group's CTA
constexpr int kMaxRows = 256;            // largest block_r

// Floats of the shared region that holds the mainloop's stage and, after
// it, a tile's staged scores.
constexpr int kScFloats = score_tile::kStageBytes / 4 > kTile * score_tile::kScorePitch
                              ? score_tile::kStageBytes / 4
                              : kTile * score_tile::kScorePitch;

struct Params {
  score_tile::Operands op;
  const int* active;     // (nR, nS, A)
  const int* s_valid;    // (NS,)
  const int* s_ids;      // (NS,)
  const float* init_s;   // (NR, k)
  const int* init_i;     // (NR, k)
  const float* thr_in;   // (1,)
  const int* nr_valid;   // (1,)
  float* part_s;         // (NR, P, k) partial states of the ranges
  int* part_i;           // (NR, P, k)
  int* offered;          // (R tiles, P)
  float* out_s;          // (NR, k)
  int* out_i;            // (NR, k)
  float* thr_out;        // (nR,)
  int t1, n_sb, a_len, k, block_r, block_s, sub_r, n_ranges, range_len;
};

// Insert one row's offered tile columns into its k-state (in the partial
// buffer), in column order.  Called by a whole warp; every branch is
// warp-uniform.  Returns whether any candidate of the row was offered;
// kth_out is the row's k-th score afterwards.
template <int KS>
__device__ bool insert_row(float* row_s, int* row_i, int k, const float* sc_row,
                           const int* col_ok, const int* col_id, int ncol, float thr, int lane,
                           float& kth_out) {
  float s[KS];
  int id[KS];
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int p = q * 32 + lane;
    s[q] = p < k ? row_s[p] : -INFINITY;
    id[q] = p < k ? row_i[p] : -1;
  }
  float kth = topk::kth<KS>(s, k);
  bool offered = false, changed = false;
  for (int c0 = 0; c0 < ncol; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < ncol ? sc_row[c] : -INFINITY;
    const bool ok = c < ncol && v > 0.f && col_ok[c] != 0 && v > thr;
    offered |= __any_sync(topk::kFullMask, ok);
    const bool pass = ok && v > kth;
    const int cid = pass ? col_id[c] : -1;
    unsigned hits = __ballot_sync(topk::kFullMask, pass);
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const float vj = __shfl_sync(topk::kFullMask, v, j);
      const int idj = __shfl_sync(topk::kFullMask, cid, j);
      if (!(vj > kth)) continue;  // pos would be k: the state stays as it is
      changed = true;
      topk::insert<KS>(s, id, k, vj, idj, lane);
      kth = topk::kth<KS>(s, k);
    }
  }
  if (changed) {
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int p = q * 32 + lane;
      if (p < k) {
        row_s[p] = s[q];
        row_i[p] = id[q];
      }
    }
  }
  kth_out = kth;
  return offered;
}

// A pass-1 CTA's state between tiles.  It lives in shared memory, not in
// registers: the mainloop needs all but a few of the 128 registers a thread
// has at two CTAs an SM, and what stays live across it spills.
struct CtaState {
  int row0, nrow;  // the R tile: first row, rows in it
  int a_live;      // live entries of the staged active list
  float thr;       // the CTA's threshold
  int ever;        // whether the CTA offered anything
};

template <int KS>
__global__ void __launch_bounds__(kThreads, 2) knn_topk_select(Params p) {
  __shared__ float warp_min[kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ CtaState cs;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;  // the mainloop's buffers, then the staged scores:
  float* sc = smem;     // [kTile][kScorePitch]
  int* col_ok = reinterpret_cast<int*>(smem + kScFloats);
  int* col_id = col_ok + kTile;
  int* alist = col_id + kTile;  // a_len entries

  const int tid = threadIdx.x;
  const int tiles_per_block = (p.block_s + kTile - 1) / kTile;
  const int ct0 = blockIdx.y * p.range_len;
  const int ct1 = min(p.n_sb * tiles_per_block, ct0 + p.range_len);
  if (tid == 0) {
    const int r_lo = (blockIdx.x % p.sub_r) * kTile;
    cs.row0 = (blockIdx.x / p.sub_r) * p.block_r + r_lo;
    cs.nrow = min(kTile, p.block_r - r_lo);
    cs.thr = p.thr_in[0];
    cs.ever = 0;
  }
  __syncthreads();
  const size_t part_stride = (size_t)p.n_ranges * p.k;  // between rows
  const size_t part0 = (size_t)cs.row0 * part_stride + (size_t)blockIdx.y * p.k;
  for (int e = tid; e < cs.nrow * p.k; e += kThreads) {
    const size_t g = part0 + (size_t)(e / p.k) * part_stride + e % p.k;
    p.part_s[g] = -INFINITY;
    p.part_i[g] = -1;
  }

  for (int ct = ct0; ct < ct1; ++ct) {
    const int j = ct / tiles_per_block, c_lo = (ct % tiles_per_block) * kTile;
    if (ct == ct0 || c_lo == 0) {  // a new S block: stage its active list
      const int* act = p.active + ((size_t)(blockIdx.x / p.sub_r) * p.n_sb + j) * p.a_len;
      for (int e = tid; e < p.a_len; e += kThreads) alist[e] = act[e];
      __syncthreads();  // alist was read last inside accumulate
      if (tid == 0) cs.a_live = score_tile::live_tiles(alist, p.a_len, p.t1 - 1);
      __syncthreads();
    }
    const int ncol = min(kTile, p.block_s - c_lo);
    const int col0 = j * p.block_s + c_lo;
    {
      float acc[8][8];
      score_tile::accumulate(acc, stage, alist, cs.a_live, p.op, cs.row0, cs.nrow, col0, ncol);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          sc[score_tile::tile_row(i, tid) * score_tile::kScorePitch +
             score_tile::tile_col(jj, tid)] = acc[i][jj];
    }
    if (tid < kTile) {
      const bool in = tid < ncol;
      col_ok[tid] = in ? p.s_valid[col0 + tid] : 0;
      col_id[tid] = in ? p.s_ids[col0 + tid] : -1;
    }
    __syncthreads();
    const int lane = tid & 31, warp = tid >> 5;
    const int row0 = cs.row0, nrv = p.nr_valid[0];
    const size_t base = (size_t)row0 * part_stride + (size_t)blockIdx.y * p.k;
    bool off = false;
    float kmin = INFINITY;
    for (int r = warp; r < cs.nrow; r += kWarps) {
      const size_t g = base + (size_t)r * part_stride;
      float kth;
      off |= insert_row<KS>(p.part_s + g, p.part_i + g, p.k, sc + r * score_tile::kScorePitch,
                            col_ok, col_id, ncol, cs.thr, lane, kth);
      if (row0 + r < nrv) kmin = fminf(kmin, kth);
    }
    if (lane == 0) {
      warp_min[warp] = kmin;
      warp_off[warp] = off;
    }
    __syncthreads();  // sc (the stage), col_ok, col_id are rewritten by the next tile
    if (tid == 0) {   // cs.thr is read next in the next tile's insertion
      bool any = false;
      float m = INFINITY;
      for (int w = 0; w < kWarps; ++w) {
        any |= warp_off[w] != 0;
        m = fminf(m, warp_min[w]);
      }
      if (any) {
        cs.thr = fmaxf(cs.thr, m);
        cs.ever = 1;
      }
    }
    // warp_min and warp_off are next written after the next tile's barriers
  }
  __syncthreads();
  if (tid == 0) p.offered[(size_t)blockIdx.x * p.n_ranges + blockIdx.y] = cs.ever;
}

template <int KS>
__global__ void __launch_bounds__(kMergeWarps * 32) knn_topk_merge(Params p) {
  __shared__ float warp_min[kMergeWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.x;
  const int nrv = p.nr_valid[0];
  const int m = p.n_ranges * p.k;

  int any = 0;
  const int* flags = p.offered + (size_t)bi * p.sub_r * p.n_ranges;
  for (int e = tid; e < p.sub_r * p.n_ranges; e += kMergeWarps * 32) any |= flags[e];
  any = __syncthreads_or(any);

  float kmin = INFINITY;
  for (int r = warp; r < p.block_r; r += kMergeWarps) {
    const size_t g = (size_t)bi * p.block_r + r;
    float s[KS];
    int id[KS];
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int pos = q * 32 + lane;
      s[q] = pos < p.k ? p.init_s[g * p.k + pos] : -INFINITY;
      id[q] = pos < p.k ? p.init_i[g * p.k + pos] : -1;
    }
    topk::merge_row<KS>(s, id, p.k, p.part_s + g * m, p.part_i + g * m, m, lane);
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int pos = q * 32 + lane;
      if (pos < p.k) {
        p.out_s[g * p.k + pos] = s[q];
        p.out_i[g * p.k + pos] = id[q];
      }
    }
    if ((int)g < nrv) kmin = fminf(kmin, topk::kth<KS>(s, p.k));
  }
  if (lane == 0) warp_min[warp] = kmin;
  __syncthreads();
  if (tid == 0) {
    float mn = warp_min[0];
    for (int w = 1; w < kMergeWarps; ++w) mn = fminf(mn, warp_min[w]);
    p.thr_out[bi] = any ? mn : p.thr_in[0];
  }
}

template <int KS>
cudaError_t launch(const Params& p, int n_rb, cudaStream_t stream) {
  const size_t smem = (size_t)(kScFloats + 2 * kTile + p.a_len) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn_topk_select<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(knn_topk_select<KS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(n_rb * p.sub_r), (unsigned)p.n_ranges);
  knn_topk_select<KS><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_topk_merge<KS><<<n_rb, kMergeWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_topk_launch(const float* r_tiles, const float* s_tiles, const int* active,
                               const int* s_valid, const int* s_ids, const float* init_s,
                               const int* init_i, const float* thr_in, const int* nr_valid,
                               float* part_s, int* part_i, int* offered, float* out_s,
                               int* out_i, float* thr_out, int t1, int n_r, int n_s, int tile,
                               int n_rb, int n_sb, int a_len, int k, int block_r, int block_s,
                               int n_ranges, int range_len, void* stream) {
  if (k < 1 || k > 128 || block_r < 1 || block_r > kMaxRows || block_s < 1 || n_rb < 1 ||
      n_sb < 1 || t1 < 1 || tile < 4 || tile % 4 || a_len < 0 || n_r != n_rb * block_r ||
      n_s != n_sb * block_s || range_len < 1 || n_ranges > 65535 ||
      n_ranges != (n_sb * ((block_s + kTile - 1) / kTile) + range_len - 1) / range_len)
    return (int)cudaErrorInvalidValue;
  const Params p{{r_tiles, s_tiles, n_r, n_s, tile, n_s}, active, s_valid, s_ids, init_s, init_i,
                 thr_in, nr_valid, part_s, part_i, offered, out_s, out_i, thr_out, t1, n_sb,
                 a_len, k, block_r, block_s, (block_r + kTile - 1) / kTile, n_ranges, range_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((k + 31) / 32) {
    case 1: err = launch<1>(p, n_rb, s); break;
    case 2: err = launch<2>(p, n_rb, s); break;
    case 3: err = launch<3>(p, n_rb, s); break;
    default: err = launch<4>(p, n_rb, s); break;
  }
  return (int)err;
}

extern "C" const char* knn_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
