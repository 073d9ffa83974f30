// The first CUDA design of knn_topk (sequential, before the shared tile
// mainloop of ../score_tile.cuh), kept only to show that the present
// ../knn_topk.cu gives bit for bit its outputs: chip_smoke.py builds it
// and compares once at the engine's shapes.  On no path of the port.
//
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
// Where the TPU design does not carry over:
//   * The Pallas (block_r, block_s) f32 accumulator is 256 KB at the
//     defaults, beyond a CTA's 227 KB of shared memory.  Each S block is cut
//     into chunks of kChunk = 64 columns; a chunk's scores are accumulated
//     over the whole active list in registers (a 16 x 4 tile a thread),
//     staged in shared memory, masked with the block's frozen thr and
//     inserted in column order.  A masked candidate never moves a state, so
//     chunking gives the same result as one pass over the block.
//   * The (block_r, k) state (256 KB at k = 128) lives in the output buffers
//     in device memory (L2-resident).  A warp owns one row at a time during
//     insertion and holds its state in registers, k/32 slots a lane: pos
//     by __ballot_sync + __popc, the shift by __shfl_up_sync (the body is
//     topk_insert.cuh, shared with topk_merge.cu).
//   * The TPU grid is sequential; here one CTA per R-row group walks the S
//     blocks in a loop and nothing carries between CTAs.  The threshold is
//     a CTA-wide min through shared memory, so a CTA owns exactly one
//     block_r group.
//
// Bound: operations, 2 * block_r * block_s * tile flop for every active
// (R block, S block, tile) triple: 4.24e11 flop for one 2048-row R block
// against synthetic-10k's S, 6.33 ms at 67 TFLOP/s fp32.  One CTA per
// 256-row group fills 8 of 132 SMs: ~465 ms on an H100.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../topk_insert.cuh"

namespace {

constexpr int kThreads = 256;            // 8 warps, a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 256;            // largest block_r
constexpr int kChunk = 64;               // S columns scored per pass
constexpr int kDepth = 32;               // dims staged per shared-memory step
constexpr int kPad = kDepth + 1;         // row pitch of the staged tiles
constexpr int kScPad = kChunk + 1;       // row pitch of the staged scores
constexpr int kRowsPerThread = kMaxRows / 16;
constexpr int kColsPerThread = kChunk / 16;

struct Params {
  const float* r_tiles;  // (T+1, NR, tile)
  const float* s_tiles;  // (T+1, NS, tile)
  const int* active;     // (nR, nS, A)
  const int* s_valid;    // (NS,)
  const int* s_ids;      // (NS,)
  const float* init_s;   // (NR, k)
  const int* init_i;     // (NR, k)
  const float* thr_in;   // (1,)
  const int* nr_valid;   // (1,)
  float* out_s;          // (NR, k)
  int* out_i;            // (NR, k)
  float* thr_out;        // (nR,)
  int t1, n_r, n_s, tile, n_sb, a_len, k, block_r, block_s;
};

// Insert one row's offered chunk columns into its k-state, in column order.
// Called by a whole warp; every branch is warp-uniform.  Returns whether
// any candidate of the row was offered.
template <int KS>
__device__ bool insert_row(float* row_s, int* row_i, int k, const float* sc_row,
                           const int* col_ok, const int* col_id, int ncol, float thr,
                           int lane) {
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
  for (int c = 0; c < ncol; ++c) {
    const float v = sc_row[c];
    if (!(v > 0.f && col_ok[c] != 0 && v > thr)) continue;
    offered = true;
    if (!(v > kth)) continue;  // pos would be k: the state stays as it is
    changed = true;
    topk::insert<KS>(s, id, k, v, col_id[c], lane);
    kth = topk::kth<KS>(s, k);
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
  return offered;
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 1) knn_topk_kernel(Params p) {
  extern __shared__ float smem[];
  float* rs = smem;                      // [kMaxRows][kPad]  R tile slice
  float* ss = rs + kMaxRows * kPad;      // [kChunk][kPad]    S tile slice
  float* sc = ss + kChunk * kPad;        // [kMaxRows][kScPad] chunk scores
  __shared__ int col_ok[kChunk];
  __shared__ int col_id[kChunk];
  __shared__ float warp_min[kWarps];
  __shared__ int any_offered;
  __shared__ float thr_live;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int row0 = blockIdx.x * p.block_r;
  const int sentinel = p.t1 - 1;
  const int nrv = p.nr_valid[0];

  for (int e = tid; e < p.block_r * p.k; e += kThreads) {
    const size_t g = (size_t)row0 * p.k + e;
    p.out_s[g] = p.init_s[g];
    p.out_i[g] = p.init_i[g];
  }
  if (tid == 0) {
    thr_live = p.thr_in[0];
    any_offered = 0;
  }
  __syncthreads();

  for (int j = 0; j < p.n_sb; ++j) {
    const int col0 = j * p.block_s;
    const int* act = p.active + ((size_t)blockIdx.x * p.n_sb + j) * p.a_len;
    const float thr = thr_live;  // frozen for the whole S block
    for (int c0 = 0; c0 < p.block_s; c0 += kChunk) {
      const int ncol = min(kChunk, p.block_s - c0);
      float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
        for (int b = 0; b < kColsPerThread; ++b) acc[a][b] = 0.f;

      for (int a = 0; a < p.a_len; ++a) {
        const int t = act[a];
        if (t >= sentinel) break;
        const float* rt = p.r_tiles + ((size_t)t * p.n_r + row0) * p.tile;
        const float* st = p.s_tiles + ((size_t)t * p.n_s + col0 + c0) * p.tile;
        for (int d0 = 0; d0 < p.tile; d0 += kDepth) {
          for (int e = tid; e < kMaxRows * kDepth; e += kThreads) {
            const int r = e / kDepth, d = e % kDepth;
            rs[r * kPad + d] =
                (r < p.block_r && d0 + d < p.tile) ? rt[(size_t)r * p.tile + d0 + d] : 0.f;
          }
          for (int e = tid; e < kChunk * kDepth; e += kThreads) {
            const int c = e / kDepth, d = e % kDepth;
            ss[c * kPad + d] =
                (c < ncol && d0 + d < p.tile) ? st[(size_t)c * p.tile + d0 + d] : 0.f;
          }
          __syncthreads();
#pragma unroll 4
          for (int d = 0; d < kDepth; ++d) {
            float b[kColsPerThread];
#pragma unroll
            for (int jj = 0; jj < kColsPerThread; ++jj) b[jj] = ss[(tx + 16 * jj) * kPad + d];
#pragma unroll
            for (int ii = 0; ii < kRowsPerThread; ++ii) {
              const float av = rs[(ty + 16 * ii) * kPad + d];
#pragma unroll
              for (int jj = 0; jj < kColsPerThread; ++jj)
                acc[ii][jj] = fmaf(av, b[jj], acc[ii][jj]);
            }
          }
          __syncthreads();
        }
      }

#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
        for (int jj = 0; jj < kColsPerThread; ++jj)
          sc[(ty + 16 * ii) * kScPad + tx + 16 * jj] = acc[ii][jj];
      if (tid < kChunk) {
        const bool in = tid < ncol;
        col_ok[tid] = in ? p.s_valid[col0 + c0 + tid] : 0;
        col_id[tid] = in ? p.s_ids[col0 + c0 + tid] : -1;
      }
      __syncthreads();

      bool offered = false;
      for (int r = warp; r < p.block_r; r += kWarps) {
        const size_t g = (size_t)(row0 + r) * p.k;
        offered |= insert_row<KS>(p.out_s + g, p.out_i + g, p.k, sc + r * kScPad, col_ok,
                                  col_id, ncol, thr, lane);
      }
      if (offered && lane == 0) any_offered = 1;
      __syncthreads();
    }

    if (any_offered) {  // uniform: read after the chunk's last barrier
      float v = INFINITY;
      if (tid < p.block_r && row0 + tid < nrv)
        v = p.out_s[(size_t)(row0 + tid) * p.k + p.k - 1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = fminf(v, __shfl_xor_sync(topk::kFullMask, v, off));
      if (lane == 0) warp_min[warp] = v;
      __syncthreads();
      if (tid == 0) {
        float m = warp_min[0];
        for (int w = 1; w < kWarps; ++w) m = fminf(m, warp_min[w]);
        thr_live = m;
        any_offered = 0;
      }
    }
    __syncthreads();
  }
  if (tid == 0) p.thr_out[blockIdx.x] = thr_live;
}

template <int KS>
cudaError_t launch(const Params& p, int n_rb, cudaStream_t stream) {
  const size_t smem = (size_t)(kMaxRows * kPad + kChunk * kPad + kMaxRows * kScPad) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn_topk_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  knn_topk_kernel<KS><<<n_rb, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_topk_v1_launch(const float* r_tiles, const float* s_tiles, const int* active,
                               const int* s_valid, const int* s_ids, const float* init_s,
                               const int* init_i, const float* thr_in, const int* nr_valid,
                               float* out_s, int* out_i, float* thr_out, int t1, int n_r,
                               int n_s, int tile, int n_rb, int n_sb, int a_len, int k,
                               int block_r, int block_s, void* stream) {
  if (k < 1 || k > 128 || block_r < 1 || block_r > kMaxRows || block_s < 1 || n_rb < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{r_tiles, s_tiles, active, s_valid, s_ids, init_s, init_i, thr_in, nr_valid,
                 out_s, out_i, thr_out, t1, n_r, n_s, tile, n_sb, a_len, k, block_r, block_s};
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

extern "C" const char* knn_topk_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
