// Tile-skipping blocked score matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/knn_score/kernel.py::knn_score_pallas (the Pallas
// TPU kernel, body _score_kernel) and computes what it does:
//
//   out[i, j] = sum over the active list of the pair (i / block_r,
//               j / block_s) of dot(r_tiles[t, i], s_tiles[t, j])
//
// Lists are ascending and padded with the sentinel tile T = t1 - 1, which
// is all zeros, so the walk stops at the first entry outside [0, T) and
// the result is unchanged.  s_tiles may be a window of n_s columns of a
// larger (T+1, s_ld, tile) stack: consecutive tiles lie s_ld rows apart.
//
// Design: one CTA per 128 x 128 tile of one block pair (clipped at the
// pair's edge, so one active list serves it): 16 x 80 = 1,280 CTAs at the
// engine's shapes (NR 2048, NS 10,240, blocks of 256).  The CTA reads its
// pair's list into shared memory once, runs the shared mainloop of
// score_tile.cuh (8 x 8 register micro-tile a thread, k-major staged
// slices, the next slice's global loads in flight during the FMAs) and
// writes its tile once.
//
// Sums are taken tile by tile in list (ascending) order and dim by dim
// within a tile, one fmaf chain per output, as the first design of this
// kernel did: the outputs are bit for bit that design's.  The plain version
// (knn_score/ref.py) sums each tile product in cuBLAS's order and then over
// tiles, so the two agree within rtol=1e-5, atol=1e-6, not bit for bit.
//
// Bound: operations.  2 * 256 * 256 * 128 flop for every active (R block,
// S block, tile) triple; 25,280 triples at the engine's shapes give
// 4.24e11 flop, 6.33 ms at the H100 SXM's 67 TFLOP/s fp32.  Bytes (the
// tile stacks read once, the scores written once) are ~0.59 GB, 0.18 ms.

#include <cuda_runtime.h>
#include <stddef.h>

#include "score_tile.cuh"

namespace {

using score_tile::kThreads;
using score_tile::kTile;

struct Params {
  score_tile::Operands op;
  const int* active;  // (nR, nS, A)
  float* out;         // (NR, NS)
  int t1, n_sb, a_len, block_r, block_s, sub_r, sub_s;
};

__global__ void __launch_bounds__(kThreads, 2) knn_score_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                                                 // the mainloop's
  int* alist = reinterpret_cast<int*>(smem + score_tile::kStageBytes / 4);  // a_len entries

  const int tid = threadIdx.x;
  const int ctas_s = p.n_sb * p.sub_s;
  const int cta_r = blockIdx.x / ctas_s, cta_s = blockIdx.x % ctas_s;
  const int bi = cta_r / p.sub_r, bj = cta_s / p.sub_s;
  const int r_lo = (cta_r % p.sub_r) * kTile, c_lo = (cta_s % p.sub_s) * kTile;
  const int nrow = min(kTile, p.block_r - r_lo);
  const int ncol = min(kTile, p.block_s - c_lo);
  const int row0 = bi * p.block_r + r_lo;
  const int col0 = bj * p.block_s + c_lo;

  const int* act = p.active + ((size_t)bi * p.n_sb + bj) * p.a_len;
  for (int e = tid; e < p.a_len; e += kThreads) alist[e] = act[e];
  __syncthreads();
  const int a_live = score_tile::live_tiles(alist, p.a_len, p.t1 - 1);

  float acc[8][8];
  score_tile::accumulate(acc, stage, alist, a_live, p.op, row0, nrow, col0, ncol);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = score_tile::tile_row(i, tid);
    if (r >= nrow) continue;
    float* o = p.out + (size_t)(row0 + r) * p.op.n_s + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = score_tile::tile_col(j, tid);
      if (c < ncol) o[c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int knn_score_launch(const float* r_tiles, const float* s_tiles, const int* active,
                                float* out, int t1, int n_r, int n_s, int s_ld, int tile,
                                int n_rb, int n_sb, int a_len, int block_r, int block_s,
                                void* stream) {
  if (t1 < 1 || tile < 4 || tile % 4 || n_rb < 1 || n_sb < 1 || a_len < 0 || block_r < 1 ||
      block_s < 1 || n_r != n_rb * block_r || n_s != n_sb * block_s || s_ld < n_s)
    return (int)cudaErrorInvalidValue;
  const int sub_r = (block_r + kTile - 1) / kTile, sub_s = (block_s + kTile - 1) / kTile;
  const long long ctas = (long long)n_rb * sub_r * n_sb * sub_s;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = score_tile::kStageBytes + (size_t)a_len * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(knn_score_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(knn_score_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const Params p{{r_tiles, s_tiles, n_r, n_s, tile, s_ld}, active, out, t1, n_sb, a_len,
                 block_r, block_s, sub_r, sub_s};
  knn_score_kernel<<<(unsigned)ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* knn_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
