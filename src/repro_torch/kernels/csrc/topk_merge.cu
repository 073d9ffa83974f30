// Streaming top-k merge for Hopper (sm_90a).
//
// Replaces repro/kernels/topk_merge/kernel.py::topk_merge_pallas (the
// Pallas TPU kernel, body _merge_kernel around insert_candidates) and
// computes what it does, bit for bit: M insertion passes of a row's
// candidates, in column order, into its (k <= 128) descending state;
// pos = #{state >= cand}, so incumbents win ties and a candidate that is
// <= the k-th score (-inf ones included) changes nothing.  Empty slots are
// (-inf, -1).  Scores are finite or -inf; a NaN candidate is outside the
// contract.
//
// Design: one warp per row, its state in registers (k/32 slots a lane,
// topk_insert.cuh, shared with knn_topk.cu).  The warp walks the row's
// candidates with topk::merge_row: 32 columns at a time, one column a
// lane, the next chunk's load in flight; only the columns that beat the
// chunk-start k-th (a __ballot_sync) are inserted, in column order.
// Ragged N and M need no padding: rows past N have no warp, and columns
// past M read as -inf.
//
// Bound: bytes.  The candidate scores are read once (N * M * 4 B, 84 MB at
// N = 2048, M = 10,240), plus the ids of the passing columns and the
// state in and out: 0.03 ms at 3.35 TB/s.  A row's walk is serial, so
// with one warp per row the card holds N warps (2,048 at the engine's
// shapes, 16 a SM) and latency, not bandwidth, is what it meets first.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "topk_insert.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Params {
  const float* state_s;  // (N, k)
  const int* state_i;    // (N, k)
  const float* cand_s;   // (N, M)
  const int* cand_i;     // (N, M), or (M,) shared by every row: ids_stride 0
  float* out_s;          // (N, k)
  int* out_i;            // (N, k)
  int n, k, m, ids_stride;
};

template <int KS>
__global__ void __launch_bounds__(kThreads) topk_merge_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.n) return;  // a whole warp

  float s[KS];
  int id[KS];
#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int pos = q * 32 + lane;
    s[q] = pos < p.k ? p.state_s[(size_t)row * p.k + pos] : -INFINITY;
    id[q] = pos < p.k ? p.state_i[(size_t)row * p.k + pos] : -1;
  }
  topk::merge_row<KS>(s, id, p.k, p.cand_s + (size_t)row * p.m,
                      p.cand_i + (size_t)row * p.ids_stride, p.m, lane);

#pragma unroll
  for (int q = 0; q < KS; ++q) {
    const int pos = q * 32 + lane;
    if (pos < p.k) {
      p.out_s[(size_t)row * p.k + pos] = s[q];
      p.out_i[(size_t)row * p.k + pos] = id[q];
    }
  }
}

}  // namespace

extern "C" int topk_merge_launch(const float* state_s, const int* state_i, const float* cand_s,
                                 const int* cand_i, float* out_s, int* out_i, int n, int k,
                                 int m, int ids_stride, void* stream) {
  if (n < 1 || k < 1 || k > 128 || m < 0 || ids_stride < 0) return (int)cudaErrorInvalidValue;
  const Params p{state_s, state_i, cand_s, cand_i, out_s, out_i, n, k, m, ids_stride};
  const unsigned grid = (unsigned)((n + kWarps - 1) / kWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: topk_merge_kernel<1><<<grid, kThreads, 0, st>>>(p); break;
    case 2: topk_merge_kernel<2><<<grid, kThreads, 0, st>>>(p); break;
    case 3: topk_merge_kernel<3><<<grid, kThreads, 0, st>>>(p); break;
    default: topk_merge_kernel<4><<<grid, kThreads, 0, st>>>(p); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* topk_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
