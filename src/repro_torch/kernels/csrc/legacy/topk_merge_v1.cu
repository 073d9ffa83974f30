// The first design of topk_merge's k <= 128 path: one warp per row, its
// state in registers, walking the row's M candidates in column order with
// topk::merge_row (32 columns at a time, one 128-byte load in flight).  On
// no path of the port: chip_smoke.py and the card tests hold the split
// kernel of ../topk_merge.cu to its outputs bit for bit and time it beside
// it, on the same inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "../topk_insert.cuh"

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

// k <= 128 only.
extern "C" int topk_merge_v1_launch(const float* state_s, const int* state_i,
                                    const float* cand_s, const int* cand_i, float* out_s,
                                    int* out_i, int n, int k, int m, int ids_stride,
                                    void* stream) {
  if (n < 1 || k < 1 || k > 128 || m < 0 || ids_stride < 0) return (int)cudaErrorInvalidValue;
  const Params p{state_s, state_i, cand_s, cand_i, out_s, out_i, n, k, m, ids_stride};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((n + kWarps - 1) / kWarps);
  switch ((k + 31) / 32) {
    case 1: topk_merge_kernel<1><<<grid, kThreads, 0, st>>>(p); break;
    case 2: topk_merge_kernel<2><<<grid, kThreads, 0, st>>>(p); break;
    case 3: topk_merge_kernel<3><<<grid, kThreads, 0, st>>>(p); break;
    default: topk_merge_kernel<4><<<grid, kThreads, 0, st>>>(p); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* topk_merge_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
